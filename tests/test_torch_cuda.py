"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here carries the `cuda` marker and skips without a GPU.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, skip tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as tfa


def _need_card():
    # decided inside the test, never at import: xdist workers must collect
    # the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _pad_rows(l):
    """A pad mask [5, L] (True = padded): rows of real length L, L/2, 1 and
    0 (all pad), and a row padded over [L/4, 3L/4) only, so a key tile of
    padded keys can lie between real ones."""
    pad = torch.arange(l, device="cuda")[None, :] >= torch.tensor(
        [l, l // 2, 1, 0, l], device="cuda")[:, None]
    pad[4, l // 4:3 * l // 4] = True
    return pad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,dh,masked,rate,tol", [
    ("bfloat16", 384, 64, True, 0.0, 2e-2),
    ("bfloat16", 197, 64, False, 0.0, 2e-2),
    ("bfloat16", 384, 64, True, 0.1, 2e-2),
    ("bfloat16", 256, 128, True, 0.0, 2e-2),
    ("float32", 197, 64, True, 0.0, 1e-4),
    ("float32", 130, 128, False, 0.0, 1e-4),
    # the bf16 kernel's tile edges: a last key tile of 1, 5 (the ViT's
    # L = 197), 16 and 17 keys below L; L = 130 leaves the second block one
    # q tile of two; 512 and 640 (packed dropout needs L % 128 == 0); dh
    # 128 with dropout and at L = 197
    ("bfloat16", 65, 64, True, 0.0, 2e-2),
    ("bfloat16", 197, 64, True, 0.0, 2e-2),
    ("bfloat16", 80, 64, False, 0.0, 2e-2),
    ("bfloat16", 81, 64, True, 0.0, 2e-2),
    ("bfloat16", 130, 64, True, 0.0, 2e-2),
    ("bfloat16", 512, 64, True, 0.1, 2e-2),
    ("bfloat16", 640, 64, True, 0.0, 2e-2),
    ("bfloat16", 256, 128, True, 0.1, 2e-2),
    ("bfloat16", 197, 128, True, 0.0, 2e-2),
])
def test_packed_kernel_matches_plain_version(dtype, l, dh, masked, rate, tol):
    """flash_attention_packed's Hopper kernel against its plain version run
    in fp32 on the same inputs: bf16 output within 2e-2 (bf16 rounding of
    p and of the output), fp32 within 1e-4 (summation order, expf).  Masked:
    the rows of `_pad_rows`."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, heads = 5, 768 // dh
    hb = tfa._head_group(dh, heads, 6)
    qkv = torch.randn(b, l, 3 * heads * dh, generator=gen,
                      device="cuda").to(getattr(torch, dtype))
    pad = _pad_rows(l) if masked else None
    seed = 99 if rate else None
    before = tfa.flash_attention_packed.launches
    out = tfa.flash_attention_packed(qkv, pad, seed, heads, hb, rate)
    torch.cuda.synchronize()
    assert tfa.flash_attention_packed.launches == before + 1
    ref = tfa.flash_attention_packed_reference(qkv.float(), pad, seed, heads,
                                               hb, rate)
    assert out.dtype == qkv.dtype and out.shape == ref.shape
    err = (out.float() - ref).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_packed_kernel_dropout_mask_is_the_jax_stream(dtype):
    """With q = k = 0 every key weighs 1/L, and with v[key j] = e_j the
    output reads back the keep mask itself: out[b, q, h*dh + j] =
    keep[b, h, q, j] / (L (1 - rate)).  It must equal
    dropout_keep_mask_reference (bit-identical to JAX's interpret-mode
    stream) at every position."""
    _need_card()
    b, l, dh, heads, rate, seed = 2, 128, 128, 6, 0.3, 12345
    d = heads * dh
    q = torch.zeros(b, l, d, device="cuda")
    v = torch.eye(l, dh, device="cuda").repeat(b, 1, heads)  # v[., j, h*dh+j]
    qkv = tfa.pack_qkv_weights(q, q, v, heads, heads).to(getattr(torch, dtype))
    out = tfa.flash_attention_packed(qkv.contiguous(), None, seed, heads,
                                     heads, rate)
    got = out.float().reshape(b, l, heads, dh).permute(0, 2, 1, 3)
    got = got * (l * (1.0 - rate)) > 0.5
    want = tfa.dropout_keep_mask_reference(seed, b, heads, l, l, rate,
                                          device="cuda")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_packed_kernel_refuses_what_it_does_not_take():
    """A CUDA tensor reaches the kernel or an exception, never a fallback."""
    _need_card()
    qkv = torch.zeros(2, 128, 3 * 768, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa.flash_attention_packed(qkv.half(), None, None, 12, 6)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_packed(qkv.transpose(0, 1), None, None, 12, 6)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_packed(qkv, None, None, 24, 6)
    with pytest.raises(ValueError, match="pad_mask on"):
        tfa.flash_attention_packed(qkv, torch.zeros(2, 128, dtype=torch.bool),
                                   None, 12, 6)


SPLIT_CASES = [(dt, l, 64, masked, rate)
               for dt in ("bfloat16", "float32") for l in (128, 384)
               for masked in (True, False) for rate in (0.0, 0.1)]
SPLIT_CASES += [("bfloat16", 256, 128, True, 0.1),
                ("float32", 256, 128, True, 0.1)]
# the edges of the backward's 64-row tiles: L = 65 (two tiles, the second
# of one key), L = 512 (eight, the longest L the text encoders take with
# dropout) and L = 640 (ten, at rate 0)
SPLIT_CASES += [("bfloat16", l, dh, masked, rate)
                for l, dh, masked, rate in (
                    (65, 64, True, 0.1), (65, 64, False, 0.0),
                    (512, 64, True, 0.1), (512, 64, False, 0.0),
                    (512, 128, True, 0.1), (640, 64, True, 0.0))]
# the forward's: a last key tile of 5 (with dropout), 16 and 17 keys
# below L, an odd count of q tiles (the second block's second q tile lies
# past L), and dh 128 with a last key tile of 8
SPLIT_CASES += [("bfloat16", l, dh, masked, rate)
                for l, dh, masked, rate in (
                    (197, 64, True, 0.1), (80, 64, False, 0.0),
                    (81, 64, True, 0.1), (130, 64, True, 0.1),
                    (200, 128, True, 0.0))]
# bf16: output against the fp32 plain version within 2e-2 (bf16 rounding
# of p and of the output); gradients against the plain backward run on the
# same bf16 inputs within 3e-2 of the largest reference gradient.  Both
# take delta as the fp32 rowsum(dp*p) and cast ds and p*keep to bf16 before
# the products, from fp32 values that differ in their last bits (exp2f,
# summation order), so a value near a bf16 rounding boundary may round the
# other way.  On an H100 the gap is 0.0016-0.0017 of the largest gradient
# at the main path's shape (PERF.md).  fp32: 1e-4 and 1e-4 relative
# (summation order, exp2f).
SPLIT_TOL = {"bfloat16": (2e-2, 3e-2), "float32": (1e-4, 1e-4)}


def _split_inputs(dtype, b, l, dh, masked, gen):
    heads = 768 // dh
    q, k, v, g = (torch.randn(b, l, heads * dh, generator=gen, device="cuda")
                  .to(getattr(torch, dtype)) for _ in range(4))
    return heads, q, k, v, g, _pad_rows(l) if masked else None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,dh,masked,rate", SPLIT_CASES)
def test_split_kernels_match_plain_versions(dtype, l, dh, masked, rate):
    """flash_attention's forward and backward kernels against
    flash_attention_reference / flash_attention_bwd_reference on the same
    inputs; masked: the rows of `_pad_rows`."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    heads, q, k, v, g, pad = _split_inputs(dtype, 5, l, dh, masked, gen)
    seed = 4321 if rate else None
    fwd_tol, grad_tol = SPLIT_TOL[dtype]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    out = tfa.flash_attention(*leaves, pad, seed, heads, rate)
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = tfa.flash_attention_reference(q.float(), k.float(), v.float(), pad,
                                        seed, heads, rate)
    assert out.dtype == q.dtype
    assert (out.float() - ref).abs().max().item() <= fwd_tol
    want = tfa.flash_attention_bwd_reference(q, k, v, pad, seed, g, heads,
                                             rate)
    for leaf, w, name in zip(leaves, want, "qkv"):
        assert leaf.grad.dtype == q.dtype
        err = (leaf.grad.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        assert err <= grad_tol * top, (name, err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_kernels_dropout_mask_is_the_jax_stream(dtype):
    """With q = k = 0 every key weighs 1/L.  Forward: v[key j] = e_j reads
    the keep mask out as out[b, q, h*dh + j] = keep[b, h, q, j] / (L (1-r)).
    Backward: dO[q] = e_q reads it out of dv as
    dv[b, key, h*dh + q] = keep[b, h, q, key] / (L (1-r)).  Both must equal
    dropout_keep_mask_reference (bit-identical to JAX's interpret-mode
    stream)."""
    _need_card()
    b, l, dh, heads, rate, seed = 2, 128, 128, 6, 0.3, 2024
    dt = getattr(torch, dtype)
    z = torch.zeros(b, l, heads * dh, device="cuda", dtype=dt)
    eye = torch.eye(l, dh, device="cuda").repeat(b, 1, heads).to(dt)
    want = tfa.dropout_keep_mask_reference(seed, b, heads, l, l, rate,
                                          device="cuda")
    vv = eye.clone().requires_grad_()
    out = tfa.flash_attention(z, z, vv, None, seed, heads, rate)
    got = out.float().reshape(b, l, heads, dh).permute(0, 2, 1, 3)
    assert torch.equal(got * (l * (1.0 - rate)) > 0.5, want)
    out.backward(eye)
    dv = vv.grad.float().reshape(b, l, heads, dh).permute(0, 2, 3, 1)
    assert torch.equal(dv * (l * (1.0 - rate)) > 0.5, want)


@pytest.mark.cuda
def test_split_kernels_refuse_what_they_do_not_take():
    _need_card()
    q = torch.zeros(2, 128, 768, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa.flash_attention(q.half(), q.half(), q.half(), None, None, 12)
    with pytest.raises(ValueError, match="share device and dtype"):
        tfa.flash_attention(q, q.float(), q, None, None, 12)
    t = q.transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(t, t, t, None, None, 12)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q, None, None, 24)
    with pytest.raises(ValueError, match="pad_mask on"):
        tfa.flash_attention(q, q, q, torch.zeros(2, 128, dtype=torch.bool),
                            None, 12)
    with pytest.raises(ValueError, match="needs the forward kernel"):
        tfa.flash_attention_bwd(q, q, q, None, None, q, 12)
    with pytest.raises(TypeError, match="backward kernel takes bfloat16"):
        tfa.flash_attention_packed(
            torch.zeros(2, 128, 3 * 768, device="cuda", requires_grad=True),
            None, None, 12, 6)


@pytest.mark.cuda
def test_hash_dropout_mask_on_the_card_equals_the_cpu():
    """The int32 hash wraps on the card as on the CPU (where
    tests/test_torch_train.py holds it to JAX bit for bit)."""
    _need_card()
    from mmoe_multimodal_rec_tpu_torch.models import layers
    for shape, rate, seed in (((64, 384, 768), 0.1, 987654321),
                              ((3, 7), 0.5, 0)):
        gpu = layers.hash_keep_mask(shape, seed, rate, "cuda").cpu()
        assert torch.equal(gpu, layers.hash_keep_mask(shape, seed, rate,
                                                      "cpu"))


@pytest.mark.cuda
def test_fused_lora_dense_launches_the_kernels():
    """lora_fused_dropout=true on the card: a training forward and backward
    of LoRADense launches the forward, dA and dh kernels once each and
    agrees with the same layer on the CPU (fp32, plain versions); the
    serving forward (no dropout) launches none."""
    _need_card()
    from mmoe_multimodal_rec_tpu_torch.models import layers
    outs = []
    for device in ("cuda", "cpu"):
        lora = layers.LoRADense(128, 128, 8, 32.0, dropout=0.1,
                                fused_dropout=True)
        layers.init_weights(lora, torch.Generator().manual_seed(0))
        with torch.no_grad():
            lora.lora_b.normal_(0, 0.1, generator=torch.Generator()
                                .manual_seed(1))
        lora.to(device)
        x = torch.randn(4, 96, 128, generator=torch.Generator()
                        .manual_seed(2)).to(device).requires_grad_()
        before = _lora_launches()
        lora(x.detach())
        assert _lora_launches() == before
        y = lora(x, deterministic=False, rng=torch.Generator().manual_seed(3))
        y.square().sum().backward()
        want = (1, 1, 1) if device == "cuda" else (0, 0, 0)
        assert tuple(n - b for n, b in zip(_lora_launches(), before)) == want
        outs.append([t.detach().cpu() for t in (y, x.grad, lora.lora_a.grad,
                                                lora.lora_b.grad)])
    for got, want in zip(*outs):
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err


def _lora_launches():
    from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as tld
    return (tld.lora_dropout_fwd.launches, tld.lora_dropout_da.launches,
            tld.lora_dropout_dh.launches)


# (M, D, r): the main path's D and r with a ragged M, a small one, and an r
# that spans three tiles with a ragged last one (the scalar load path)
LORA_SHAPES = [(4099, 768, 8), (512, 128, 4), (300, 256, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,d,r", LORA_SHAPES)
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_lora_dropout_kernels_match_plain_versions(dtype, m, d, r, rate):
    """Kernels #4-#6 against their plain versions on the same inputs: fp32
    within 1e-5 of the largest value (summation order), bf16 within one
    bf16 unit in the last place of it, 2**-7 (both round an fp32 sum
    taken in another order to bf16)."""
    _need_card()
    from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as tld
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt_ = getattr(torch, dtype)
    h = torch.randn(m, d, generator=gen, device="cuda").to(dt_)
    a = (0.1 * torch.randn(d, r, generator=gen, device="cuda")).to(dt_)
    g = torch.randn(m, r, generator=gen, device="cuda").to(dt_)
    seed = 2 ** 31 - 7
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    before = _lora_launches()
    got = (tld.lora_dropout_fwd(h, a, seed, rate),
           tld.lora_dropout_da(h, g, seed, rate),
           tld.lora_dropout_dh(g, a, seed, rate))
    torch.cuda.synchronize()
    assert tuple(n - b for n, b in zip(_lora_launches(), before)) == (1, 1, 1)
    want = (tld.lora_dropout_fwd_reference(h, a, seed, rate),
            tld.lora_dropout_da_reference(h, g, seed, rate),
            tld.lora_dropout_dh_reference(g, a, seed, rate))
    for name, x, w in zip(("t", "dA", "dh"), got, want):
        assert x.dtype == w.dtype and x.shape == w.shape, name
        err = (x.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lora_dropout_mask_is_the_hash_dropout_stream(dtype):
    """With dt @ A^T = 1, dh = keep / (1 - rate): kernel #6 reads the mask
    back, and it must equal hash_keep_mask (bit-identical to JAX's) at every
    position; kernel #4 with A = e_0 gives t[:, 0] = keep[:, 0] h / (1-r)."""
    _need_card()
    from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as tld
    m, d, r, rate, seed = 1000, 256, 8, 0.3, 12345
    dt_ = getattr(torch, dtype)
    want = tld.hash_keep_mask((m, d), seed, rate, "cuda")
    dh = tld.lora_dropout_dh(torch.ones(m, r, device="cuda", dtype=dt_),
                             torch.full((d, r), 1.0 / r, device="cuda",
                                        dtype=dt_), seed, rate)
    assert torch.equal(dh.float() * (1.0 - rate) > 0.5, want)
    a = torch.zeros(d, r, device="cuda", dtype=dt_)
    a[0, 0] = 1.0
    t = tld.lora_dropout_fwd(torch.ones(m, d, device="cuda", dtype=dt_), a,
                             seed, rate)
    assert torch.equal(t[:, 0].float() > 0.5, want[:, 0])


@pytest.mark.cuda
def test_lora_dropout_kernels_refuse_what_they_do_not_take():
    _need_card()
    from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as tld
    h = torch.zeros(64, 128, device="cuda", dtype=torch.bfloat16)
    a = torch.zeros(128, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tld.lora_dropout_fwd(h.half(), a.half(), 1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tld.lora_dropout_fwd(h.t().contiguous().t(), a, 1, 0.1)
    with pytest.raises(ValueError, match="share a dtype"):
        tld.lora_dropout_dh(torch.zeros(64, 8, device="cuda"), a, 1, 0.1)
    with pytest.raises(ValueError, match="operands on"):
        tld.lora_dropout_fwd(h, a.cpu(), 1, 0.1)


# (L, dh, masked, rate): HoME's ViT (L = 197, no mask, rate 0), the text
# shape masked at rate 0.1, L = 128 masked at rate 0, dh 128, and the tile
# edges L = 65, 512 and 640 (packed dropout needs L % 128 == 0)
PACKED_BWD_CASES = [(197, 64, False, 0.0), (384, 64, True, 0.1),
                    (128, 64, True, 0.0), (256, 128, True, 0.1),
                    (65, 64, True, 0.0), (512, 64, False, 0.1),
                    (640, 64, True, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("l,dh,masked,rate", PACKED_BWD_CASES)
def test_packed_backward_matches_plain_version(l, dh, masked, rate):
    """flash_attention_packed on a bf16 qkv that needs a gradient: the
    forward takes the instantiation that stores the softmax statistics and
    gives the same output, bit for bit, as the serving instantiation; the
    backward kernel (#7) gives dqkv within 3e-2 of the largest reference
    gradient of the plain backward on the same bf16 inputs (SPLIT_TOL's
    reasons)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, heads = 4, 768 // dh
    hb = tfa._head_group(dh, heads, 6)
    qkv = torch.randn(b, l, 3 * heads * dh, generator=gen,
                      device="cuda").bfloat16()
    g = torch.randn(b, l, heads * dh, generator=gen, device="cuda").bfloat16()
    pad = None
    if masked:
        lens = torch.tensor([l, l // 2, 1, 0], device="cuda")
        pad = torch.arange(l, device="cuda")[None, :] >= lens[:, None]
    seed = 77 if rate else None
    before = (tfa.flash_attention_packed.launches,
              tfa.flash_attention_packed.stats_launches,
              tfa.flash_attention_packed_bwd.launches)
    serving = tfa.flash_attention_packed(qkv, pad, seed, heads, hb, rate)
    leaf = qkv.clone().requires_grad_()
    out = tfa.flash_attention_packed(leaf, pad, seed, heads, hb, rate)
    out.backward(g)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_packed.launches,
            tfa.flash_attention_packed.stats_launches,
            tfa.flash_attention_packed_bwd.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    assert torch.equal(out, serving)
    want = tfa.flash_attention_packed_bwd_reference(qkv, pad, seed, g, heads,
                                                    hb, rate)
    assert leaf.grad.dtype == qkv.dtype and leaf.grad.shape == qkv.shape
    err = (leaf.grad.float() - want.float()).abs().max().item()
    assert err <= SPLIT_TOL["bfloat16"][1] * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("direction,layout,l,rate", [
    ("backward", "split", 384, 0.1), ("backward", "split", 640, 0.0),
    ("backward", "packed", 197, 0.0), ("forward", "split", 384, 0.1),
    ("forward", "packed", 197, 0.0), ("forward", "packed", 384, 0.1)])
def test_kernels_are_bitwise_deterministic(direction, layout, l, rate):
    """Two calls on the same inputs give the same results bit for bit.
    Backward: every sum, dQ's over the key tiles and delta's too, is taken
    in a fixed order, with no atomics.  Forward: the output and the
    statistics (m, l), each row's sums in key order."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    heads, dh, hb, b = 12, 64, 6, 8
    d = heads * dh
    g = torch.randn(b, l, d, generator=gen, device="cuda").bfloat16()
    seed = 5150 if rate else None
    lens = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
    pad = torch.arange(l, device="cuda")[None, :] >= lens[:, None]
    if layout == "split":
        q, k, v = (torch.randn(b, l, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        _, stats = tfa._flash_fwd_cuda(q, k, v, pad, seed, heads, rate, True)
        if direction == "forward":
            run = lambda: tfa._flash_fwd_cuda(q, k, v, pad, seed, heads,
                                              rate, True)
        else:
            run = lambda: tfa.flash_attention_bwd(q, k, v, pad, seed, g,
                                                  heads, rate, stats)
    else:
        qkv = torch.randn(b, l, 3 * d, generator=gen,
                          device="cuda").bfloat16()
        pad = pad if rate else None
        _, stats = tfa._packed_fwd_cuda(qkv, pad, seed, heads, hb, rate,
                                        True)
        if direction == "forward":
            # the serving instantiation and the one that stores (m, l)
            run = lambda: (tfa._packed_fwd_cuda(qkv, pad, seed, heads, hb,
                                                rate, False)[0],
                           *tfa._packed_fwd_cuda(qkv, pad, seed, heads, hb,
                                                 rate, True))
        else:
            run = lambda: (tfa.flash_attention_packed_bwd(
                qkv, pad, seed, g, heads, hb, rate, stats),)
    first = run()
    second = run()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_packed_backward_dropout_mask_is_the_jax_stream():
    """With q = k = 0 every key weighs 1/L, and with dO[q] = e_q the v
    columns of dqkv read back the keep mask: dv[b, key, h*dh + q] =
    keep[b, h, q, key] / (L (1-r)), equal to
    dropout_keep_mask_reference."""
    _need_card()
    b, l, dh, heads, rate, seed = 2, 128, 128, 6, 0.3, 31337
    z = torch.zeros(b, l, heads * dh, device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(l, dh, device="cuda").repeat(b, 1, heads).bfloat16()
    qkv = tfa.pack_qkv_weights(z, z, eye, heads, heads).contiguous()
    leaf = qkv.clone().requires_grad_()
    tfa.flash_attention_packed(leaf, None, seed, heads, heads,
                               rate).backward(eye)
    dv = leaf.grad.reshape(b, l, 3, heads * dh)[:, :, 2]
    dv = dv.float().reshape(b, l, heads, dh).permute(0, 2, 3, 1)
    want = tfa.dropout_keep_mask_reference(seed, b, heads, l, l, rate,
                                          device="cuda")
    assert torch.equal(dv * (l * (1.0 - rate)) > 0.5, want)


@pytest.mark.cuda
def test_small_fp32_training_step_card_equals_cpu():
    """One training step (accum 2, dropout 0.1 everywhere it is on in the
    baseline, LoRA at full lr, AdamW eps 1) of a small fp32 model whose text attention
    takes flash_attention on the card and its plain versions on the CPU:
    the same loss and grad_norm within 1e-4 relative, the same parameters
    within 1e-5."""
    _need_card()
    import numpy as np
    from mmoe_multimodal_rec_tpu_torch.config import tiny_config
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer, dummy_batch
    cfg = tiny_config(batch_size=2)
    m = cfg.model
    m.use_flash_attention = True
    m.text.hidden_size = m.image.hidden_size = 128
    m.text.num_heads = m.image.num_heads = 2
    m.text.intermediate_size = m.image.intermediate_size = 256
    m.text.max_position_embeddings = 128
    m.packer.max_tok = 128
    m.text.lora_fused_dropout = False
    o = cfg.train.optim
    # LoRA at full lr from the first update; eps 1 makes that update
    # 0.1 * g / (|g| + 1), nearly linear in g (tests/test_torch_train.py)
    o.freeze_steps, o.unfreeze_steps, o.lr, o.eps = -1, 1, 0.1, 1.0
    rng = np.random.default_rng(0)
    batch = dummy_batch(cfg, accum=2)
    for side in ("user", "item"):
        tok = rng.integers(5, 200, batch[f"{side}_tokens"].shape)
        tok[..., 100:] = 0                  # padded tail keys
        batch[f"{side}_tokens"] = tok.astype(np.int32)
        batch[f"{side}_sent_chunk"][..., :3] = rng.integers(0, 4, (2, 2, 3))
        batch[f"{side}_sent_tok"][..., :3] = rng.integers(0, 100, (2, 2, 3))
    batch["label_good"] = (rng.random((2, 2)) < 0.5).astype(np.float32)
    before = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    got = Trainer(cfg, device="cuda")
    mg = got.run_step(batch)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches - before[0] == 2 * 2 * 2
    assert tfa.flash_attention_bwd.launches - before[1] == 2 * 2 * 2
    want = Trainer(cfg, device="cpu")
    mw = want.run_step(batch)
    for key in ("loss", "grad_norm"):
        assert abs(mg[key] - mw[key]) <= 1e-4 * abs(mw[key]), key
    for k, p in want.trainable.items():
        err = (got.trainable[k].detach().cpu() - p.detach()).abs().max()
        assert err.item() <= 1e-5, k


# (b, h, lq, lk, lk_padded): the short attentions' shapes on the main path
# (the sentence cross expert, the fuse experts), the text mask read-back
# shape, an lk that is not a multiple of 16 (byte stores), and an explicit
# counter stride
KEEP_MASK_CASES = [(64, 8, 64, 64, None), (64, 8, 2, 2, None),
                   (4, 12, 384, 384, None), (3, 5, 7, 37, None),
                   (2, 4, 64, 64, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,lk_padded", KEEP_MASK_CASES)
@pytest.mark.parametrize("seed,rate", [(987654321, 0.1), (-5, 0.5)])
def test_keep_mask_kernel_equals_the_plain_version(b, h, lq, lk, lk_padded,
                                                   seed, rate):
    """dropout_keep_mask's kernel (#8) against dropout_keep_mask_reference
    on the same device, bit for bit, and one launch a call."""
    _need_card()
    before = tfa.dropout_keep_mask.launches
    got = tfa.dropout_keep_mask(seed, b, h, lq, lk, rate, lk_padded,
                                device="cuda")
    torch.cuda.synchronize()
    assert tfa.dropout_keep_mask.launches == before + 1
    want = tfa.dropout_keep_mask_reference(seed, b, h, lq, lk, rate,
                                           lk_padded, device="cuda")
    assert got.dtype == torch.bool and got.shape == (b, h, lq, lk)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_short_attention_dropout_takes_the_keep_mask_kernel(monkeypatch):
    """A training forward of the einsum attention (L = 64, dh 96: no
    attention kernel takes it) on the card draws its mask through #8, never
    through the plain version, and equals the same layer on the CPU."""
    _need_card()
    from mmoe_multimodal_rec_tpu_torch.models import layers
    plain_calls = []
    reference = tfa.dropout_keep_mask_reference
    monkeypatch.setattr(tfa, "dropout_keep_mask_reference",
                        lambda *a, **k: plain_calls.append(
                            torch.device(k["device"]).type)
                        or reference(*a, **k))
    outs = []
    for device in ("cuda", "cpu"):
        attn = layers.Attention(768, 8, dropout=0.1)
        layers.init_weights(attn, torch.Generator().manual_seed(0))
        attn.to(device)
        x = torch.randn(4, 64, 768, generator=torch.Generator()
                        .manual_seed(1)).to(device)
        before = tfa.dropout_keep_mask.launches
        outs.append(attn(x, x, x, None, deterministic=False,
                         rng=torch.Generator().manual_seed(2)).cpu())
        assert tfa.dropout_keep_mask.launches - before == (
            1 if device == "cuda" else 0)
    assert plain_calls == ["cpu"]
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4
