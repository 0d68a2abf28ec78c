"""The port's fused LoRA-input dropout (mmoe_multimodal_rec_tpu_torch/ops/
lora_dropout.py) against the JAX package's Pallas op run in interpret mode,
as tests/test_lora_dropout.py runs it, and `LoRADense`'s fused branch
against its unfused one.  On the CPU the port's wrappers take their plain
PyTorch versions; the CUDA kernels are held against those by
tests/test_torch_cuda.py and chip_smoke.py on the card.

Inputs come from numpy seeds; M = 512 rows (the JAX op needs M to split
into 256..2048-row blocks), D = 128, r = 4.  Tolerances: the keep mask bit
for bit; fp32 t and dh within 1e-5 and dA within 1e-4 (fp32 sums in
another order, dA over 512 rows); bf16 within one bf16 unit in the last
place of the largest value (2**-7 of it), since both round an fp32 sum
taken in another order."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmoe_multimodal_rec_tpu.ops import lora_dropout as jld
from mmoe_multimodal_rec_tpu_torch.models import layers as tlayers
from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as tld

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

M, D, R = 512, 128, 4
FP32_TOL = {"t": 1e-5, "dh": 1e-5, "da": 1e-4}


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(M, D)).astype(np.float32)
    a = (0.1 * rng.normal(size=(D, R))).astype(np.float32)
    dt = rng.normal(size=(M, R)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(x, jdt) for x in (h, a, dt)],
            [torch.from_numpy(x).to(tdt) for x in (h, a, dt)])


def _close(name, got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    tol = (FP32_TOL[name] if dtype == "float32"
           else 2.0 ** -7 * np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_versions_match_jax_interpret(dtype, rate):
    """t, and dh and dA through one vjp, against JAX lora_dropout_matmul in
    interpret mode on the same inputs and seed."""
    seed = 1234
    (jh, ja, jdt), (th, ta, tdt) = _inputs(dtype)
    want_t, vjp = jax.vjp(
        lambda h, a: jld.lora_dropout_matmul(h, a, seed, rate, True), jh, ja)
    want_dh, want_da = vjp(jdt)
    got_t = tld.lora_dropout_fwd(th, ta, seed, rate)
    got_da = tld.lora_dropout_da(th, tdt, seed, rate)
    got_dh = tld.lora_dropout_dh(tdt, ta, seed, rate)
    assert got_t.dtype == got_da.dtype == got_dh.dtype == th.dtype
    _close("t", got_t, want_t, dtype)
    _close("dh", got_dh, want_dh, dtype)
    _close("da", got_da, want_da, dtype)


@pytest.mark.parametrize("rate,seed", [(0.1, 1234), (0.5, 2 ** 31 - 2)])
def test_keep_mask_is_the_jax_stream(rate, seed):
    """hash_keep_mask equals JAX reference_keep_mask bit for bit, and dh
    with dt @ A^T = 1 reads it back: dh = keep / (1 - rate)."""
    want = np.asarray(jld.reference_keep_mask(seed, M, D, 256, rate))
    got = tld.hash_keep_mask((M, D), seed, rate, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.01
    dt = torch.ones(M, R)
    a = torch.full((D, R), 1.0 / R)
    dh = tld.lora_dropout_dh(dt, a, seed, rate)
    np.testing.assert_array_equal((dh * (1 - rate) > 0.5).numpy(), want)


def test_autograd_launches_only_the_needed_backward():
    """lora_dropout_matmul's backward skips dA when A needs no gradient
    and dh when h needs none (XLA drops a dead output the same way), and
    its gradients are the plain dA and dh.  CPU tensors take the plain
    versions and count no launch."""
    _, (h, a, dt) = _inputs("float32", seed=3)
    counts = lambda: (tld.lora_dropout_fwd.launches,
                      tld.lora_dropout_da.launches,
                      tld.lora_dropout_dh.launches)
    before = counts()
    calls = []
    real = {n: getattr(tld, n) for n in ("lora_dropout_da",
                                          "lora_dropout_dh")}
    for name, fn in real.items():
        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)
        setattr(tld, name, spy)
    try:
        for needs_h, needs_a in ((True, True), (False, True), (True, False)):
            calls.clear()
            hh = h.clone().requires_grad_(needs_h)
            aa = a.clone().requires_grad_(needs_a)
            tld.lora_dropout_matmul(hh, aa, 7, 0.1).backward(dt)
            want = (["lora_dropout_da"] if needs_a else []) + \
                (["lora_dropout_dh"] if needs_h else [])
            assert calls == want
            if needs_h:
                torch.testing.assert_close(
                    hh.grad, tld.lora_dropout_dh_reference(dt, a, 7, 0.1))
            if needs_a:
                torch.testing.assert_close(
                    aa.grad, tld.lora_dropout_da_reference(h, dt, 7, 0.1))
    finally:
        for name, fn in real.items():
            setattr(tld, name, fn)
    assert counts() == before


def test_gate_and_refusals():
    """lora_fused_ok is JAX's gate without its TPU and row terms; the
    wrappers refuse mixed dtypes and any device but the CPU and CUDA."""
    h = torch.zeros(1000, 128)
    assert tld.lora_fused_ok(h, torch.zeros(128, 8))
    assert not tld.lora_fused_ok(torch.zeros(4, 96), torch.zeros(96, 8))
    assert not tld.lora_fused_ok(torch.zeros(4, 8192), torch.zeros(8192, 8))
    assert not tld.lora_fused_ok(h, torch.zeros(128, 513))
    with pytest.raises(ValueError, match="share a dtype"):
        tld.lora_dropout_fwd(h, torch.zeros(128, 8, dtype=torch.float64), 1,
                             0.1)
    with pytest.raises(ValueError, match="no kernel for device"):
        tld.lora_dropout_matmul(h.to("meta"), torch.zeros(128, 8,
                                                          device="meta"),
                                1, 0.1)


def _lora_dense(fused: bool, d: int = 128):
    layer = tlayers.LoRADense(d, d, 4, 32.0, dropout=0.1,
                              fused_dropout=fused)
    tlayers.init_weights(layer, torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.lora_b.normal_(0, 0.1, generator=torch.Generator()
                             .manual_seed(1))
    return layer


@pytest.mark.parametrize("d", [128, 32])
def test_lora_dense_fused_matches_unfused(d):
    """LoRADense with the fused branch against the unfused one on the CPU,
    training mode, the same weights and generator seed: the same value and
    gradients within 1e-6 of the largest value (fp32; the branches scale
    by 1/(1-r) as a product and as a quotient, a last-place difference that
    sums of cancelling terms carry) and the same number of seeds drawn.
    At D = 32 the gate sends the fused layer down the unfused branch."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 16, d)).astype(np.float32))
    outs = []
    for fused in (True, False):
        layer = _lora_dense(fused, d)
        xx = x.clone().requires_grad_()
        gen = torch.Generator().manual_seed(11)
        y = layer(xx, deterministic=False, rng=gen)
        y.square().sum().backward()
        outs.append((y.detach(), xx.grad, layer.lora_a.grad,
                     layer.lora_b.grad, torch.randint(1 << 30, (1,),
                                                      generator=gen)))
    for got, want in zip(*outs):
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 1e-6 * max(want.abs().max().item(), 1.0), err
