"""The port's attention (mmoe_multimodal_rec_tpu_torch/ops), packed-qkv and
split q/k/v, against the JAX package's Pallas kernels run in interpret mode,
as tests/test_flash_attention.py runs them: the same numpy inputs and seeds
go through both, fp32.  Packed forward within atol 2e-5 (the JAX suite's
own tolerance against einsum); split forward within 1e-5 and its gradients
within 1e-4 (fp32 sums in another order through two products).  On
the CPU the port's wrapper takes its plain PyTorch version; the CUDA kernel
itself is held against that plain version by tests/test_torch_cuda.py and
chip_smoke.py on the card."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmoe_multimodal_rec_tpu_torch.ops import cuda_lib
from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as tfa

# the JAX ops package re-exports the function under the module's name
jfa = importlib.import_module("mmoe_multimodal_rec_tpu.ops.flash_attention")

H = 4
DH = 64
D = H * DH
ATOL = 2e-5


def _qkv(b, l, hb, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, l, D)).astype(np.float32)
               for _ in range(3))
    packed = np.array(jfa.pack_qkv_weights(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), H, hb))
    return q, k, v, packed


def _both(packed, mask, seed, hb, rate):
    want = jfa.flash_attention_packed(
        jnp.asarray(packed), None if mask is None else jnp.asarray(mask),
        seed, H, hb, rate, True)
    got = tfa.flash_attention_packed(
        torch.from_numpy(packed), None if mask is None else
        torch.from_numpy(mask), seed, H, hb, rate)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("hb,l", [(4, 384), (2, 256), (4, 197)])
def test_packed_matches_jax_interpret(hb, l):
    b = 2
    _, _, _, packed = _qkv(b, l, hb)
    mask = np.zeros((b, l), np.int8)
    mask[0, -5:] = 1
    mask[1, l // 3:l // 2] = 1
    got, want = _both(packed, mask, None, hb, 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_packed_no_mask_matches_jax_interpret():
    _, _, _, packed = _qkv(1, 197, 2, seed=3)
    got, want = _both(packed, None, None, 2, 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_all_pad_row_gives_uniform_weights():
    """An all-pad row averages v over the L real keys (the einsum path's
    answer); at L = 256 the JAX kernel has no zero-padded key tail, so it
    agrees."""
    b, l, hb = 2, 256, 2
    q, k, v, packed = _qkv(b, l, hb, seed=1)
    mask = np.zeros((b, l), np.int8)
    mask[1] = 1
    got, want = _both(packed, mask, None, hb, 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), (l, D)),
                               atol=ATOL)
    assert np.all(np.isfinite(got))


def test_dropout_mask_and_output_match_jax_interpret():
    b, l, hb, rate, seed = 2, 256, 2, 0.1, 1234
    _, _, _, packed = _qkv(b, l, hb, seed=2)
    keep_j = np.asarray(jfa.dropout_keep_mask(seed, b, H, l, l, rate,
                                              interpret=True))
    keep_t = tfa.dropout_keep_mask(seed, b, H, l, l, rate).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)
    assert abs(keep_t.mean() - (1 - rate)) < 0.01
    mask = np.zeros((b, l), np.int8)
    mask[0, -7:] = 1
    got, want = _both(packed, mask, seed, hb, rate)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # another seed draws another mask
    other, _ = _both(packed, mask, seed + 1, hb, rate)
    assert not np.allclose(other, got)


@pytest.mark.parametrize("seed,lq,lk,rate", [(-5, 128, 100, 0.3),
                                             (2**31 - 1, 8, 130, 0.5)])
def test_keep_mask_counter_layout(seed, lq, lk, rate):
    """Negative / large seeds and an unaligned key length (the counter
    strides over lk rounded up to 128) give JAX's bits too."""
    keep_j = np.asarray(jfa.dropout_keep_mask(seed, 2, H, lq, lk, rate,
                                              interpret=True))
    keep_t = tfa.dropout_keep_mask(seed, 2, H, lq, lk, rate).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)


def test_pack_qkv_weights_exact():
    rng = np.random.default_rng(5)
    for hb in (1, 2, 4):
        w = [rng.normal(size=(48, D)).astype(np.float32) for _ in range(3)]
        bias = [rng.normal(size=(D,)).astype(np.float32) for _ in range(3)]
        for parts in (w, bias):
            want = np.asarray(jfa.pack_qkv_weights(
                *(jnp.asarray(x) for x in parts), H, hb))
            got = tfa.pack_qkv_weights(*(torch.from_numpy(x) for x in parts),
                                       H, hb).numpy()
            np.testing.assert_array_equal(got, want)


def test_head_group_matches_jax():
    for dh in (32, 64, 128):
        for h in (1, 2, 3, 4, 6, 8, 12):
            assert tfa._head_group(dh, h, 6) == jfa._head_group(dh, h, 6)


def test_wrapper_rejects_bad_shapes_and_devices():
    qkv = torch.zeros(1, 128, 3 * D)
    with pytest.raises(ValueError, match="not a multiple of n_heads"):
        tfa.flash_attention_packed(qkv, None, None, 5, 1)
    with pytest.raises(ValueError, match="not a multiple of hb"):
        tfa.flash_attention_packed(qkv, None, None, H, 3)
    with pytest.raises(ValueError, match=r"\[B, L, 3D\]"):
        tfa.flash_attention_packed(torch.zeros(1, 128, 10), None, None, H, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfa.flash_attention_packed(torch.zeros(1, 100, 3 * D), None, 1, H, 2,
                                   0.1)
    # a device with no kernel raises: nothing drops to another path
    with pytest.raises(ValueError, match="no kernel for device"):
        tfa.flash_attention_packed(qkv.to("meta"), None, None, H, 2)


def test_cpu_tensor_takes_plain_version_without_counting():
    before = tfa.flash_attention_packed.launches
    _, _, _, packed = _qkv(1, 128, 2)
    tfa.flash_attention_packed(torch.from_numpy(packed), None, None, H, 2)
    assert tfa.flash_attention_packed.launches == before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No CUDA toolkit: the build raises, nothing is loaded in its place."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build("flash_attention_fwd")
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_tracks_source():
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "lora_dropout"):
        a = cuda_lib.library_path(name)
        assert a.name.startswith(f"lib{name}-")
        assert a.parent == cuda_lib.BUILD_DIR
        assert a == cuda_lib.library_path(name)


SPLIT_FWD_ATOL = 1e-5
SPLIT_GRAD_ATOL = 1e-4


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("masked", [True, False])
def test_split_forward_and_vjp_match_jax_interpret(rate, masked):
    """flash_attention and its backward against JAX flash_attention(...,
    interpret=True) and its custom vjp (the Pallas backward at rate 0.1,
    the XLA recompute at rate 0), same seed, same cotangent."""
    import jax
    b, l, seed = 2, 128, 77
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.normal(size=(b, l, D)).astype(np.float32)
                  for _ in range(4))
    mask = None
    if masked:
        mask = np.zeros((b, l), np.int8)
        mask[0, -9:] = 1
        mask[1, 40:50] = 1
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jmask, seed, H,
                                               rate, 512, True),
        *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, None if mask is None else
                              torch.from_numpy(mask), seed, H, rate)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=SPLIT_FWD_ATOL)
    got.backward(torch.from_numpy(g))
    for t, w, name in zip((tq, tk, tv), want_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=SPLIT_GRAD_ATOL, err_msg=f"d{name}")


def test_split_bwd_reference_is_the_gradient_of_the_forward():
    """At rate 0.1 the written-out backward equals autograd through the
    plain forward (the same keep mask enters both)."""
    b, l, seed, rate = 1, 128, 5, 0.1
    rng = np.random.default_rng(12)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, l, D)).astype(
        np.float32)) for _ in range(4))
    pad = torch.zeros(b, l, dtype=torch.bool)
    pad[0, -3:] = True
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tfa.flash_attention_reference(*leaves, pad, seed, H, rate).backward(g)
    got = tfa.flash_attention_bwd_reference(q, k, v, pad, seed, g, H, rate)
    for t, w in zip(got, leaves):
        np.testing.assert_allclose(t.numpy(), w.grad.numpy(),
                                   atol=SPLIT_GRAD_ATOL)


def test_split_wrapper_rejects_and_does_not_count_on_cpu():
    q = torch.zeros(1, 128, D)
    with pytest.raises(ValueError, match="one shape"):
        tfa.flash_attention(q, torch.zeros(1, 64, D), q, None, None, H)
    with pytest.raises(ValueError, match="not a multiple of n_heads"):
        tfa.flash_attention(q, q, q, None, None, 5)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = q.to("meta")
        tfa.flash_attention(m, m, m, None, None, H)
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    x = q.clone().requires_grad_()
    tfa.flash_attention(x, x, x, None, 3, H, 0.1).sum().backward()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("l,hb,masked,rate", [(128, 2, True, 0.1),
                                              (100, 4, False, 0.0),
                                              (100, 2, True, 0.0)])
def test_packed_vjp_matches_jax_interpret(l, hb, masked, rate):
    """flash_attention_packed's backward (dqkv in the packed layout) against
    JAX flash_attention_packed(..., interpret=True)'s custom vjp (the
    packed Pallas backward), same seed, same cotangent: L = 128 masked at
    rate 0.1, and an L below 128 at rate 0 (the JAX kernel pads it to 128
    with masked keys; the port masks the ragged tail by bounds)."""
    import jax
    b, seed = 2, 91
    _, _, _, packed = _qkv(b, l, hb, seed=13)
    g = np.random.default_rng(14).normal(size=(b, l, D)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((b, l), np.int8)
        mask[0, -9:] = 1
        mask[1, 40:50] = 1
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(
        lambda x: jfa.flash_attention_packed(x, jmask, seed, H, hb, rate,
                                             True), jnp.asarray(packed))
    (want_grad,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(packed).requires_grad_()
    before = (tfa.flash_attention_packed.launches,
              tfa.flash_attention_packed_bwd.launches)
    got = tfa.flash_attention_packed(leaf, None if mask is None else
                                     torch.from_numpy(mask), seed, H, hb,
                                     rate)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    got.backward(torch.from_numpy(g))
    assert leaf.grad.shape == packed.shape
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_grad),
                               atol=SPLIT_GRAD_ATOL)
    assert (tfa.flash_attention_packed.launches,
            tfa.flash_attention_packed_bwd.launches) == before


def test_packed_bwd_reference_is_the_gradient_of_the_forward():
    """The written-out packed backward equals autograd through the plain
    packed forward at rate 0.1, and equals the split backward's gradients
    packed with pack_qkv_weights."""
    b, l, hb, seed, rate = 1, 128, 2, 6, 0.1
    q, k, v, packed = _qkv(b, l, hb, seed=15)
    g = torch.from_numpy(np.random.default_rng(16).normal(
        size=(b, l, D)).astype(np.float32))
    pad = torch.zeros(b, l, dtype=torch.bool)
    pad[0, -3:] = True
    leaf = torch.from_numpy(packed).requires_grad_()
    tfa.flash_attention_packed_reference(leaf, pad, seed, H, hb,
                                         rate).backward(g)
    got = tfa.flash_attention_packed_bwd_reference(torch.from_numpy(packed),
                                                   pad, seed, g, H, hb, rate)
    np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(),
                               atol=SPLIT_GRAD_ATOL)
    split = tfa.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), pad, seed, g, H, rate)
    np.testing.assert_allclose(
        got.numpy(), tfa.pack_qkv_weights(*split, H, hb).numpy(), atol=1e-6)
