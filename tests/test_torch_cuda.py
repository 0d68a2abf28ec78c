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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,dh,masked,rate,tol", [
    ("bfloat16", 384, 64, True, 0.0, 2e-2),
    ("bfloat16", 197, 64, False, 0.0, 2e-2),
    ("bfloat16", 384, 64, True, 0.1, 2e-2),
    ("bfloat16", 256, 128, True, 0.0, 2e-2),
    ("float32", 197, 64, True, 0.0, 1e-4),
    ("float32", 130, 128, False, 0.0, 1e-4),
])
def test_packed_kernel_matches_plain_version(dtype, l, dh, masked, rate, tol):
    """flash_attention_packed's Hopper kernel against its plain version run
    in fp32 on the same inputs: bf16 output within 2e-2 (bf16 rounding of
    p and of the output), fp32 within 1e-4 (summation order, expf).  Rows
    of real length L, L/2, 1 and 0 (all pad)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, heads = 4, 768 // dh
    hb = tfa._head_group(dh, heads, 6)
    qkv = torch.randn(b, l, 3 * heads * dh, generator=gen,
                      device="cuda").to(getattr(torch, dtype))
    pad = None
    if masked:
        lens = torch.tensor([l, l // 2, 1, 0], device="cuda")
        pad = torch.arange(l, device="cuda")[None, :] >= lens[:, None]
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
    keep[b, h, q, j] / (L (1 - rate)).  It must equal dropout_keep_mask
    (bit-identical to JAX's interpret-mode stream) at every position."""
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
    want = tfa.dropout_keep_mask(seed, b, heads, l, l, rate, device="cuda")
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
