"""Packed-qkv self-attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of mmoe_multimodal_rec_tpu/ops/flash_attention.py `flash_attention_packed`
(forward).  The input is the projection output qkv [B, L, 3D] in the
GROUP-INTERLEAVED column order `pack_qkv_weights` builds — for each head
group g of hb heads, [q_g | k_g | v_g] with w = hb*dh columns each — and the
output is [B, L, D] in head-major order, ready for the out projection.
`pad_mask` [B, L] is 1/True at padded keys (torch key_padding_mask).

`flash_attention_packed` dispatches on the tensor's device, never on what
the machine has: a CPU tensor takes `flash_attention_packed_reference`, a
CUDA tensor launches the hand-written Hopper kernel
(csrc/flash_attention_packed.cu, built by ops/cuda_lib.py at first use) or
raises.  `flash_attention_packed.launches` counts kernel launches.

Dropout (rate > 0, L a multiple of 128) uses the JAX interpret-mode keep
mask: a murmur3-finalizer hash over the counter ((b*H + h)*Lq + q)*Lk_pad + k,
keep = bits >= uint32(rate * (2^32 - 1)); `dropout_keep_mask` builds it, so
given the same seed the masks equal JAX's bit for bit.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_lib

NEG_INF = -1e9  # finite mask value: all-pad rows give uniform weights, not NaN
_LANE = 128
_M32 = 0xFFFFFFFF
KERNEL_HEAD_DIMS = (64, 128)


def _head_group(dh: int, n_heads: int, max_heads: int) -> int:
    """Heads per group: the merged slice width (hb*dh) must be a 128-lane
    multiple and divide the head count; bounded by max_heads.  Kept from the
    JAX package so the packed column order is the same on both."""
    for hb in range(min(max_heads, n_heads), 0, -1):
        if n_heads % hb == 0 and (hb * dh) % _LANE == 0:
            return hb
    return n_heads


def pack_qkv_weights(wq, wk, wv, n_heads: int, hb: int):
    """[..., D] x3 -> [..., 3D] in the GROUP-INTERLEAVED column order: for
    each head group g, [q_g | k_g | v_g] (w = hb*dh columns each).  Takes
    kernels in the JAX [din, D] layout, or biases [D]."""
    d = wq.shape[-1]
    w = hb * (d // n_heads)
    g = n_heads // hb
    parts = [x.reshape(x.shape[:-1] + (g, w)) for x in (wq, wk, wv)]
    return torch.stack(parts, dim=-2).reshape(wq.shape[:-1] + (3 * d,))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, split into 16-bit
    halves of c so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_bits(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """JAX `_hash_bits` over uint32 counters, in int64 arithmetic."""
    x = (_mul32(idx & _M32, 2654435761) + (seed & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _threshold(rate: float) -> int:
    return int(min(max(rate, 0.0), 1.0) * 4294967295.0)


def dropout_keep_mask(seed: int, b: int, h: int, lq: int, lk: int,
                      rate: float, lk_padded: Optional[int] = None,
                      device="cpu") -> torch.Tensor:
    """Bool keep mask [b, h, lq, lk] of the portable stream, equal to JAX
    `dropout_keep_mask(..., interpret=True)` (the counter strides over the
    key length rounded up to 128, as there)."""
    lk_p = lk_padded or (-(-lk // _LANE) * _LANE)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    idx = (((ar(b)[:, None] * h + ar(h)[None, :]) * lq)[..., None, None]
           + ar(lq)[:, None]) * lk_p + ar(lk)[None, :]
    return _hash_bits(seed, idx & _M32) >= _threshold(rate)


def _check(qkv: torch.Tensor, n_heads: int, hb: int, dropout_rate: float):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, L, 3D], got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // 3
    if d % n_heads:
        raise ValueError(f"D={d} is not a multiple of n_heads={n_heads}")
    if n_heads % hb:
        raise ValueError(f"n_heads={n_heads} is not a multiple of hb={hb}")
    if dropout_rate > 0.0 and qkv.shape[1] % _LANE:
        raise ValueError("dropout needs L to be a multiple of 128 (the keep "
                         f"mask's counter layout), got L={qkv.shape[1]}")


def flash_attention_packed_reference(qkv: torch.Tensor,
                                     pad_mask: Optional[torch.Tensor] = None,
                                     seed: Optional[int] = None,
                                     n_heads: int = 12, hb: int = 6,
                                     dropout_rate: float = 0.0
                                     ) -> torch.Tensor:
    """Plain PyTorch version: unpack the heads, fp32 softmax with padded
    keys at -1e9, the same hash keep mask, output in the input dtype."""
    _check(qkv, n_heads, hb, dropout_rate)
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    x = qkv.float().reshape(b, l, n_heads // hb, 3, hb, dh)
    q, k, v = (x[:, :, :, i].reshape(b, l, n_heads, dh) for i in range(3))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed or 0, b, n_heads, l, l, dropout_rate,
                                 device=qkv.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.reshape(b, l, d).to(qkv.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    lib = cuda_lib.load("flash_attention_packed")
    fn = lib.mmoe_flash_attention_packed
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, ctypes.c_float,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_float, i, p]
        fn.restype = i
    return fn


def flash_attention_packed(qkv: torch.Tensor,
                           pad_mask: Optional[torch.Tensor] = None,
                           seed: Optional[int] = None, n_heads: int = 12,
                           hb: int = 6, dropout_rate: float = 0.0
                           ) -> torch.Tensor:
    """Self-attention over a group-interleaved qkv [B, L, 3D] -> [B, L, D].

    CPU tensor: the plain PyTorch version.  CUDA tensor: the Hopper kernel,
    or an exception for what it does not take (dtype other than bf16/fp32,
    a non-contiguous or misaligned tensor, a mask on another device, head
    dim other than 64/128)."""
    _check(qkv, n_heads, hb, dropout_rate)
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(qkv, pad_mask, seed, n_heads,
                                                hb, dropout_rate)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes bfloat16 or float32, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel is built for head dim {KERNEL_HEAD_DIMS}, "
                         f"got {dh}")
    mask_ptr = None
    if pad_mask is not None:
        if pad_mask.device != qkv.device:
            raise ValueError(f"pad_mask on {pad_mask.device}, qkv on "
                             f"{qkv.device}")
        if tuple(pad_mask.shape) != (b, l) or not pad_mask.is_contiguous():
            raise ValueError(f"pad_mask must be a contiguous [{b}, {l}], got "
                             f"{tuple(pad_mask.shape)}")
        if pad_mask.dtype == torch.bool:
            pad_mask = pad_mask.view(torch.uint8)
        elif pad_mask.dtype not in (torch.int8, torch.uint8):
            raise TypeError(f"pad_mask must be bool/int8/uint8, got "
                            f"{pad_mask.dtype}")
        mask_ptr = pad_mask.data_ptr()
    rate = float(dropout_rate)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    fn = _kernel()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), mask_ptr, out.data_ptr(),
                 _DTYPE_CODES[qkv.dtype], b, l, n_heads, hb, dh,
                 1.0 / math.sqrt(dh), (seed or 0) & _M32,
                 _threshold(rate) if rate > 0.0 else 0,
                 1.0 / (1.0 - rate) if rate > 0.0 else 1.0,
                 int(rate > 0.0), stream)
    if err:
        raise RuntimeError(f"flash_attention_packed launch failed: CUDA "
                           f"error {err}")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0
