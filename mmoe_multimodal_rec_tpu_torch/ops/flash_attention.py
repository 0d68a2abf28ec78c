"""Self-attention kernels' wrappers and their plain PyTorch versions.

Port of mmoe_multimodal_rec_tpu/ops/flash_attention.py:
- `flash_attention_packed` (forward and backward, a torch.autograd.Function):
  the input is the projection output qkv [B, L, 3D] in the
  GROUP-INTERLEAVED column order `pack_qkv_weights` builds — for each head
  group g of hb heads, [q_g | k_g | v_g] with w = hb*dh columns each — and
  its gradient comes back in the same layout; serving's ViT and merged-LoRA
  text, and HoME's fine-tuned ViT layers;
- `flash_attention` (forward and backward, a torch.autograd.Function): q, k,
  v [B, L, D] each, as the separate q/k/v projections produce them; the
  training path's text self-attention, with in-kernel dropout.
Outputs are [B, L, D] in head-major order, ready for the out projection.
`pad_mask` [B, L] is 1/True at padded keys (torch key_padding_mask).

Every wrapper dispatches on the tensor's device, never on what the machine
has: a CPU tensor takes the plain PyTorch version
(`flash_attention_packed_reference`, `flash_attention_packed_bwd_reference`,
`flash_attention_reference`, `flash_attention_bwd_reference`), a CUDA
tensor launches the hand-written Hopper kernel (csrc/flash_attention_fwd.cu,
csrc/flash_attention_bwd.cu, built by ops/cuda_lib.py at first use) or
raises.  `<wrapper>.launches` counts the wrapper's kernel launches (each
backward wrapper: one per call, which runs its dq and dk/dv kernels).

Dropout uses the JAX interpret-mode keep mask: a murmur3-finalizer hash
over the counter ((b*H + h)*Lq + q)*Lk_pad + k (Lk_pad = Lk rounded up to
128), keep = bits >= uint32(rate * (2^32 - 1)); `dropout_keep_mask` builds
it, so given the same seed the masks equal JAX's bit for bit.
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


def _check_split(q, k, v, n_heads: int):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must be [B, L, D] of one shape (self-"
                         f"attention), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] % n_heads:
        raise ValueError(f"D={q.shape[-1]} is not a multiple of "
                         f"n_heads={n_heads}")


def _lk_padded(lk: int) -> int:
    return -(-lk // _LANE) * _LANE


def _probs(q, k, pad_mask, n_heads: int) -> torch.Tensor:
    """fp32 softmax [B, H, L, L] of the split layout, padded keys at -1e9."""
    b, l, d = q.shape
    dh = d // n_heads
    qh = q.float().reshape(b, l, n_heads, dh)
    kh = k.float().reshape(b, l, n_heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask.bool()[:, None, None, :], NEG_INF)
    return torch.softmax(scores, dim=-1)


def flash_attention_reference(q, k, v, pad_mask=None,
                              seed: Optional[int] = None, n_heads: int = 12,
                              dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention`'s forward: fp32 softmax
    with padded keys at -1e9, the hash keep mask, output in q's dtype."""
    _check_split(q, k, v, n_heads)
    b, l, d = q.shape
    p = _probs(q, k, pad_mask, n_heads)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed or 0, b, n_heads, l, l, dropout_rate,
                                 device=q.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    vh = v.float().reshape(b, l, n_heads, d // n_heads)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, l, d).to(q.dtype)


def _bwd_heads(qh, kh, vh, gh, pad_mask, seed: Optional[int],
               dropout_rate: float, dt):
    """The backward of one self-attention over head-split fp32 q, k, v, dO
    [B, L, H, dh], written out as the JAX kernel's `_head_bwd`; (dq, dk, dv)
    in fp32, rounded as the kernel rounds its bf16 operands (dt)."""
    b, l, n_heads, dh = qh.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    inv = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0.0 else 1.0
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    p_drop = p
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed or 0, b, n_heads, l, l, dropout_rate,
                                 device=qh.device)
        p_drop = torch.where(keep, p, 0.0)
        dp = torch.where(keep, dp, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop.to(dt).float(), gh) * inv
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * (inv / math.sqrt(dh))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, pad_mask, seed: Optional[int],
                                  dout, n_heads: int = 12,
                                  dropout_rate: float = 0.0):
    """Plain PyTorch version of `flash_attention`'s backward, written out as
    the JAX kernel's `_head_bwd`: p the pre-dropout softmax,
    dv = (p*keep)^T dO / (1-r) with p*keep cast to the input dtype,
    dp = keep * (dO v^T), ds = p * (dp - rowsum(dp*p)) * scale / (1-r) cast
    to the input dtype, dq = ds k, dk = ds^T q; fp32 sums; (dq, dk, dv) in
    the input dtype."""
    _check_split(q, k, v, n_heads)
    b, l, d = q.shape
    heads = (x.float().reshape(b, l, n_heads, d // n_heads)
             for x in (q, k, v, dout))
    grads = _bwd_heads(*heads, pad_mask, seed, dropout_rate, q.dtype)
    return tuple(x.reshape(b, l, d).to(q.dtype) for x in grads)


def flash_attention_packed_bwd_reference(qkv, pad_mask, seed: Optional[int],
                                         dout, n_heads: int = 12, hb: int = 6,
                                         dropout_rate: float = 0.0
                                         ) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention_packed`'s backward (JAX
    `_bwd_kernel_packed`, the same `_head_bwd` math as
    `flash_attention_bwd_reference`): dqkv [B, L, 3D] in qkv's
    group-interleaved layout and dtype, for dout [B, L, D] head-major."""
    _check(qkv, n_heads, hb, dropout_rate)
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    x = qkv.float().reshape(b, l, n_heads // hb, 3, hb, dh)
    q, k, v = (x[:, :, :, i].reshape(b, l, n_heads, dh) for i in range(3))
    gh = dout.float().reshape(b, l, n_heads, dh)
    grads = _bwd_heads(q, k, v, gh, pad_mask, seed, dropout_rate, qkv.dtype)
    return pack_qkv_weights(*(g.reshape(b, l, d) for g in grads), n_heads,
                            hb).to(qkv.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib_name: str, fn_name: str, argtypes):
    fn = getattr(cuda_lib.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_FWD_ARGTYPES = [_P] * 6 + [_I] * 9 + [_F, _U, _U, _F, _I, _P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 6 + [_F, _U, _U, _F, _I, _P]
_PACKED_BWD_ARGTYPES = [_P] * 6 + [_I] * 7 + [_F, _U, _U, _F, _I, _P]


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """What every kernel refuses: another device kind, dtypes other than
    bf16/fp32 or mixed, non-contiguous or misaligned tensors."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes bfloat16 or float32, got {dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs must share device and dtype, "
                             f"got {t.device}/{t.dtype} and {dev}/{dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             "aligned")


def _check_head_dim(dh: int) -> None:
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel is built for head dim {KERNEL_HEAD_DIMS}, "
                         f"got {dh}")


def _pad_arg(pad_mask: Optional[torch.Tensor], b: int, l: int,
             device) -> Optional[torch.Tensor]:
    """The pad mask as the kernels read it: contiguous uint8 [B, L]."""
    if pad_mask is None:
        return None
    if pad_mask.device != device:
        raise ValueError(f"pad_mask on {pad_mask.device}, inputs on {device}")
    if tuple(pad_mask.shape) != (b, l) or not pad_mask.is_contiguous():
        raise ValueError(f"pad_mask must be a contiguous [{b}, {l}], got "
                         f"{tuple(pad_mask.shape)}")
    if pad_mask.dtype == torch.bool:
        return pad_mask.view(torch.uint8)
    if pad_mask.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"pad_mask must be bool/int8/uint8, got "
                        f"{pad_mask.dtype}")
    return pad_mask


def _dropout_args(seed: Optional[int], rate: float):
    """(seed, threshold, keep_scale, dropout) as the kernels take them."""
    if rate <= 0.0:
        return 0, 0, 1.0, 0
    return (seed or 0) & _M32, _threshold(rate), 1.0 / (1.0 - rate), 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(q, k_ptr: int, v_ptr: int, pad, out, stats, n_heads: int,
                hb: int, row_stride: int, group_stride: int, lk_pad: int,
                seed, rate: float) -> None:
    b, l = q.shape[:2]
    dh = out.shape[-1] // n_heads
    fn = _bind("flash_attention_fwd", "mmoe_flash_attention_fwd",
               _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_ptr, v_ptr,
                 None if pad is None else pad.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, l, n_heads, hb, dh, row_stride,
                 group_stride, lk_pad, 1.0 / math.sqrt(dh),
                 *_dropout_args(seed, rate), _stream(q.device))
    if err:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _packed_fwd_cuda(qkv, pad_mask, seed, n_heads: int, hb: int,
                     rate: float, want_stats: bool):
    _check_cuda("flash_attention_packed", qkv)
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    _check_head_dim(dh)
    if want_stats and qkv.dtype != torch.bfloat16:
        raise TypeError("flash_attention_packed's backward kernel takes "
                        f"bfloat16, got {qkv.dtype}")
    pad = _pad_arg(pad_mask, b, l, qkv.device)
    w = hb * dh * qkv.element_size()
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty((b, n_heads, l, 2), dtype=torch.float32,
                         device=qkv.device) if want_stats else None)
    # the packed counter strides over L itself (dropout needs L % 128 == 0)
    _launch_fwd(qkv, qkv.data_ptr() + w, qkv.data_ptr() + 2 * w, pad, out,
                stats, n_heads, hb, d3, 3 * hb * dh, l, seed, rate)
    flash_attention_packed.launches += 1
    flash_attention_packed.stats_launches += want_stats
    return out, stats


def flash_attention_packed_bwd(qkv, pad_mask, seed: Optional[int], dout,
                               n_heads: int = 12, hb: int = 6,
                               dropout_rate: float = 0.0,
                               stats: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """dqkv [B, L, 3D] of `flash_attention_packed`, in qkv's packed layout,
    for the cotangent dout [B, L, D].

    CPU tensors: `flash_attention_packed_bwd_reference`.  CUDA tensors: the
    Hopper kernel (bf16 only), which also needs the forward kernel's
    softmax statistics `stats` [B, H, L, 2] (m, l)."""
    _check(qkv, n_heads, hb, dropout_rate)
    if qkv.device.type == "cpu":
        return flash_attention_packed_bwd_reference(qkv, pad_mask, seed, dout,
                                                    n_heads, hb, dropout_rate)
    if stats is None:
        raise ValueError("the CUDA backward needs the forward kernel's "
                         "stats")
    _check_cuda("flash_attention_packed_bwd", qkv)
    if qkv.dtype != torch.bfloat16:
        raise TypeError("flash_attention_packed's backward kernel takes "
                        f"bfloat16, got {qkv.dtype}")
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    _check_head_dim(dh)
    if (dout.shape != (b, l, d) or dout.dtype != qkv.dtype
            or dout.device != qkv.device or not dout.is_contiguous()):
        raise ValueError(f"dout must be a contiguous {qkv.dtype} [{b}, {l}, "
                         f"{d}] on {qkv.device}")
    if (stats.dtype != torch.float32 or not stats.is_contiguous()
            or tuple(stats.shape) != (b, n_heads, l, 2)):
        raise ValueError(f"stats must be a contiguous fp32 [{b}, {n_heads}, "
                         f"{l}, 2]")
    pad = _pad_arg(pad_mask, b, l, qkv.device)
    delta = torch.empty((b, n_heads, l), dtype=torch.float32,
                        device=qkv.device)
    dqkv = torch.empty_like(qkv)
    fn = _bind("flash_attention_bwd", "mmoe_flash_attention_bwd_packed",
               _PACKED_BWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), None if pad is None else pad.data_ptr(),
                 dout.data_ptr(), stats.data_ptr(), delta.data_ptr(),
                 dqkv.data_ptr(), _DTYPE_CODES[qkv.dtype], b, l, n_heads, hb,
                 dh, l, 1.0 / math.sqrt(dh),
                 *_dropout_args(seed, dropout_rate), _stream(qkv.device))
    if err:
        raise RuntimeError(f"flash_attention_packed_bwd launch failed: CUDA "
                           f"error {err}")
    flash_attention_packed_bwd.launches += 1
    return dqkv


flash_attention_packed_bwd.launches = 0


class _FlashAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, pad_mask, seed, n_heads, hb, dropout_rate,
                want_grad):
        stats = None
        if qkv.device.type == "cpu":
            out = flash_attention_packed_reference(qkv, pad_mask, seed,
                                                   n_heads, hb, dropout_rate)
        else:
            out, stats = _packed_fwd_cuda(qkv, pad_mask, seed, n_heads, hb,
                                          dropout_rate, want_grad)
        if want_grad:
            ctx.save_for_backward(qkv, pad_mask, stats)
        ctx.seed, ctx.n_heads, ctx.hb, ctx.rate = (seed, n_heads, hb,
                                                   dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, pad_mask, stats = ctx.saved_tensors
        dqkv = flash_attention_packed_bwd(qkv, pad_mask, ctx.seed,
                                          dout.contiguous(), ctx.n_heads,
                                          ctx.hb, ctx.rate, stats)
        return dqkv, None, None, None, None, None, None


def flash_attention_packed(qkv: torch.Tensor,
                           pad_mask: Optional[torch.Tensor] = None,
                           seed: Optional[int] = None, n_heads: int = 12,
                           hb: int = 6, dropout_rate: float = 0.0
                           ) -> torch.Tensor:
    """Self-attention over a group-interleaved qkv [B, L, 3D] -> [B, L, D],
    and its backward (dqkv in the same packed layout).

    CPU tensor: the plain PyTorch versions.  CUDA tensor: the Hopper
    kernels, or an exception for what they do not take (dtype other than
    bf16/fp32, a non-contiguous or misaligned tensor, a mask on another
    device, head dim other than 64/128; a qkv that needs a gradient must be
    bf16).  The forward kernel stores the softmax statistics for the
    backward only when qkv needs a gradient: serving runs the instantiation
    without that store (`flash_attention_packed.stats_launches` counts the
    other)."""
    _check(qkv, n_heads, hb, dropout_rate)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {qkv.device}")
    want_grad = qkv.requires_grad and torch.is_grad_enabled()
    return _FlashAttentionPacked.apply(qkv, pad_mask, seed, n_heads, hb,
                                       float(dropout_rate), want_grad)


flash_attention_packed.launches = 0
flash_attention_packed.stats_launches = 0


def _flash_fwd_cuda(q, k, v, pad_mask, seed, n_heads: int, rate: float,
                    want_stats: bool):
    _check_cuda("flash_attention", q, k, v)
    b, l, d = q.shape
    _check_head_dim(d // n_heads)
    pad = _pad_arg(pad_mask, b, l, q.device)
    out = torch.empty_like(q)
    stats = (torch.empty((b, n_heads, l, 2), dtype=torch.float32,
                         device=q.device) if want_stats else None)
    _launch_fwd(q, k.data_ptr(), v.data_ptr(), pad, out, stats, n_heads,
                n_heads, d, 0, _lk_padded(l), seed, rate)
    flash_attention.launches += 1
    return out, stats


def flash_attention_bwd(q, k, v, pad_mask, seed: Optional[int], dout,
                        n_heads: int = 12, dropout_rate: float = 0.0,
                        stats: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of `flash_attention` for the cotangent dout [B, L, D].

    CPU tensors: `flash_attention_bwd_reference`.  CUDA tensors: the Hopper
    kernel, which also needs the forward kernel's softmax statistics
    `stats` [B, H, L, 2] (m, l)."""
    _check_split(q, k, v, n_heads)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, pad_mask, seed, dout,
                                             n_heads, dropout_rate)
    if stats is None:
        raise ValueError("the CUDA backward needs the forward kernel's "
                         "stats")
    _check_cuda("flash_attention_bwd", q, k, v, dout)
    b, l, d = q.shape
    _check_head_dim(d // n_heads)
    if (stats.dtype != torch.float32 or not stats.is_contiguous()
            or tuple(stats.shape) != (b, n_heads, l, 2)):
        raise ValueError(f"stats must be a contiguous fp32 [{b}, {n_heads}, "
                         f"{l}, 2]")
    pad = _pad_arg(pad_mask, b, l, q.device)
    delta = torch.empty((b, n_heads, l), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dh = d // n_heads
    fn = _bind("flash_attention_bwd", "mmoe_flash_attention_bwd",
               _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if pad is None else pad.data_ptr(),
                 dout.data_ptr(), stats.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, l, n_heads, dh, _lk_padded(l),
                 1.0 / math.sqrt(dh), *_dropout_args(seed, dropout_rate),
                 _stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_mask, seed, n_heads, dropout_rate):
        stats = None
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v, pad_mask, seed, n_heads,
                                            dropout_rate)
        else:
            out, stats = _flash_fwd_cuda(q, k, v, pad_mask, seed, n_heads,
                                         dropout_rate,
                                         any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, pad_mask, stats)
        ctx.seed, ctx.n_heads, ctx.rate = seed, n_heads, dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad_mask, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, pad_mask, ctx.seed,
                                         dout.contiguous(), ctx.n_heads,
                                         ctx.rate, stats)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    seed: Optional[int] = None, n_heads: int = 12,
                    dropout_rate: float = 0.0) -> torch.Tensor:
    """Self-attention over split q, k, v [B, L, D] -> [B, L, D], with
    attention-weight dropout keyed on `seed` (ignored at rate 0), and its
    backward.  CPU tensors: the plain versions.  CUDA tensors: the Hopper
    kernels, or an exception for what they do not take (see
    `flash_attention_packed`)."""
    _check_split(q, k, v, n_heads)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return _FlashAttention.apply(q, k, v, pad_mask, seed, n_heads,
                                 float(dropout_rate))


flash_attention.launches = 0
