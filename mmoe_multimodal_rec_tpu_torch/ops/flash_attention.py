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
128), keep = bits >= uint32(rate * (2^32 - 1)); given the same seed the
masks equal JAX's bit for bit.  `dropout_keep_mask` writes it out as a bool
[b, h, lq, lk] tensor (the plain version `dropout_keep_mask_reference` on
the CPU, csrc/dropout_keep_mask.cu on a CUDA device); the plain versions
above use the plain mask.  Under tensor parallelism a rank holds heads
[h0, h0 + H) of H_total (`h_total`, `h0` of every function here): the
counter then takes the global head, b*H_total + h0 + h, so the rank's mask
is that slice of the whole call's; a data-parallel rank's batch offset is
folded into the seed by the caller (ops/lora_dropout.fold_seed).
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


def _head_range(n_heads: int, h_total: Optional[int], h0: int):
    """(H_total, h0) of a head shard: heads [h0, h0 + n_heads) of h_total
    (default: all of them), as the dropout counter strides over them."""
    h_total = n_heads if h_total is None else h_total
    if h0 < 0 or h0 + n_heads > h_total:
        raise ValueError(f"heads [{h0}, {h0 + n_heads}) are not a shard of "
                         f"{h_total}")
    return h_total, h0


def _shard_args(heads, n_heads: int) -> tuple:
    """The (h_total, h0) arguments to pass on: none for all the heads, so an
    unsharded call keeps the signature it had before head shards."""
    return () if heads == (n_heads, 0) else tuple(heads)


def dropout_keep_mask_reference(seed: int, b: int, h: int, lq: int, lk: int,
                                rate: float, lk_padded: Optional[int] = None,
                                *, device, h_total: Optional[int] = None,
                                h0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of `dropout_keep_mask`: the bool keep mask
    [b, h, lq, lk] of the portable stream, equal to JAX
    `dropout_keep_mask(..., interpret=True)` (the counter strides over the
    key length rounded up to 128, as there).  A head shard (heads
    [h0, h0 + h) of h_total) keys on the global head: its mask is that
    slice of the full one."""
    h_total, h0 = _head_range(h, h_total, h0)
    lk_p = lk_padded or (-(-lk // _LANE) * _LANE)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    idx = (((ar(b)[:, None] * h_total + h0 + ar(h)[None, :])
            * lq)[..., None, None] + ar(lq)[:, None]) * lk_p + ar(lk)[None, :]
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
                                     dropout_rate: float = 0.0,
                                     h_total: Optional[int] = None,
                                     h0: int = 0) -> torch.Tensor:
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
        keep = dropout_keep_mask_reference(seed or 0, b, n_heads, l, l,
                                           dropout_rate, l, device=qkv.device,
                                           h_total=h_total, h0=h0)
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
                              dropout_rate: float = 0.0,
                              h_total: Optional[int] = None,
                              h0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention`'s forward: fp32 softmax
    with padded keys at -1e9, the hash keep mask (q, k, v holding heads
    [h0, h0 + n_heads) of h_total), output in q's dtype."""
    _check_split(q, k, v, n_heads)
    b, l, d = q.shape
    p = _probs(q, k, pad_mask, n_heads)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask_reference(seed or 0, b, n_heads, l, l,
                                           dropout_rate, device=q.device,
                                           h_total=h_total, h0=h0)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    vh = v.float().reshape(b, l, n_heads, d // n_heads)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, l, d).to(q.dtype)


def _bwd_heads(qh, kh, vh, gh, pad_mask, seed: Optional[int],
               dropout_rate: float, dt, lk_pad: int,
               h_total: Optional[int] = None, h0: int = 0):
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
        keep = dropout_keep_mask_reference(seed or 0, b, n_heads, l, l,
                                           dropout_rate, lk_pad,
                                           device=qh.device, h_total=h_total,
                                           h0=h0)
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
                                  dropout_rate: float = 0.0,
                                  h_total: Optional[int] = None, h0: int = 0):
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
    grads = _bwd_heads(*heads, pad_mask, seed, dropout_rate, q.dtype,
                       _lk_padded(l), h_total, h0)
    return tuple(x.reshape(b, l, d).to(q.dtype) for x in grads)


def flash_attention_packed_bwd_reference(qkv, pad_mask, seed: Optional[int],
                                         dout, n_heads: int = 12, hb: int = 6,
                                         dropout_rate: float = 0.0,
                                         h_total: Optional[int] = None,
                                         h0: int = 0) -> torch.Tensor:
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
    grads = _bwd_heads(q, k, v, gh, pad_mask, seed, dropout_rate, qkv.dtype,
                       l, h_total, h0)
    return pack_qkv_weights(*(g.reshape(b, l, d) for g in grads), n_heads,
                            hb).to(qkv.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_FWD_ARGTYPES = [_P] * 6 + [_I] * 11 + [_F, _U, _U, _F, _I, _P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 8 + [_F, _U, _U, _F, _I, _P]
_PACKED_BWD_ARGTYPES = [_P] * 6 + [_I] * 9 + [_F, _U, _U, _F, _I, _P]
_KEEP_MASK_ARGTYPES = [_P, ctypes.c_longlong] + [_I] * 6 + [_U, _U, _P]


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


def _launch(what: str, device: torch.device, fn, *args) -> None:
    """fn(*args, stream): a kernel launched through its C interface on the
    current stream of `device` (a CUDA tensor's, so its index is set);
    raises with the CUDA error it returns.  The runtime launches on the
    calling thread's current device, so `device` is made current for the
    call only where it is not already.  The stream's handle comes straight
    from PyTorch's C API: building a torch.cuda.Stream for it, like
    entering torch.cuda.device, costs the host more than a short kernel
    takes on the card."""
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _launch_fwd(q, k_ptr: int, v_ptr: int, pad, out, stats, n_heads: int,
                hb: int, row_stride: int, group_stride: int, lk_pad: int,
                seed, rate: float, heads) -> None:
    """heads: (H_total, h0), the dropout counter's head stride and first
    head (the _*_fwd_cuda callers default it to all heads)."""
    b, l = q.shape[:2]
    dh = out.shape[-1] // n_heads
    fn = cuda_lib.function("flash_attention_fwd", "mmoe_flash_attention_fwd",
                           _FWD_ARGTYPES)
    _launch("flash attention forward", q.device, fn, q.data_ptr(), k_ptr,
            v_ptr, None if pad is None else pad.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            _DTYPE_CODES[q.dtype], b, l, n_heads, hb, dh, row_stride,
            group_stride, lk_pad, *heads, 1.0 / math.sqrt(dh),
            *_dropout_args(seed, rate))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _packed_fwd_cuda(qkv, pad_mask, seed, n_heads: int, hb: int,
                     rate: float, want_stats: bool, heads=None):
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
    heads = heads or (n_heads, 0)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty((b, heads[0], l, 2), dtype=torch.float32,
                         device=qkv.device) if want_stats else None)
    # the packed counter strides over L itself (dropout needs L % 128 == 0)
    _launch_fwd(qkv, qkv.data_ptr() + w, qkv.data_ptr() + 2 * w, pad, out,
                stats, n_heads, hb, d3, 3 * hb * dh, l, seed, rate, heads)
    flash_attention_packed.launches += 1
    flash_attention_packed.stats_launches += want_stats
    return out, stats


def flash_attention_packed_bwd(qkv, pad_mask, seed: Optional[int], dout,
                               n_heads: int = 12, hb: int = 6,
                               dropout_rate: float = 0.0,
                               stats: Optional[torch.Tensor] = None,
                               h_total: Optional[int] = None, h0: int = 0
                               ) -> torch.Tensor:
    """dqkv [B, L, 3D] of `flash_attention_packed`, in qkv's packed layout,
    for the cotangent dout [B, L, D]; h_total, h0 as the forward's.

    CPU tensors: `flash_attention_packed_bwd_reference`.  CUDA tensors: the
    Hopper kernel (bf16 only), which also needs the forward kernel's
    softmax statistics `stats` [B, H, L, 2] (m, l)."""
    _check(qkv, n_heads, hb, dropout_rate)
    heads = _head_range(n_heads, h_total, h0)
    if qkv.device.type == "cpu":
        return flash_attention_packed_bwd_reference(
            qkv, pad_mask, seed, dout, n_heads, hb, dropout_rate,
            *_shard_args(heads, n_heads))
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
            or tuple(stats.shape) != (b, heads[0], l, 2)):
        raise ValueError(f"stats must be a contiguous fp32 [{b}, "
                         f"{heads[0]}, {l}, 2]")
    pad = _pad_arg(pad_mask, b, l, qkv.device)
    delta = torch.empty((b, heads[0], l), dtype=torch.float32,
                        device=qkv.device)
    dqkv = torch.empty_like(qkv)
    fn = cuda_lib.function("flash_attention_bwd",
                           "mmoe_flash_attention_bwd_packed",
                           _PACKED_BWD_ARGTYPES)
    _launch("flash_attention_packed_bwd", qkv.device, fn, qkv.data_ptr(),
            None if pad is None else pad.data_ptr(), dout.data_ptr(),
            stats.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
            _DTYPE_CODES[qkv.dtype], b, l, n_heads, hb, dh, l, *heads,
            1.0 / math.sqrt(dh), *_dropout_args(seed, dropout_rate))
    flash_attention_packed_bwd.launches += 1
    return dqkv


flash_attention_packed_bwd.launches = 0


class _FlashAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, pad_mask, seed, n_heads, hb, dropout_rate,
                want_grad, heads):
        stats = None
        if qkv.device.type == "cpu":
            out = flash_attention_packed_reference(
                qkv, pad_mask, seed, n_heads, hb, dropout_rate,
                *_shard_args(heads, n_heads))
        else:
            out, stats = _packed_fwd_cuda(qkv, pad_mask, seed, n_heads, hb,
                                          dropout_rate, want_grad, heads)
        if want_grad:
            ctx.save_for_backward(qkv, pad_mask, stats)
        ctx.seed, ctx.n_heads, ctx.hb, ctx.rate, ctx.heads = (
            seed, n_heads, hb, dropout_rate, heads)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, pad_mask, stats = ctx.saved_tensors
        dqkv = flash_attention_packed_bwd(qkv, pad_mask, ctx.seed,
                                          dout.contiguous(), ctx.n_heads,
                                          ctx.hb, ctx.rate, stats,
                                          *_shard_args(ctx.heads,
                                                       ctx.n_heads))
        return dqkv, None, None, None, None, None, None, None


def flash_attention_packed(qkv: torch.Tensor,
                           pad_mask: Optional[torch.Tensor] = None,
                           seed: Optional[int] = None, n_heads: int = 12,
                           hb: int = 6, dropout_rate: float = 0.0,
                           h_total: Optional[int] = None, h0: int = 0
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
    other).  A tensor-parallel shard holds heads [h0, h0 + n_heads) of
    h_total (default: all): its dropout keys on the global head, so its
    mask is that slice of the full call's."""
    _check(qkv, n_heads, hb, dropout_rate)
    heads = _head_range(n_heads, h_total, h0)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {qkv.device}")
    want_grad = qkv.requires_grad and torch.is_grad_enabled()
    return _FlashAttentionPacked.apply(qkv, pad_mask, seed, n_heads, hb,
                                       float(dropout_rate), want_grad, heads)


flash_attention_packed.launches = 0
flash_attention_packed.stats_launches = 0


def _flash_fwd_cuda(q, k, v, pad_mask, seed, n_heads: int, rate: float,
                    want_stats: bool, heads=None):
    _check_cuda("flash_attention", q, k, v)
    b, l, d = q.shape
    _check_head_dim(d // n_heads)
    pad = _pad_arg(pad_mask, b, l, q.device)
    heads = heads or (n_heads, 0)
    out = torch.empty_like(q)
    stats = (torch.empty((b, heads[0], l, 2), dtype=torch.float32,
                         device=q.device) if want_stats else None)
    _launch_fwd(q, k.data_ptr(), v.data_ptr(), pad, out, stats, n_heads,
                n_heads, d, 0, _lk_padded(l), seed, rate, heads)
    flash_attention.launches += 1
    return out, stats


def flash_attention_bwd(q, k, v, pad_mask, seed: Optional[int], dout,
                        n_heads: int = 12, dropout_rate: float = 0.0,
                        stats: Optional[torch.Tensor] = None,
                        h_total: Optional[int] = None, h0: int = 0):
    """(dq, dk, dv) of `flash_attention` for the cotangent dout [B, L, D];
    h_total, h0 as the forward's (whose statistics are [B, h_total, L, 2]:
    a head shard's rows of the global heads').

    CPU tensors: `flash_attention_bwd_reference`.  CUDA tensors: the Hopper
    kernel, which also needs the forward kernel's softmax statistics
    `stats` [B, H, L, 2] (m, l)."""
    _check_split(q, k, v, n_heads)
    heads = _head_range(n_heads, h_total, h0)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, pad_mask, seed, dout,
                                             n_heads, dropout_rate,
                                             *_shard_args(heads, n_heads))
    if stats is None:
        raise ValueError("the CUDA backward needs the forward kernel's "
                         "stats")
    _check_cuda("flash_attention_bwd", q, k, v, dout)
    b, l, d = q.shape
    _check_head_dim(d // n_heads)
    if (stats.dtype != torch.float32 or not stats.is_contiguous()
            or tuple(stats.shape) != (b, heads[0], l, 2)):
        raise ValueError(f"stats must be a contiguous fp32 [{b}, "
                         f"{heads[0]}, {l}, 2]")
    pad = _pad_arg(pad_mask, b, l, q.device)
    delta = torch.empty((b, heads[0], l), dtype=torch.float32,
                        device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dh = d // n_heads
    fn = cuda_lib.function("flash_attention_bwd", "mmoe_flash_attention_bwd",
                           _BWD_ARGTYPES)
    _launch("flash_attention_bwd", q.device, fn, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if pad is None else pad.data_ptr(),
            dout.data_ptr(), stats.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], b, l, n_heads, dh, _lk_padded(l), *heads,
            1.0 / math.sqrt(dh), *_dropout_args(seed, dropout_rate))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad_mask, seed, n_heads, dropout_rate, heads):
        stats = None
        if q.device.type == "cpu":
            out = flash_attention_reference(q, k, v, pad_mask, seed, n_heads,
                                            dropout_rate,
                                            *_shard_args(heads, n_heads))
        else:
            out, stats = _flash_fwd_cuda(q, k, v, pad_mask, seed, n_heads,
                                         dropout_rate,
                                         any(ctx.needs_input_grad[:3]), heads)
        ctx.save_for_backward(q, k, v, pad_mask, stats)
        ctx.seed, ctx.n_heads, ctx.rate, ctx.heads = (seed, n_heads,
                                                      dropout_rate, heads)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad_mask, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, pad_mask, ctx.seed,
                                         dout.contiguous(), ctx.n_heads,
                                         ctx.rate, stats,
                                         *_shard_args(ctx.heads, ctx.n_heads))
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    seed: Optional[int] = None, n_heads: int = 12,
                    dropout_rate: float = 0.0, h_total: Optional[int] = None,
                    h0: int = 0) -> torch.Tensor:
    """Self-attention over split q, k, v [B, L, D] -> [B, L, D], with
    attention-weight dropout keyed on `seed` (ignored at rate 0), and its
    backward.  CPU tensors: the plain versions.  CUDA tensors: the Hopper
    kernels, or an exception for what they do not take (see
    `flash_attention_packed`, also for h_total and h0)."""
    _check_split(q, k, v, n_heads)
    heads = _head_range(n_heads, h_total, h0)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return _FlashAttention.apply(q, k, v, pad_mask, seed, n_heads,
                                 float(dropout_rate), heads)


flash_attention.launches = 0


def dropout_keep_mask(seed: int, b: int, h: int, lq: int, lk: int,
                      rate: float, lk_padded: Optional[int] = None, *,
                      device, h_total: Optional[int] = None,
                      h0: int = 0) -> torch.Tensor:
    """Bool keep mask [b, h, lq, lk] of the portable stream (JAX
    `dropout_keep_mask(..., interpret=True)`), made on `device`: the CPU
    takes `dropout_keep_mask_reference`; a CUDA device launches the Hopper
    kernel (csrc/dropout_keep_mask.cu), which writes the same bits, or
    raises.  The short attentions' weight dropout draws it in every
    training forward (models/layers._dot_product_attention).  h_total, h0:
    the h heads are [h0, h0 + h) of h_total (a tensor-parallel shard)."""
    h_total, h0 = _head_range(h, h_total, h0)
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cpu":
        return dropout_keep_mask_reference(seed, b, h, lq, lk, rate,
                                           lk_padded=lk_padded, device=device,
                                           h_total=h_total, h0=h0)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    out = torch.empty((b, h, lq, lk), dtype=torch.bool, device=device)
    if out.numel() == 0:
        return out
    fn = cuda_lib.function("dropout_keep_mask", "mmoe_dropout_keep_mask",
                           _KEEP_MASK_ARGTYPES)
    _launch("dropout_keep_mask", out.device, fn, out.data_ptr(), b * h * lq,
            lk, lk_padded or _lk_padded(lk), h, lq, h_total, h0, seed & _M32,
            _threshold(rate))
    dropout_keep_mask.launches += 1
    return out


dropout_keep_mask.launches = 0
