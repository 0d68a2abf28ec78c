"""Fused LoRA-input dropout and thin matmul: `t = (keep ⊙ h·inv) @ A`
without the dropped `h` ever being written.

Port of mmoe_multimodal_rec_tpu/ops/lora_dropout.py.  Three functions under
one torch.autograd.Function (`lora_dropout_matmul`):

  forward  t  = (keep ⊙ h·inv) @ A        `lora_dropout_fwd`   [M, r]
  bwd dA      = (keep ⊙ h·inv)^T @ dt     `lora_dropout_da`    [D, r]
  bwd dh      = keep ⊙ (dt @ A^T)·inv     `lora_dropout_dh`    [M, D]

with h [M, D], A [D, r] of one dtype, fp32 accumulation, `inv` = 1/(1-rate)
in h's dtype for the dropped input and in fp32 for dh, t and dh in h's
dtype and dA in A's (the JAX `_vjp_bwd` casts it so).  The backward runs
dA only when A needs a gradient and dh only when h does, as XLA drops a
dead output.

The keep mask is HashDropout's: the murmur3-finalizer hash of the flat
index row*D + col, keep = bits >= uint32(rate * (2^32 - 1)) —
`hash_keep_mask`, which models/layers.hash_dropout uses too.  The JAX
kernels key it on block*bm*D + local index, the same flat index whatever
the block size, so given the same int32 seed every mask here equals JAX's
interpret-mode mask bit for bit.

Every wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (`*_reference`), a CUDA tensor launches the
hand-written Hopper kernel (csrc/lora_dropout.cu, built by ops/cuda_lib.py
at first use) or raises.  `<wrapper>.launches` counts kernel launches
(`lora_dropout_da`: one per call, which runs its partial-sum and its
reduction kernels).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_lib
from .flash_attention import _M32, _threshold

_LANE = 128
_DA_ROWS_PER_BLOCK = 256   # rows each dA block sums before the reduction
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _i32(u: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return u - (1 << 32) if u >= (1 << 31) else u


def hash_keep_mask(shape, seed: int, rate: float, device) -> torch.Tensor:
    """HashDropout's keep mask: the murmur3-finalizer hash of the flat
    index (row*D + col of reshape(-1, D)), keep = bits >= uint32(rate *
    (2^32 - 1)).  Computed in place in int32, whose products wrap mod 2^32
    as the uint32 ones do; shifts are masked to be logical and the final
    compare is made unsigned by flipping the sign bit."""
    x = torch.arange(math.prod(shape), dtype=torch.int32, device=device)
    x.mul_(_i32(2654435761)).add_(_i32(seed & _M32))
    x.bitwise_xor_((x >> 16) & 0xFFFF)
    x.mul_(_i32(0x85EBCA6B))
    x.bitwise_xor_((x >> 13) & 0x7FFFF)
    x.mul_(_i32(0xC2B2AE35))
    x.bitwise_xor_((x >> 16) & 0xFFFF)
    x.bitwise_xor_(_i32(0x80000000))
    return (x >= _i32(_threshold(rate) ^ 0x80000000)).reshape(shape)


def lora_fused_ok(h: torch.Tensor, a: torch.Tensor) -> bool:
    """ops/lora_dropout.lora_fused_ok without its TPU test and its row
    term: a lane-aligned D of at most 4096 and r at most 512.  The Hopper
    kernels mask a ragged last row block, so any M is taken (JAX's gate
    also asks M to split into 256..2048-row blocks).  Outside the gate
    both packages take the unfused HashDropout branch, with the same mask
    and math."""
    d, r = h.shape[-1], a.shape[-1]
    return d % _LANE == 0 and d <= 4096 and r <= 512


def _check(name: str, x: torch.Tensor, a: torch.Tensor) -> None:
    if x.dim() != 2 or a.dim() != 2:
        raise ValueError(f"{name}: expects 2-D operands, got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    if x.dtype != a.dtype:
        raise ValueError(f"{name}: operands must share a dtype, got "
                         f"{x.dtype} and {a.dtype}")


def _dropped(h: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """keep ⊙ h·inv with inv in h's dtype, 0 where dropped."""
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=h.dtype)
    keep = hash_keep_mask(h.shape, seed, rate, h.device)
    return torch.where(keep, h * inv.to(h.device), 0.0)


def lora_dropout_fwd_reference(h, a, seed: int, rate: float) -> torch.Tensor:
    """Plain PyTorch version of `lora_dropout_fwd` (JAX `_fwd_kernel`)."""
    _check("lora_dropout_fwd", h, a)
    return (_dropped(h, seed, rate).float() @ a.float()).to(h.dtype)


def lora_dropout_da_reference(h, dt, seed: int, rate: float) -> torch.Tensor:
    """Plain PyTorch version of `lora_dropout_da` (JAX `_da_kernel`, cast
    to A's dtype as `_vjp_bwd` does)."""
    _check("lora_dropout_da", h, dt)
    return (_dropped(h, seed, rate).float().t() @ dt.float()).to(h.dtype)


def lora_dropout_dh_reference(dt, a, seed: int, rate: float) -> torch.Tensor:
    """Plain PyTorch version of `lora_dropout_dh` (JAX `_dh_kernel`)."""
    _check("lora_dropout_dh", dt, a)
    g = dt.float() @ a.float().t()
    keep = hash_keep_mask(g.shape, seed, rate, g.device)
    return torch.where(keep, g * (1.0 / (1.0 - rate)), 0.0).to(a.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_ARGTYPES = {
    "mmoe_lora_dropout_fwd": [_P] * 3 + [_I] * 4 + [_U, _U, _F, _P],
    "mmoe_lora_dropout_da": [_P] * 4 + [_I] * 5 + [_U, _U, _F, _P],
    "mmoe_lora_dropout_dh": [_P] * 3 + [_I] * 4 + [_U, _U, _F, _P],
}


def _bind(fn_name: str):
    fn = getattr(cuda_lib.load("lora_dropout"), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, x: torch.Tensor, a: torch.Tensor) -> None:
    """What the kernels refuse: a dtype other than bf16/fp32, operands on
    two devices, non-contiguous or misaligned tensors, a D that is not a
    whole number of 16-byte vectors."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: kernel takes bfloat16 or float32, got "
                        f"{x.dtype}")
    if a.device != x.device:
        raise ValueError(f"{name}: operands on {x.device} and {a.device}")
    for t in (x, a):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")


def _launch(fn_name: str, device, *args) -> None:
    with torch.cuda.device(device):
        err = _bind(fn_name)(*args,
                             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def _mask_args(seed: int, rate: float):
    return seed & _M32, _threshold(rate)


def _h_scale(dtype, rate: float) -> float:
    """1/(1-rate) rounded to h's dtype, as the JAX kernels multiply by it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _on_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor; False for a CPU one (the plain version);
    raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def lora_dropout_fwd(h: torch.Tensor, a: torch.Tensor, seed: int,
                     rate: float) -> torch.Tensor:
    """t = (keep ⊙ h·inv) @ A, [M, r] in h's dtype (TPU kernel #4)."""
    _check("lora_dropout_fwd", h, a)
    if not _on_device(h):
        return lora_dropout_fwd_reference(h, a, seed, rate)
    _check_cuda("lora_dropout_fwd", h, a)
    (m, d), r = h.shape, a.shape[1]
    if a.shape[0] != d or d % 8:
        raise ValueError(f"lora_dropout_fwd: h {tuple(h.shape)} and A "
                         f"{tuple(a.shape)} do not chain, or D % 8 != 0")
    t = torch.empty((m, r), dtype=h.dtype, device=h.device)
    _launch("mmoe_lora_dropout_fwd", h.device, h.data_ptr(), a.data_ptr(),
            t.data_ptr(), _DTYPE_CODES[h.dtype], m, d, r,
            *_mask_args(seed, rate), _h_scale(h.dtype, rate))
    lora_dropout_fwd.launches += 1
    return t


lora_dropout_fwd.launches = 0


def lora_dropout_da(h: torch.Tensor, dt: torch.Tensor, seed: int,
                    rate: float) -> torch.Tensor:
    """dA = (keep ⊙ h·inv)^T @ dt, summed in fp32 over all M rows, [D, r]
    in h's dtype (TPU kernel #5).  On the card: per-block fp32 partials,
    then a reduction over the blocks in a fixed order (no atomics)."""
    _check("lora_dropout_da", h, dt)
    if not _on_device(h):
        return lora_dropout_da_reference(h, dt, seed, rate)
    _check_cuda("lora_dropout_da", h, dt)
    (m, d), r = h.shape, dt.shape[1]
    if dt.shape[0] != m or d % 8:
        raise ValueError(f"lora_dropout_da: h {tuple(h.shape)} and dt "
                         f"{tuple(dt.shape)} differ in rows, or D % 8 != 0")
    nblk = -(-m // _DA_ROWS_PER_BLOCK)
    partial = torch.empty((nblk, d, r), dtype=torch.float32, device=h.device)
    da = torch.empty((d, r), dtype=h.dtype, device=h.device)
    _launch("mmoe_lora_dropout_da", h.device, h.data_ptr(), dt.data_ptr(),
            partial.data_ptr(), da.data_ptr(), _DTYPE_CODES[h.dtype], m, d, r,
            _DA_ROWS_PER_BLOCK, *_mask_args(seed, rate),
            _h_scale(h.dtype, rate))
    lora_dropout_da.launches += 1
    return da


lora_dropout_da.launches = 0


def lora_dropout_dh(dt: torch.Tensor, a: torch.Tensor, seed: int,
                    rate: float) -> torch.Tensor:
    """dh = keep ⊙ (dt @ A^T)·inv, [M, D] in A's dtype (TPU kernel #6)."""
    _check("lora_dropout_dh", dt, a)
    if not _on_device(dt):
        return lora_dropout_dh_reference(dt, a, seed, rate)
    _check_cuda("lora_dropout_dh", dt, a)
    (m, r), d = dt.shape, a.shape[0]
    if a.shape[1] != r or d % 8:
        raise ValueError(f"lora_dropout_dh: dt {tuple(dt.shape)} and A "
                         f"{tuple(a.shape)} differ in r, or D % 8 != 0")
    dh = torch.empty((m, d), dtype=a.dtype, device=a.device)
    _launch("mmoe_lora_dropout_dh", a.device, dt.data_ptr(), a.data_ptr(),
            dh.data_ptr(), _DTYPE_CODES[a.dtype], m, d, r,
            *_mask_args(seed, rate), 1.0 / (1.0 - rate))
    lora_dropout_dh.launches += 1
    return dh


lora_dropout_dh.launches = 0


class _LoRADropoutMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, a, seed, rate):
        ctx.save_for_backward(h, a)
        ctx.seed, ctx.rate = seed, rate
        return lora_dropout_fwd(h, a, seed, rate)

    @staticmethod
    def backward(ctx, dt):
        h, a = ctx.saved_tensors
        dt = dt.to(h.dtype).contiguous()
        dh = da = None
        if ctx.needs_input_grad[1]:
            da = lora_dropout_da(h, dt, ctx.seed, ctx.rate)
        if ctx.needs_input_grad[0]:
            dh = lora_dropout_dh(dt, a, ctx.seed, ctx.rate)
        return dh, da, None, None


def lora_dropout_matmul(h: torch.Tensor, a: torch.Tensor, seed: int,
                        rate: float = 0.1) -> torch.Tensor:
    """`(keep(seed) ⊙ h / (1-rate)) @ a` without materializing the dropped
    `h`, and its backward.  h [M, D], a [D, r] of one dtype, seed an int32
    (JAX's draw); returns [M, r] in h's dtype.  Gate call sites with
    `lora_fused_ok`."""
    _check("lora_dropout_matmul", h, a)
    _on_device(h)
    return _LoRADropoutMatmul.apply(h, a, int(seed), float(rate))
