"""Core neural layers shared by every expert (inference only).

Port of mmoe_multimodal_rec_tpu/models/layers.py.  Numerics follow the
flax modules there: every Dense casts its input and fp32 params to the
compute dtype, LayerNorm takes its statistics in fp32 and defaults to
flax's epsilon 1e-6 (not torch's 1e-5), masks use the finite -1e9.
`pad_mask` is True at PADDED positions (torch key_padding_mask).
Dropout is identity at inference, so this slice has none.

Parameters follow the JAX tree's names (utils/convert.py maps `kernel`
[in, out] to `weight` [out, in], `scale`/`embedding` to `weight`), and every
module that owns parameters has `init_params(generator)` reproducing the
flax initializers' distributions; `init_weights` applies them all.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import (KERNEL_HEAD_DIMS, _head_group,
                                   flash_attention_packed, pack_qkv_weights)

NEG_INF = -1e9  # finite mask value: keeps bf16 softmax NaN-free on all-pad rows


def _trunc_normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std (jax truncated_normal), by the
    inverse CDF of a uniform draw."""
    c = math.erf(math.sqrt(2.0))
    with torch.no_grad():
        t.uniform_(-c, c, generator=generator).erfinv_().mul_(
            std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    return t


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of `model` from `generator`, module by
    module in registration order."""
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)
    return model


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """GELU as models/layers.gelu_exact: the exact erf form in fp32, the
    tanh form in bf16 (below bf16's resolution, and cheaper)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


class Dense(nn.Module):
    """flax nn.Dense(dtype=...) over fp32 params: y = x W^T + b with x, W
    and b cast to the compute dtype first."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias_init: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.dtype = dtype
        self.bias_init = bias_init

    def init_params(self, generator):
        # lecun_normal: truncated normal, std sqrt(1/fan_in) / .8796...
        _trunc_normal_(self.weight, math.sqrt(1.0 / self.weight.shape[1])
                       / .87962566103423978, generator)
        with torch.no_grad():
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LoRADense(nn.Module):
    """A q/k/v projection with its LoRA adapter kept apart, at inference:
    y = x W + b + (alpha/r) (x A) B.  Params as ProjParams lays them out:
    base/{weight, bias}, lora_a [in, r], lora_b [r, out]."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.base = Dense(in_features, out_features, dtype)
        self.lora_a = nn.Parameter(torch.empty(in_features, rank))
        self.lora_b = nn.Parameter(torch.empty(rank, out_features))
        self.scale = alpha / rank
        self.dtype = dtype

    def init_params(self, generator):
        bound = 1.0 / math.sqrt(self.lora_a.shape[0])
        with torch.no_grad():
            self.lora_a.uniform_(-bound, bound, generator=generator)
            self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.to(self.dtype) @ self.lora_a.to(self.dtype)
        return self.base(x) + self.scale * (t @ self.lora_b.to(self.dtype))


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: fp32 statistics whatever the input dtype, output
    in `dtype`, epsilon 1e-6 unless given."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.eps = eps
        self.dtype = dtype

    def init_params(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)


class Embed(nn.Module):
    """flax nn.Embed: rows ~ N(0, 1/features), looked up then cast."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.dtype = dtype

    def init_params(self, generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


def _dot_product_attention(q, k, v, pad_mask: Optional[torch.Tensor],
                           dtype: torch.dtype) -> torch.Tensor:
    """Plain attention in head-split layout q,k,v [B, L, H, Dh]; pad_mask
    [B, Lk] True = pad.  Scores in the compute dtype, softmax in fp32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _flash_ok(q: torch.Tensor, head_dim: int) -> bool:
    """models/layers._flash_ok without its TPU test: long enough rows for
    the kernel to pay, and a head dim the kernel is built for (the JAX gate
    admits dh % 128 in (0, 64); the Hopper kernel takes 64 and 128)."""
    return head_dim in KERNEL_HEAD_DIMS and q.shape[-2] >= 128


class Attention(nn.Module):
    """Multi-head attention over [B, L, D], torch MultiheadAttention parity
    (bias on q/k/v/out).  Self-attention with use_flash, no LoRA and a
    shape `_flash_ok` admits runs ONE [D, 3D] projection in the packed
    column order and the packed kernel; everything else runs per-projection
    matmuls and plain attention."""

    def __init__(self, d: int, num_heads: int, use_flash: bool = False,
                 dtype: torch.dtype = torch.float32, lora_rank: int = 0,
                 lora_alpha: float = 32.0,
                 lora_targets: tuple = ("query", "value")):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d={d} is not a multiple of heads={num_heads}")
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dtype = dtype
        self.lora_rank = lora_rank

        def proj(name):
            if lora_rank > 0 and name in lora_targets:
                return LoRADense(d, d, lora_rank, lora_alpha, dtype)
            return Dense(d, d, dtype)

        self.query, self.key, self.value = (proj(n) for n in
                                            ("query", "key", "value"))
        self.out = Dense(d, d, dtype)

    def forward(self, query, key, value,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, d = query.shape
        h = self.num_heads
        head_dim = d // h
        self_attn = query is key and key is value
        if (self.use_flash and self_attn and self.lora_rank == 0
                and _flash_ok(query, head_dim)):
            hb = _head_group(head_dim, h, max_heads=6)
            w_g = pack_qkv_weights(self.query.weight.t(), self.key.weight.t(),
                                   self.value.weight.t(), h, hb)
            b_g = pack_qkv_weights(self.query.bias, self.key.bias,
                                   self.value.bias, h, hb)
            qkv = F.linear(query.to(self.dtype), w_g.t().to(self.dtype),
                           b_g.to(self.dtype))
            out = flash_attention_packed(qkv, pad_mask, None, h, hb, 0.0)
        else:
            split = lambda x: x.reshape(b, -1, h, head_dim)
            out = _dot_product_attention(
                split(self.query(query)), split(self.key(key)),
                split(self.value(value)), pad_mask, self.dtype
            ).reshape(b, l, d)
        return self.out(out)


class Mlp(nn.Module):
    """linear -> act -> linear."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, dtype)
        self.fc2 = Dense(hidden, out, dtype)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.activation(self.fc1(x)))


class PreNormBlock(nn.Module):
    """Pre-norm transformer encoder layer (torch
    TransformerEncoderLayer(norm_first=True)): x += SA(LN1(x));
    x += FF(LN2(x)), ReLU feed-forward."""

    def __init__(self, d: int, num_heads: int, mlp_ratio: int = 4,
                 use_flash: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(d, dtype=dtype)
        self.self_attn = Attention(d, num_heads, use_flash, dtype)
        self.norm2 = LayerNorm(d, dtype=dtype)
        self.mlp = Mlp(d, mlp_ratio * d, d, F.relu, dtype)
        self.dtype = dtype

    def forward(self, x, pad_mask: Optional[torch.Tensor] = None):
        h = self.norm1(x)
        h = self.self_attn(h, h, h, pad_mask)
        x = x + h.to(x.dtype)
        h = self.mlp(self.norm2(x).to(self.dtype))
        return x + h.to(x.dtype)


class AttnPool1D(nn.Module):
    """Learnable-query attention pooling: scores = q.x / sqrt(d), -1e9 at
    padded rows, fp32 softmax, weighted sum."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query = nn.Parameter(torch.empty(d))
        self.dtype = dtype

    def init_params(self, generator):
        with torch.no_grad():
            self.query.normal_(0.0, self.query.shape[0] ** -0.5,
                               generator=generator)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor):
        d = x.shape[-1]
        scores = torch.einsum("d,bld->bl", self.query.to(self.dtype),
                              x.to(self.dtype)) / math.sqrt(d)
        scores = scores.masked_fill(pad_mask, NEG_INF)
        w = torch.softmax(scores.float(), dim=-1)
        return torch.einsum("bl,bld->bd", w.to(self.dtype), x)
