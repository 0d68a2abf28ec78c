"""Core neural layers shared by every expert.

Port of mmoe_multimodal_rec_tpu/models/layers.py.  Numerics follow the
flax modules there: every Dense casts its input and fp32 params to the
compute dtype, LayerNorm takes its statistics in fp32 and defaults to
flax's epsilon 1e-6 (not torch's 1e-5), masks use the finite -1e9.
`pad_mask` is True at PADDED positions (torch key_padding_mask).

Dropout: every forward takes `deterministic` (True: the serving path, no
dropout) and `rng`, the micro-batch's torch.Generator.  Each dropout site
draws its int32 seed from `rng` in call order (`draw_seed`), and every mask
is the JAX package's portable counter hash: `hash_dropout` keys it on the
flat index row*D + col of reshape(-1, D), as HashDropout does; attention
weights key it on ((b*H + h)*Lq + q)*Lk_pad + k, as the attention kernels
do.  Given the same seeds, the masks equal JAX's bit for bit, except on
the einsum attention path, where JAX draws `jax.random.bernoulli` bits that
torch cannot reproduce and the port uses the attention counter hash.

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
                                   dropout_keep_mask, flash_attention,
                                   flash_attention_packed, pack_qkv_weights)
from ..ops.lora_dropout import (hash_keep_mask, lora_dropout_matmul,
                                lora_fused_ok)

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


def draw_seed(rng: Optional[torch.Generator]) -> int:
    """One dropout site's int32 seed in [0, 2^31 - 1), as JAX draws it,
    from the micro-batch's generator (never from global state)."""
    if rng is None:
        raise ValueError("a training forward (deterministic=False) needs "
                         "rng, the micro-batch's torch.Generator")
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng))


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """models/layers.HashDropout with an explicit seed: x / (1 - rate) where
    kept, 0 elsewhere, in x's dtype."""
    keep = hash_keep_mask(x.shape, seed, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """One HashDropout site: identity at rate 0 or deterministic (no seed is
    drawn then, as flax draws none), else `hash_dropout` on a fresh seed."""
    if rate == 0.0 or deterministic:
        return x
    return hash_dropout(x, rate, draw_seed(rng))


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
    """A q/k/v projection with its LoRA adapter kept apart:
    y = x W + b + (alpha/r) drop(x) A B, peft semantics.  Params as
    ProjParams lays them out: base/{weight, bias}, lora_a [in, r],
    lora_b [r, out].

    The LoRA input dropout, as the JAX `drop_matmul`: with `fused_dropout`
    set and a shape `lora_fused_ok` admits, `lora_dropout_matmul` (the
    fused kernels on a CUDA tensor, their plain versions on a CPU one);
    otherwise HashDropout followed by the thin matmul.  Both branches draw
    one seed and key the same mask on it; they differ only in rounding
    (the fused one multiplies by 1/(1-rate) rounded to the compute dtype
    and rounds dA to it, as the JAX kernels do)."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, fused_dropout: bool = False):
        super().__init__()
        self.base = Dense(in_features, out_features, dtype)
        self.lora_a = nn.Parameter(torch.empty(in_features, rank))
        self.lora_b = nn.Parameter(torch.empty(rank, out_features))
        self.scale = alpha / rank
        self.dtype = dtype
        self.dropout = dropout
        self.fused_dropout = fused_dropout

    def init_params(self, generator):
        bound = 1.0 / math.sqrt(self.lora_a.shape[0])
        with torch.no_grad():
            self.lora_a.uniform_(-bound, bound, generator=generator)
            self.lora_b.zero_()

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.base(x)
        h = x.to(self.dtype)
        a = self.lora_a.to(self.dtype)
        if (self.fused_dropout and not deterministic and self.dropout > 0.0
                and lora_fused_ok(h, a)):
            t = lora_dropout_matmul(h.reshape(-1, h.shape[-1]).contiguous(),
                                    a, draw_seed(rng), self.dropout)
            t = t.reshape(h.shape[:-1] + (a.shape[-1],))
        else:
            t = dropout(h, self.dropout, deterministic, rng) @ a
        return y + self.scale * (t @ self.lora_b.to(self.dtype))


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
                           dtype: torch.dtype, rate: float = 0.0,
                           seed: Optional[int] = None) -> torch.Tensor:
    """Plain attention in head-split layout q,k,v [B, L, H, Dh]; pad_mask
    [B, Lk] True = pad.  Scores in the compute dtype, softmax in fp32;
    dropout on the weights (rate > 0) with the attention counter hash."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(dtype)
    if rate > 0.0:
        b, lq, h, _ = q.shape
        keep = dropout_keep_mask(seed, b, h, lq, k.shape[1], rate,
                                 device=q.device)
        weights = torch.where(keep, weights / (1.0 - rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _flash_ok(q: torch.Tensor, head_dim: int, rate: float = 0.0) -> bool:
    """models/layers._flash_ok without its TPU test: long enough rows for
    the kernel to pay, a head dim the kernel is built for (the JAX gate
    admits dh % 128 in (0, 64); the Hopper kernel takes 64 and 128) and,
    with dropout, at most 512 rows (JAX's one q block)."""
    lq = q.shape[-2]
    if rate > 0.0 and lq > 512:
        return False
    return head_dim in KERNEL_HEAD_DIMS and lq >= 128


class Attention(nn.Module):
    """Multi-head attention over [B, L, D], torch MultiheadAttention parity
    (bias on q/k/v/out, dropout on the attention weights).  Self-attention
    with use_flash, no LoRA and a shape `_flash_ok` admits runs ONE [D, 3D]
    projection in the packed column order and the packed kernel; with LoRA,
    the per-projection path takes the split kernel (`flash_attention`,
    forward and backward) where `_flash_ok` admits the shape, and plain
    attention elsewhere.  Seeds are drawn in the order: query's LoRA
    dropout, value's, then the attention weights'."""

    def __init__(self, d: int, num_heads: int, use_flash: bool = False,
                 dtype: torch.dtype = torch.float32, lora_rank: int = 0,
                 lora_alpha: float = 32.0,
                 lora_targets: tuple = ("query", "value"),
                 dropout: float = 0.0, lora_dropout: float = 0.1,
                 lora_fused_dropout: bool = True):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d={d} is not a multiple of heads={num_heads}")
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.dropout = dropout

        def proj(name):
            if lora_rank > 0 and name in lora_targets:
                return LoRADense(d, d, lora_rank, lora_alpha, dtype,
                                 lora_dropout, lora_fused_dropout)
            return Dense(d, d, dtype)

        self.query, self.key, self.value = (proj(n) for n in
                                            ("query", "key", "value"))
        self.out = Dense(d, d, dtype)

    def forward(self, query, key, value,
                pad_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        b, l, d = query.shape
        h = self.num_heads
        head_dim = d // h
        rate = self.dropout if not deterministic else 0.0
        self_attn = query is key and key is value
        if (self.use_flash and self_attn and self.lora_rank == 0
                and _flash_ok(query, head_dim, rate)):
            hb = _head_group(head_dim, h, max_heads=6)
            w_g = pack_qkv_weights(self.query.weight.t(), self.key.weight.t(),
                                   self.value.weight.t(), h, hb)
            b_g = pack_qkv_weights(self.query.bias, self.key.bias,
                                   self.value.bias, h, hb)
            qkv = F.linear(query.to(self.dtype), w_g.t().to(self.dtype),
                           b_g.to(self.dtype))
            seed = draw_seed(rng) if rate > 0.0 else None
            return self.out(flash_attention_packed(qkv, pad_mask, seed, h,
                                                   hb, rate))

        def project(mod, x):
            if isinstance(mod, LoRADense):
                return mod(x, deterministic, rng)
            return mod(x)

        q = project(self.query, query)
        k = project(self.key, key)
        v = project(self.value, value)
        seed = draw_seed(rng) if rate > 0.0 else None
        if self.use_flash and _flash_ok(q, head_dim, rate):
            out = flash_attention(q, k, v, pad_mask, seed, h, rate)
        else:
            split = lambda x: x.reshape(b, -1, h, head_dim)
            out = _dot_product_attention(split(q), split(k), split(v),
                                         pad_mask, self.dtype, rate, seed
                                         ).reshape(b, l, d)
        return self.out(out)


class Mlp(nn.Module):
    """linear -> act -> dropout -> linear (-> output dropout)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 out_dropout: float = 0.0):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, dtype)
        self.fc2 = Dense(hidden, out, dtype)
        self.activation = activation
        self.dropout = dropout
        self.out_dropout = out_dropout

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.activation(self.fc1(x)), self.dropout,
                    deterministic, rng)
        return dropout(self.fc2(x), self.out_dropout, deterministic, rng)


class PreNormBlock(nn.Module):
    """Pre-norm transformer encoder layer (torch
    TransformerEncoderLayer(norm_first=True)): x += drop(SA(LN1(x)));
    x += FF(LN2(x)), ReLU feed-forward with dropout inside and after."""

    def __init__(self, d: int, num_heads: int, mlp_ratio: int = 4,
                 use_flash: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.norm1 = LayerNorm(d, dtype=dtype)
        self.self_attn = Attention(d, num_heads, use_flash, dtype,
                                   dropout=dropout)
        self.norm2 = LayerNorm(d, dtype=dtype)
        self.mlp = Mlp(d, mlp_ratio * d, d, F.relu, dtype, dropout, dropout)
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, x, pad_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        h = self.norm1(x)
        h = self.self_attn(h, h, h, pad_mask, deterministic=deterministic,
                           rng=rng)
        h = dropout(h, self.dropout, deterministic, rng)
        x = x + h.to(x.dtype)
        h = self.mlp(self.norm2(x).to(self.dtype), deterministic, rng)
        return x + h.to(x.dtype)


class AttnPool1D(nn.Module):
    """Learnable-query attention pooling: scores = q.x / sqrt(d), -1e9 at
    padded rows, fp32 softmax, dropout on the weights, weighted sum.
    `nan_guard` adds HoME's all-masked-row fix (ref model_HoME.py:210-211):
    a row whose every position is padded pools to zeros."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1, nan_guard: bool = False):
        super().__init__()
        self.query = nn.Parameter(torch.empty(d))
        self.dtype = dtype
        self.dropout = dropout
        self.nan_guard = nan_guard

    def init_params(self, generator):
        with torch.no_grad():
            self.query.normal_(0.0, self.query.shape[0] ** -0.5,
                               generator=generator)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        d = x.shape[-1]
        scores = torch.einsum("d,bld->bl", self.query.to(self.dtype),
                              x.to(self.dtype)) / math.sqrt(d)
        scores = scores.masked_fill(pad_mask, NEG_INF)
        w = torch.softmax(scores.float(), dim=-1)
        if self.nan_guard:
            w = w.masked_fill(pad_mask.all(-1, keepdim=True), 0.0)
        w = dropout(w, self.dropout, deterministic, rng)
        return torch.einsum("bl,bld->bd", w.to(self.dtype), x)


class BatchNorm1D(nn.Module):
    """torch BatchNorm1d semantics over the flattened rows of x [..., D],
    as models/layers.BatchNorm1D: fp32 statistics; with
    `use_running_average` the running mean/var normalise, else the batch's
    (biased variance) do and the running ones move by `momentum` towards
    the batch mean and the UNBIASED batch variance, in place.  The running
    statistics are buffers (`mean`, `var`: the JAX `batch_stats`
    collection); `weight`/`bias` are the JAX `scale`/`bias`."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype

    def init_params(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = True) -> torch.Tensor:
        x32 = x.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            rows = x32.reshape(-1, x32.shape[-1])
            n = rows.shape[0]
            mean = rows.mean(0)
            var = rows.var(0, unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
        return (y + self.bias.float()).to(self.dtype)
