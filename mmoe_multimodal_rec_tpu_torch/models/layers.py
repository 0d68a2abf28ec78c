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

Remat (`model.remat`, models/layers.resolve_remat_policy in JAX): an
encoder layer under a policy runs through `remat_layer`, one
autograd.Function that keeps only the layer input, the dropout seeds and
the tensors the policy names (`attn_res`, the int8/int4 `quant_save`s)
and recomputes the rest in its backward.  The seeds are drawn once, in the
first forward, onto a `SeedTape` that the recompute replays: the kernels
launch through ctypes and draw from an explicit generator, so neither
torch.utils.checkpoint's RNG restore nor dispatcher-level selective
checkpointing would see them.

Parameters follow the JAX tree's names (utils/convert.py maps `kernel`
[in, out] to `weight` [out, in], `scale`/`embedding` to `weight`), and every
module that owns parameters has `init_params(generator)` reproducing the
flax initializers' distributions; `init_weights` applies them all.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import (KERNEL_HEAD_DIMS, _head_group,
                                   _lk_padded, dropout_keep_mask,
                                   flash_attention, flash_attention_packed,
                                   pack_qkv_weights)
from ..ops.lora_dropout import (fold_seed, hash_keep_mask,
                                lora_dropout_matmul, lora_fused_ok)
from ..parallel.mesh import (Axis, DataShard, copy_to_model,
                             reduce_from_model, sum_over_data)

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
    from the micro-batch's generator (never from global state), or the
    next seed of a `SeedTape`."""
    if isinstance(rng, SeedTape):
        return rng.draw()
    if isinstance(rng, DataShard):
        rng = rng.generator
    if rng is None:
        raise ValueError("a training forward (deterministic=False) needs "
                         "rng, the micro-batch's torch.Generator")
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng))


def data_axis(rng) -> Optional[Axis]:
    """The mesh's `data` axis of a data-parallel training forward (`rng` a
    parallel.mesh.DataShard, or a SeedTape over one) when it has more than
    one rank, else None: the forward holds the whole micro-batch."""
    if isinstance(rng, SeedTape):
        rng = rng.rng
    if isinstance(rng, DataShard) and rng.axis.size > 1:
        return rng.axis
    return None


def hash_dropout(x: torch.Tensor, rate: float, seed: int, offset: int = 0,
                 width: Optional[int] = None, col0: int = 0) -> torch.Tensor:
    """models/layers.HashDropout with an explicit seed: x / (1 - rate) where
    kept, 0 elsewhere, in x's dtype.  `offset`: the flat index of x's first
    element in the global array (a data-parallel shard's rows, folded into
    the seed); `width`, `col0`: x holds columns [col0, col0 + D) of rows
    `width` wide (a tensor-parallel shard), so it keys on
    row*width + col0 + col."""
    keep = hash_keep_mask(x.shape, fold_seed(seed, offset), rate, x.device,
                          width, col0)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            rng: Optional[torch.Generator],
            cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One HashDropout site: identity at rate 0 or deterministic (no seed is
    drawn then, as flax draws none), else `hash_dropout` on a fresh seed.
    In a data-parallel forward x's leading axis is the rank's equal share
    of the global one, so its global flat offset is rank * x.numel() (rows
    of `cols` = (width, col0) when x is a column shard)."""
    if rate == 0.0 or deterministic:
        return x
    seed = draw_seed(rng)
    data = data_axis(rng)
    width, col0 = cols if cols is not None else (None, 0)
    rows_numel = x.numel() if width is None else \
        x.numel() // x.shape[-1] * width
    offset = data.rank * rows_numel if data is not None else 0
    return hash_dropout(x, rate, seed, offset, width, col0)


class SeedTape:
    """The dropout seeds of one recomputed stretch of a layer: drawn from
    the micro-batch's generator in call order during the first forward,
    and replayed in the same order by each recompute (`replay`).  The tape
    holds the draws; a data-parallel site folds its global offset into
    its draw each time it runs (`dropout`, `data_axis`), the same offset in
    the first forward and in the recompute."""

    def __init__(self, rng: Optional[torch.Generator]):
        self.rng = rng
        self.seeds = []
        self.pos = None

    def draw(self) -> int:
        if self.pos is None:
            self.seeds.append(draw_seed(self.rng))
            return self.seeds[-1]
        self.pos += 1
        return self.seeds[self.pos - 1]

    def replay(self) -> "SeedTape":
        self.pos = 0
        return self


class RematPolicy(NamedTuple):
    """The checkpoint names a remat policy saves, as JAX's
    `save_only_these_names` lists them."""
    names: Tuple[str, ...]

    def quant_bits(self, name: str) -> int:
        """8 or 4 where the policy saves `name` quantised, else 0."""
        for bits in (8, 4):
            if f"{name}_q{bits}" in self.names:
                return bits
        return 0


_QKV_SAVES = ("q_q8", "q_sc", "k_q8", "k_sc", "v_q8", "v_sc", "qkv_q8",
              "qkv_sc")
REMAT_POLICIES = {
    "full": RematPolicy(()),
    "dots": None,
    "attn": RematPolicy(("attn_res",)),
    "quant": RematPolicy(("attn_res",) + _QKV_SAVES + ("fc1_q8", "fc1_sc")),
    "quant4": RematPolicy(("attn_res",) + _QKV_SAVES + ("fc1_q4", "fc1_sc")),
    "quant_fc1": RematPolicy(("attn_res", "fc1_q8", "fc1_sc")),
}


def resolve_remat_policy(name: str) -> Optional[RematPolicy]:
    """models/layers.resolve_remat_policy: what an encoder layer under
    `name` saves for its backward; the rest is recomputed.
    - "full": nothing (the layer input only);
    - "attn": the post-attention residual `attn_res`;
    - "quant": "attn" plus per-row int8 saves of q/k/v (qkv on the packed
      path) and of the fc1 preactivation; the training forward consumes
      their dequantised values, and the backward restores them instead of
      recomputing the projections;
    - "quant4": "quant" with the fc1 save packed to int4;
    - "quant_fc1": "attn" plus the int8 fc1 save.
    "dots" (save every product's output) returns None: the port runs such
    a layer without recompute, which keeps every activation the backward
    needs, so its numerics are JAX's and its memory is larger."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}")
    return REMAT_POLICIES[name]


class _ValueWithGradTo(torch.autograd.Function):
    """Returns `value`; the gradient flows unchanged to `x` (straight
    through), as models/layers._value_with_grad_to."""

    @staticmethod
    def forward(ctx, value, x):
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        return None, g


def quantize(x: torch.Tensor, bits: int = 8, axis: Optional[Axis] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantisation of x [..., n] as JAX's quant_save:
    (q int8, scale fp32 [..., 1]).  int8: scale = rowmax|x| / 127.  int4:
    scale = rowmax|x| / 7, and the column halves pack two to a byte,
    `lo & 0x0F | hi << 4` ([..., n/2]).  Rounds half to even after a true
    division by the scale, as jnp.round(x / sc) does.

    `axis`: the model axis when x is a column shard of a tensor-parallel
    layer's output.  Each row's max |x| is then the max over the axis (one
    [..., 1] fp32 all-reduce MAX in the axis's process group, issued by
    every rank of it, one rank included), so every shard divides by the
    whole row's scale, as JAX's max over a sharded last axis does.  int4
    pairs the halves of the rank's own columns: the packed layout differs
    from one process's, the dequantised values do not."""
    x32 = x.detach().float()
    amax = x32.abs().amax(-1, keepdim=True)
    if axis is not None and axis.group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=axis.group)
    sc = (amax / (127.0 if bits == 8 else 7.0)).clamp_min(1e-12)
    q = torch.round(x32 / sc).to(torch.int8)
    if bits == 8:
        return q, sc
    if bits != 4:
        raise ValueError(f"quantize: bits must be 8 or 4, got {bits}")
    n = q.shape[-1]
    if n % 2:
        raise ValueError(f"int4 packing needs an even last dim, got {n}")
    return (q[..., :n // 2] & 0x0F) | (q[..., n // 2:] << 4), sc


def dequantize(q: torch.Tensor, sc: torch.Tensor, bits: int,
               dtype: torch.dtype) -> torch.Tensor:
    """The value `quantize` saved, in `dtype`; int4 nibbles come back by
    arithmetic shifts."""
    if bits == 4:
        q = torch.cat([(q << 4) >> 4, q >> 4], dim=-1)
    return (q.float() * sc).to(dtype)


def quant_save(x: torch.Tensor, bits: int = 8, axis: Optional[Axis] = None):
    """models/layers.quant_save: (the dequantised value, whose gradient
    passes unchanged to x, and the saved (q, scale)); `axis` as
    `quantize`'s."""
    q, sc = quantize(x, bits, axis)
    return _ValueWithGradTo.apply(dequantize(q, sc, bits, x.dtype), x), (q, sc)


class _Restored(torch.autograd.Function):
    """A quantised save restored in the recompute: the forward returns the
    dequantised value and runs no product; the backward sends the gradient
    to what JAX's straight-through reaches, the exact projection
    y = x W^T + b (+ delta): dx = g W, dW = g^T x, db = sum g, and g to the
    LoRA delta."""

    @staticmethod
    def forward(ctx, value, x, w, b, delta):
        ctx.save_for_backward(x, w)
        ctx.has_delta = delta is not None
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[1]:
            dx = g @ w
        if ctx.needs_input_grad[2]:
            dw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        if ctx.needs_input_grad[3]:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return None, dx, dw, db, (g if ctx.has_delta else None)


class RematState:
    """One remat-ted layer's saves and seeds.  The first forward (no
    autograd graph) quantises at the named points and keeps the saves; the
    recompute (`restoring`) takes them back: `restore` stands for a saved
    projection, so its product does not run again."""

    def __init__(self, policy: RematPolicy, rng, deterministic: bool):
        self.policy = policy
        # JAX quantises only in a training forward (bert.py:146-149)
        self.quantises = not deterministic
        self.tapes = (SeedTape(rng), SeedTape(rng))
        self.saved: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self.restoring = False

    def bits(self, name: str) -> int:
        return self.policy.quant_bits(name) if self.quantises else 0

    def save(self, name: str, y: torch.Tensor,
             axis: Optional[Axis] = None) -> torch.Tensor:
        """First forward: keep y quantised; the layer goes on with the
        dequantised value (its gradient straight through to y, for a
        forward that autograd records).  `axis`: the model axis y's
        columns are split over (tensor parallelism), whose ranks reduce
        each row's scale together; the recompute restores and issues no
        collective here."""
        bits = self.bits(name)
        if not bits:
            return y
        value, self.saved[name] = quant_save(y, bits, axis)
        return value

    def restore(self, name: str, x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, delta: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Recompute: the saved value of y = F.linear(x, w, b) (+ delta),
        its gradient routed as the exact y's."""
        q, sc = self.saved[name]
        value = dequantize(q, sc, self.bits(name), x.dtype)
        return _Restored.apply(value, x, w, b, delta)


class _LayerRecompute(torch.autograd.Function):
    """One encoder layer, `feed(attend(x))`, under a remat policy.  The
    forward runs it without a graph and saves x, `attn_res` = attend(x)
    where the policy names it, and the quantised saves.  The backward
    rebuilds the graph with the saves put back and the seeds replayed:
    with `attn_res` saved, first feed from it and then attend from x (the
    two recomputed graphs never live together); without, the whole layer
    from x.  Returns the gradients of x and of `params`, the layer's
    parameters that need one."""

    @staticmethod
    def forward(ctx, attend, feed, state, x, *params):
        a = attend(x, state.tapes[0], state)
        out = feed(a, state.tapes[1], state)
        ctx.keep_res = "attn_res" in state.policy.names
        ctx.names = sorted(state.saved)
        ctx.attend, ctx.feed, ctx.state, ctx.params = attend, feed, state, \
            params
        ctx.save_for_backward(
            x, *((a,) if ctx.keep_res else ()),
            *(t for n in ctx.names for t in state.saved[n]))
        state.saved = {}
        return out

    @staticmethod
    def backward(ctx, g):
        state, params = ctx.state, list(ctx.params)
        x, *rest = ctx.saved_tensors
        if ctx.keep_res:
            a, *rest = rest
        state.saved = {n: (rest[2 * i], rest[2 * i + 1])
                       for i, n in enumerate(ctx.names)}
        state.restoring = True
        want_x = ctx.needs_input_grad[3]
        with torch.enable_grad():
            xi = x.detach().requires_grad_(want_x)
            wrt = ([xi] if want_x else []) + params
            if ctx.keep_res:
                ai = a.detach().requires_grad_(True)
                out = ctx.feed(ai, state.tapes[1].replay(), state)
                ga, *late = torch.autograd.grad(out, [ai] + params, g,
                                                allow_unused=True)
                res = ctx.attend(xi, state.tapes[0].replay(), state)
                grads = torch.autograd.grad(res, wrt, ga, allow_unused=True)
            else:
                out = ctx.feed(ctx.attend(xi, state.tapes[0].replay(), state),
                               state.tapes[1].replay(), state)
                grads = torch.autograd.grad(out, wrt, g, allow_unused=True)
                late = [None] * len(params)
        state.saved = {}
        gx = grads[0] if want_x else None
        gp = grads[1:] if want_x else grads
        return (None, None, None, gx,
                *(b if a is None else a if b is None else a + b
                  for a, b in zip(gp, late)))


def remat_layer(attend: Callable, feed: Callable, policy: RematPolicy,
                params, x: torch.Tensor, deterministic: bool, rng
                ) -> torch.Tensor:
    """`feed(attend(x))` under `policy`, where attend(x, rng, remat) ->
    attn_res and feed(attn_res, rng, remat) -> the layer's output.  When
    autograd needs nothing from the layer (eval, or a frozen layer whose
    input needs no gradient) there is nothing to recompute: the layer runs
    once, still quantising at the named points in a training forward, as
    the JAX forward does whatever the backward keeps."""
    params = [p for p in params if p.requires_grad]
    state = RematState(policy, rng, deterministic)
    if not torch.is_grad_enabled() or not (x.requires_grad or params):
        return feed(attend(x, rng, state), rng, state)
    return _LayerRecompute.apply(attend, feed, state, x, *params)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """GELU as models/layers.gelu_exact: the exact erf form in fp32, the
    tanh form in bf16 (below bf16's resolution, and cheaper)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


class Dense(nn.Module):
    """flax nn.Dense(dtype=...) over fp32 params: y = x W^T + b with x, W
    and b cast to the compute dtype first.

    Under tensor parallelism (`shard`, parallel/mesh.shard_model) the layer
    is "col" (this rank's rows of W and b: y's column shard, x fed through
    `copy_to_model`) or "row" (this rank's columns of W, x a column shard;
    the partial products summed by `reduce_from_model`, then the whole bias
    added once)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias_init: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.dtype = dtype
        self.bias_init = bias_init
        self.parallel: Optional[str] = None
        self.axis: Optional[Axis] = None

    def shard(self, parallel: str, axis: Axis) -> None:
        self.parallel, self.axis = parallel, axis

    def init_params(self, generator):
        # lecun_normal: truncated normal, std sqrt(1/fan_in) / .8796...
        _trunc_normal_(self.weight, math.sqrt(1.0 / self.weight.shape[1])
                       / .87962566103423978, generator)
        with torch.no_grad():
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self.parallel == "col":
            return F.linear(copy_to_model(x.to(self.dtype), self.axis), w, b)
        if self.parallel == "row":
            return reduce_from_model(F.linear(x.to(self.dtype), w),
                                     self.axis) + b
        return F.linear(x.to(self.dtype), w, b)


class LoRADense(nn.Module):
    """A q/k/v projection with its LoRA adapter kept apart:
    y = x W + b + (alpha/r) drop(x) A B, peft semantics.  Params as
    ProjParams lays them out: base/{weight, bias}, lora_a [in, r],
    lora_b [r, out]; with `sides` = 2 (the shared-base text encoder,
    models/text_expert.DualTextExpert) side-stacked lora_a [2, in, r] and
    lora_b [2, r, out] over one base.

    The LoRA input dropout, as the JAX `drop_matmul`: with `fused_dropout`
    set and a shape `lora_fused_ok` admits, `lora_dropout_matmul` (the
    fused kernels on a CUDA tensor, their plain versions on a CPU one);
    otherwise HashDropout followed by the thin matmul.  Both branches draw
    one seed and key the same mask on it; they differ only in rounding
    (the fused one multiplies by 1/(1-rate) rounded to the compute dtype
    and rounds dA to it, as the JAX kernels do).  Under tensor parallelism
    the base is column-parallel, lora_b a column shard and lora_a whole:
    t = drop(x) A goes through `copy_to_model`, so its gradient, and with
    it dA and the dropped input's gradient, is whole on every rank."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, fused_dropout: bool = False,
                 sides: int = 1):
        super().__init__()
        if sides not in (1, 2):
            raise ValueError(f"LoRADense takes 1 or 2 sides, got {sides}")
        side = () if sides == 1 else (sides,)
        self.base = Dense(in_features, out_features, dtype)
        self.lora_a = nn.Parameter(torch.empty(*side, in_features, rank))
        self.lora_b = nn.Parameter(torch.empty(*side, rank, out_features))
        self.sides = sides
        self.scale = alpha / rank
        self.dtype = dtype
        self.dropout = dropout
        self.fused_dropout = fused_dropout

    def init_params(self, generator):
        bound = 1.0 / math.sqrt(self.lora_a.shape[-2])
        with torch.no_grad():
            self.lora_a.uniform_(-bound, bound, generator=generator)
            self.lora_b.zero_()

    def delta(self, x: torch.Tensor, deterministic: bool = True,
              rng: Optional[torch.Generator] = None,
              split: int = 0) -> torch.Tensor:
        """(alpha/r) drop(x) A B.  Two sides fold into ONE rank-2r chain,
        as JAX layers.py:431-455: t = drop(x) [A0 | A1], then rows of x
        before `split` keep only t's first r columns and the other rows
        only its last r (which also zeroes the other side's gradients),
        then t @ [B0; B1]."""
        h = x.to(self.dtype)
        a = self.lora_a.to(self.dtype)
        b = self.lora_b.to(self.dtype)
        if self.sides == 2:
            r = a.shape[-1]
            a = torch.cat([a[0], a[1]], dim=-1)
            b = b.reshape(2 * r, -1)
        if (self.fused_dropout and not deterministic and self.dropout > 0.0
                and lora_fused_ok(h, a)):
            data = data_axis(rng)
            seed = fold_seed(draw_seed(rng),
                             data.rank * h.numel() if data else 0)
            t = lora_dropout_matmul(h.reshape(-1, h.shape[-1]).contiguous(),
                                    a, seed, self.dropout)
            t = t.reshape(h.shape[:-1] + (a.shape[-1],))
        else:
            t = dropout(h, self.dropout, deterministic, rng) @ a
        if self.base.parallel == "col":
            # lora_a is whole on every rank and lora_b a column shard: t's
            # gradient sums over the shards, which makes dA and dh whole
            t = copy_to_model(t, self.base.axis)
        if self.sides == 2:
            rows = torch.arange(h.shape[0], device=h.device) >= split
            cols = torch.arange(2 * r, device=h.device) >= r
            keep = (rows[:, None] == cols[None, :]).reshape(
                (h.shape[0],) + (1,) * (h.dim() - 2) + (2 * r,))
            t = torch.where(keep, t, torch.zeros((), dtype=t.dtype,
                                                 device=t.device))
        return self.scale * (t @ b)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[torch.Generator] = None,
                split: int = 0) -> torch.Tensor:
        return self.base(x) + self.delta(x, deterministic, rng, split)


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
                           seed: Optional[int] = None,
                           h_total: Optional[int] = None,
                           h0: int = 0) -> torch.Tensor:
    """Plain attention in head-split layout q,k,v [B, L, H, Dh]; pad_mask
    [B, Lk] True = pad.  Scores in the compute dtype, softmax in fp32;
    dropout on the weights (rate > 0) with the attention counter hash, its
    mask from `dropout_keep_mask` (on a CUDA tensor the Hopper kernel), the
    H heads being [h0, h0 + H) of h_total."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1).to(dtype)
    if rate > 0.0:
        b, lq, h, _ = q.shape
        keep = dropout_keep_mask(seed, b, h, lq, k.shape[1], rate,
                                 device=q.device, h_total=h_total, h0=h0)
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
    dropout, value's, then the attention weights'.

    `lora_sides` = 2: side-stacked adapters (LoRADense); the forward's
    `lora_split` rows of the [N, L, D] input take side 0's.  `remat`, a
    layer's RematState under a quantising policy: the first forward saves
    q/k/v (qkv on the packed path) quantised and goes on with their
    dequantised values; the recompute restores them without the
    projections' products.

    Under tensor parallelism (`shard`) q/k/v are column-parallel and `out`
    row-parallel: the rank attends over its heads [h0, h0 + num_heads) of
    `h_total`, and the attention dropout keys on the global head.  In a
    data-parallel forward the batch offset of the rank's rows is folded
    into that seed (`_attention_seed`)."""

    def __init__(self, d: int, num_heads: int, use_flash: bool = False,
                 dtype: torch.dtype = torch.float32, lora_rank: int = 0,
                 lora_alpha: float = 32.0,
                 lora_targets: tuple = ("query", "value"),
                 dropout: float = 0.0, lora_dropout: float = 0.1,
                 lora_fused_dropout: bool = True, lora_sides: int = 1):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d={d} is not a multiple of heads={num_heads}")
        self.num_heads = num_heads
        self.h_total, self.h0 = num_heads, 0
        self.use_flash = use_flash
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.dropout = dropout

        def proj(name):
            if lora_rank > 0 and name in lora_targets:
                return LoRADense(d, d, lora_rank, lora_alpha, dtype,
                                 lora_dropout, lora_fused_dropout,
                                 lora_sides)
            return Dense(d, d, dtype)

        self.query, self.key, self.value = (proj(n) for n in
                                            ("query", "key", "value"))
        self.out = Dense(d, d, dtype)

    def _base(self, name: str) -> Dense:
        mod = getattr(self, name)
        return mod.base if isinstance(mod, LoRADense) else mod

    def query_parallel(self) -> bool:
        """Whether parallel/mesh.shard_model made q column-parallel."""
        return self._base("query").parallel == "col"

    def shard(self, axis: Axis) -> None:
        """Attend over this rank's heads of the model axis; q/k/v and out
        are sharded by shard_model (their Dense.shard)."""
        local = self.h_total // axis.size
        self.num_heads, self.h0 = local, axis.rank * local

    def _attention_seed(self, rng, b: int, lq: int, lk_pad: int) -> int:
        """The attention dropout's seed: a fresh draw, with a data-parallel
        rank's batch offset (rank * b rows of h_total*lq*lk_pad counters)
        folded in."""
        seed = draw_seed(rng)
        data = data_axis(rng)
        if data is None:
            return seed
        return fold_seed(seed, data.rank * b * self.h_total * lq * lk_pad)

    def forward(self, query, key, value,
                pad_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None,
                lora_split: int = 0,
                remat: Optional[RematState] = None) -> torch.Tensor:
        b, l, _ = query.shape
        restoring = remat is not None and remat.restoring
        # the model axis of a tensor-parallel layer's q/k/v column shards
        axis = self._base("query").axis if self.query_parallel() else None
        h = self.num_heads
        head_dim = self._base("query").weight.shape[0] // h
        # the head shard's arguments, passed only on a shard
        heads = ({} if self.h_total == h else
                 dict(h_total=self.h_total, h0=self.h0))
        rate = self.dropout if not deterministic else 0.0
        self_attn = query is key and key is value
        if (self.use_flash and self_attn and self.lora_rank == 0
                and _flash_ok(query, head_dim, rate)):
            hb = _head_group(head_dim, h, max_heads=6)
            w_g = pack_qkv_weights(self.query.weight.t(), self.key.weight.t(),
                                   self.value.weight.t(), h, hb)
            b_g = pack_qkv_weights(self.query.bias, self.key.bias,
                                   self.value.bias, h, hb)
            xw = (copy_to_model(query.to(self.dtype), axis)
                  if axis is not None else query.to(self.dtype),
                  w_g.t().to(self.dtype), b_g.to(self.dtype))
            if restoring and remat.bits("qkv"):
                qkv = remat.restore("qkv", *xw)
            else:
                qkv = F.linear(*xw)
                if remat is not None:
                    qkv = remat.save("qkv", qkv, axis)
            seed = (self._attention_seed(rng, b, l, l) if rate > 0.0
                    else None)
            return self.out(flash_attention_packed(qkv, pad_mask, seed, h,
                                                   hb, rate, **heads))

        def project(mod, x, name):
            lora = isinstance(mod, LoRADense)
            if restoring and remat.bits(name):
                base = mod.base if lora else mod
                delta = (mod.delta(x, deterministic, rng, lora_split)
                         if lora else None)
                xin = x.to(self.dtype)
                if axis is not None:
                    xin = copy_to_model(xin, axis)
                return remat.restore(name, xin, base.weight.to(self.dtype),
                                     base.bias.to(self.dtype), delta)
            if lora:
                return mod(x, deterministic, rng, lora_split)
            return mod(x)

        q = project(self.query, query, "q")
        k = project(self.key, key, "k")
        v = project(self.value, value, "v")
        if remat is not None and not restoring:
            q, k, v = (remat.save(n, t, axis)
                       for n, t in zip("qkv", (q, k, v)))
        flash = self.use_flash and _flash_ok(q, head_dim, rate)
        seed = (self._attention_seed(rng, b, q.shape[1],
                                     _lk_padded(k.shape[1]))
                if rate > 0.0 else None)
        if flash:
            out = flash_attention(q, k, v, pad_mask, seed, h, rate, **heads)
        else:
            split = lambda x: x.reshape(b, -1, h, head_dim)
            out = _dot_product_attention(split(q), split(k), split(v),
                                         pad_mask, self.dtype, rate, seed,
                                         **heads).reshape(b, l, -1)
        return self.out(out)


class Mlp(nn.Module):
    """linear -> act -> dropout -> linear (-> output dropout).  Under tensor
    parallelism (`shard`: fc1 column-, fc2 row-parallel) the inner dropout
    runs on the rank's column shard of the hidden units and keys on their
    global columns."""

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
        self.cols: Optional[Tuple[int, int]] = None

    def shard(self, axis: Axis) -> None:
        local = self.fc1.weight.shape[0]
        self.cols = (local * axis.size, local * axis.rank)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[torch.Generator] = None,
                remat: Optional[RematState] = None) -> torch.Tensor:
        """`remat`: as Attention's, for the fc1 preactivation."""
        fc1 = self.fc1
        axis = fc1.axis if fc1.parallel == "col" else None
        if remat is not None and remat.restoring and remat.bits("fc1"):
            h = x.to(fc1.dtype)
            if axis is not None:
                h = copy_to_model(h, axis)
            x = remat.restore("fc1", h, fc1.weight.to(fc1.dtype),
                              fc1.bias.to(fc1.dtype))
        else:
            x = fc1(x)
            if remat is not None:
                x = remat.save("fc1", x, axis)
        x = dropout(self.activation(x), self.dropout, deterministic, rng,
                    self.cols)
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

    def forward(self, x: torch.Tensor, use_running_average: bool = True,
                data: Optional[Axis] = None) -> torch.Tensor:
        """`data`: the mesh's data axis of a data-parallel forward, whose
        batch statistics then span the global micro-batch (sums over data,
        with their gradients), so every rank moves the running ones alike."""
        x32 = x.float()
        if use_running_average:
            mean, var = self.mean, self.var
        elif data is not None:
            rows = x32.reshape(-1, x32.shape[-1])
            n = rows.shape[0] * data.size
            mean = sum_over_data(rows.sum(0), data) / n
            var = sum_over_data((rows - mean).square().sum(0), data) / n
        else:
            rows = x32.reshape(-1, x32.shape[-1])
            n = rows.shape[0]
            mean = rows.mean(0)
            var = rows.var(0, unbiased=False)
        if not use_running_average:
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
        return (y + self.bias.float()).to(self.dtype)
