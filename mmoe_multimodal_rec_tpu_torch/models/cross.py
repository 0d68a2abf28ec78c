"""Cross-interaction experts.

Port of mmoe_multimodal_rec_tpu/models/cross.py:
- RobustTextCrossExpert: per-side pre-norm self-attention over sentence
  vectors, user->item cross attention, scalar-gated residual blend,
  attention pooling, and (baseline only) an LN + residual MLP head
  (ref model.py:386-451 / model_HoME.py:401-466).
- EnhancedCrossFuse: two vectors as a length-2 sequence through pre-norm
  layers, gated blend, residual projection, and (baseline only) a final
  LN/Linear/GELU (ref model.py:454-507 / model_HoME.py:469-522).
Their attention rows are short (64 sentences, 2 tokens), so it stays plain,
with its dropout on the attention counter hash.  Every dropout rate is the
model's `dropout`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (Attention, AttnPool1D, Dense, LayerNorm, Mlp,
                     PreNormBlock, dropout, gelu_exact)


class RobustTextCrossExpert(nn.Module):
    """`final_mlp` (baseline, ref model.py:450-451): LN + residual MLP on the
    pooled vector; HoME returns the raw pooled vector and guards the
    all-masked user row (`pool_nan_guard`, model_HoME.py:466)."""

    def __init__(self, d: int, n_layers: int = 2, n_heads: int = 8,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 dropout: float = 0.1, final_mlp: bool = True,
                 pool_nan_guard: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.dtype = dtype
        for side in ("user", "item"):
            for i in range(n_layers):
                self.add_module(f"self_{side}_{i}",
                                PreNormBlock(d, n_heads, use_flash=use_flash,
                                             dtype=dtype, dropout=dropout))
        self.cross_attn = Attention(d, n_heads, use_flash, dtype,
                                    dropout=dropout)
        self.gate = nn.Parameter(torch.empty(1))
        self.pool = AttnPool1D(d, dtype, dropout, pool_nan_guard)
        self.final_mlp = final_mlp
        if final_mlp:
            self.norm = LayerNorm(d, dtype=dtype)
            self.mlp = Mlp(d, 4 * d, d, gelu_exact, dtype, dropout, dropout)

    def init_params(self, generator):
        with torch.no_grad():
            self.gate.fill_(0.5)  # pre-sigmoid (ref model.py:411)

    def forward(self, user_vecs, user_mask, item_vecs, item_mask, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        kw = dict(deterministic=deterministic, rng=rng)
        for i in range(self.n_layers):
            user_vecs = getattr(self, f"self_user_{i}")(user_vecs, user_mask,
                                                        **kw)
        for i in range(self.n_layers):
            item_vecs = getattr(self, f"self_item_{i}")(item_vecs, item_mask,
                                                        **kw)
        cross_out = self.cross_attn(user_vecs, item_vecs, item_vecs,
                                    item_mask, **kw)
        alpha = torch.sigmoid(self.gate.float()).to(user_vecs.dtype)
        fused = alpha * user_vecs + (1.0 - alpha) * cross_out.to(
            user_vecs.dtype)
        pooled = self.pool(fused, user_mask, **kw)
        if not self.final_mlp:
            return pooled
        normed = self.norm(pooled).to(self.dtype)
        return normed + self.mlp(normed, deterministic, rng)


class EnhancedCrossFuse(nn.Module):
    """`final_proj` (baseline, ref model.py:507): LN/Linear/GELU/dropout on
    the fused + residual sum; HoME returns the sum (model_HoME.py:522)."""

    def __init__(self, d: int, depth: int = 2, n_heads: int = 8,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 final_proj: bool = True):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        self.dropout = dropout
        self.res_proj = Dense(2 * d, d, dtype)
        self.res_norm = LayerNorm(d, dtype=dtype)
        for i in range(depth):
            self.add_module(f"layer_{i}", PreNormBlock(d, n_heads,
                                                       dtype=dtype,
                                                       dropout=dropout))
        self.gate_fc1 = Dense(2 * d, d // 2, dtype)
        self.gate_fc2 = Dense(d // 2, 1, dtype, bias_init=0.5)
        self.final_proj = final_proj
        if final_proj:
            self.proj_norm = LayerNorm(d, dtype=dtype)
            self.proj_fc = Dense(d, d, dtype)

    def forward(self, v_cls: torch.Tensor, t_cls: torch.Tensor, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        identity = self.res_norm(self.res_proj(
            torch.cat([v_cls, t_cls], dim=-1))).to(self.dtype)
        x = torch.stack([v_cls, t_cls], dim=1)  # [B, 2, D]
        for i in range(self.depth):
            x = getattr(self, f"layer_{i}")(x, None,
                                            deterministic=deterministic,
                                            rng=rng)
        v_fused, t_fused = x[:, 0], x[:, 1]
        # Linear(2d, d/2) -> GELU -> Linear(d/2, 1, bias=0.5) -> sigmoid
        g = torch.sigmoid(self.gate_fc2(gelu_exact(self.gate_fc1(
            torch.cat([v_fused, t_fused], dim=-1)))))
        fused = g * v_fused + (1.0 - g) * t_fused
        if not self.final_proj:
            return fused + identity
        out = self.proj_norm(fused + identity)
        return dropout(gelu_exact(self.proj_fc(out.to(self.dtype))),
                       self.dropout, deterministic, rng)
