"""ViT-base image encoder over pre-computed patch rows.

Port of mmoe_multimodal_rec_tpu/models/vit.py: the HF patch-embedding
Conv2d(3, 768, 16, 16) over the reconstructed image equals one Dense over
the stored (C, ph, pw) patch rows, so the encoder consumes [B, 196, 768]
directly.  Every layer's self-attention (L = 197, no mask) takes the
packed-qkv kernel when use_flash is set.  Dropout sits where the JAX
module has it (hidden_dropout after the position embedding, on the
attention and MLP outputs and inside the MLP; attention_dropout on the
weights); the ViT-base config sets both rates to 0.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ImageEncoderConfig
from .layers import (Attention, Dense, LayerNorm, Mlp, _trunc_normal_,
                     dropout, gelu_exact)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ImageEncoderConfig, dtype: torch.dtype,
                 use_flash: bool = False):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.attention = Attention(d, cfg.num_heads, use_flash, dtype,
                                   dropout=cfg.attention_dropout)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.mlp = Mlp(d, cfg.intermediate_size, d, gelu_exact, dtype,
                       cfg.hidden_dropout, cfg.hidden_dropout)
        self.dtype = dtype
        self.hidden_dropout = cfg.hidden_dropout

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.norm1(x).to(self.dtype)
        h = self.attention(h, h, h, None, deterministic=deterministic,
                           rng=rng)
        h = dropout(h, self.hidden_dropout, deterministic, rng)
        x = x + h.to(x.dtype)
        h = self.mlp(self.norm2(x).to(self.dtype), deterministic, rng)
        return x + h.to(x.dtype)


class ViTEncoder(nn.Module):
    """[B, 196, 768] normalized patch rows -> [B, 197, D] token states
    (CLS prepended), after the final LayerNorm."""

    def __init__(self, cfg: ImageEncoderConfig,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 remat: bool = False):
        super().__init__()
        if remat:
            raise NotImplementedError("model.remat (per-layer recompute) is "
                                      "not yet ported")
        d = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = Dense(cfg.patch_dim, d, dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, d))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ViTLayer(cfg, dtype, use_flash))
        self.final_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)

    def init_params(self, generator):
        # HF ViT: trunc-normal(0.02) cls/pos, not zeros
        _trunc_normal_(self.cls_token, 0.02, generator)
        _trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, patches: torch.Tensor, *, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(patches.to(self.dtype))
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = dropout(x, self.cfg.hidden_dropout, deterministic, rng)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, deterministic, rng)
        return self.final_norm(x)
