"""ViT-base image encoder over pre-computed patch rows, inference only.

Port of mmoe_multimodal_rec_tpu/models/vit.py: the HF patch-embedding
Conv2d(3, 768, 16, 16) over the reconstructed image equals one Dense over
the stored (C, ph, pw) patch rows, so the encoder consumes [B, 196, 768]
directly.  Every layer's self-attention (L = 197, no mask) takes the
packed-qkv kernel when use_flash is set.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import ImageEncoderConfig
from .layers import (Attention, Dense, LayerNorm, Mlp, _trunc_normal_,
                     gelu_exact)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ImageEncoderConfig, dtype: torch.dtype,
                 use_flash: bool = False):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.attention = Attention(d, cfg.num_heads, use_flash, dtype)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.mlp = Mlp(d, cfg.intermediate_size, d, gelu_exact, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x).to(self.dtype)
        h = self.attention(h, h, h, None)
        x = x + h.to(x.dtype)
        h = self.mlp(self.norm2(x).to(self.dtype))
        return x + h.to(x.dtype)


class ViTEncoder(nn.Module):
    """[B, 196, 768] normalized patch rows -> [B, 197, D] token states
    (CLS prepended), after the final LayerNorm."""

    def __init__(self, cfg: ImageEncoderConfig,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
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

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(patches.to(self.dtype))
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.final_norm(x)
