"""Image experts over native patch rows.

Port of mmoe_multimodal_rec_tpu/models/image_expert.py: ItemImageExpert
(baseline) and ImageExpertWithProjection (HoME).  ImageNet
normalization runs on the device over the uint8 (C, ph, pw) rows; samples
with has_image = 0 enter the ViT as exact zeros.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ImageEncoderConfig
from .layers import LayerNorm, Mlp, dropout, gelu_exact
from .vit import ViTEncoder

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_patches(patches_u8: torch.Tensor,
                      has_image: torch.Tensor) -> torch.Tensor:
    """[B, 196, 768] uint8 + [B] {0,1} -> normalized float32 patch rows."""
    dev = patches_u8.device
    # per-channel stats expanded to the (C, 16, 16) row
    mean = torch.tensor(_IMAGENET_MEAN, device=dev).repeat_interleave(256)
    std = torch.tensor(_IMAGENET_STD, device=dev).repeat_interleave(256)
    x = (patches_u8.float() / 255.0 - mean) / std
    return torch.where(has_image[:, None, None] > 0, x, 0.0)


class ItemImageExpert(nn.Module):
    """ViT -> mean/cls pool -> LN -> dropout (ref model.py:343-385)."""

    def __init__(self, cfg: ImageEncoderConfig,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 dropout: float = 0.1, remat: bool = False,
                 remat_policy: str = "dots"):
        super().__init__()
        self.backbone = ViTEncoder(cfg, dtype, use_flash, remat, remat_policy)
        self.norm = LayerNorm(cfg.hidden_size, dtype=dtype)
        self.pool_type = cfg.pool_type
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, patches: torch.Tensor, *, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens = self.backbone(patches, deterministic=deterministic, rng=rng)
        vec = tokens.mean(1) if self.pool_type == "mean" else tokens[:, 0]
        return dropout(self.norm(vec).to(self.dtype), self.dropout,
                       deterministic, rng)


class ImageExpertWithProjection(nn.Module):
    """HoME: the ViT's CLS vector and a trainable projection head
    768 -> 1536 -> GELU -> 768 that feeds only the contrastive losses
    (ref model_HoME.py:373-399).  Returns (img_vec, projected)."""

    def __init__(self, cfg: ImageEncoderConfig,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 remat: bool = False, remat_policy: str = "dots"):
        super().__init__()
        d = cfg.hidden_size
        self.backbone = ViTEncoder(cfg, dtype, use_flash, remat, remat_policy)
        self.projection_head = Mlp(d, 2 * d, d, gelu_exact, dtype)

    def forward(self, patches: torch.Tensor, *, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        img_vec = self.backbone(patches, deterministic=deterministic,
                                rng=rng)[:, 0]
        return img_vec, self.projection_head(img_vec, deterministic, rng)
