"""Full-model assembly, baseline and HoME variants.

Port of mmoe_multimodal_rec_tpu/models/mmoe.py: two text experts, the image
expert, the sentence cross expert and two fuse experts stacked in the
reference order u_doc, i_doc, img_vec, ui_vec, xui, xti (train.py:242-251)
into the dense-gated two-task head.  HoME (train_HoME.py:344-357) drops the
experts' final norms and heads, projects the ViT's CLS vector for the
contrastive losses, wraps every expert vector in BatchNorm + SiLU +
dropout and scores them with the HoME head.  The shared-base text layout
and top-k gating are later slices and raise here.

`forward(batch, deterministic=False, rng=gen)` is the training forward:
every dropout site draws its seed from `gen` in call order (user expert,
item expert, image expert, cross expert, the two fuse experts, the HoME
wrappers, the head).  The HoME wrappers' BatchNorms use the batch's
statistics, and move their running ones, unless `bn_use_running_average`,
which defaults to `deterministic`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..config import ModelConfig
from .cross import EnhancedCrossFuse, RobustTextCrossExpert
from .heads import TwoTaskMMoE
from .home import HomeExpertWrapper, HomeMMoEHead
from .image_expert import (ImageExpertWithProjection, ItemImageExpert,
                           normalize_patches)
from .text_expert import TextExpert

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
EXPERTS = ("u_doc", "i_doc", "img_vec", "ui_vec", "xui", "xti")


class ModelOutputs(NamedTuple):
    logit_good: torch.Tensor
    logit_best: torch.Tensor
    aux: Dict[str, torch.Tensor]


class MMoERecModel(nn.Module):
    """batch dict -> (logit_good, logit_best, aux).

    Batch keys (static shapes, built by data/packer.py):
      user_tokens [Nu, L] int      item_tokens [Ni, L] int
      user_sent_chunk/user_sent_tok [B, S] int (item_ likewise)
      patches [B, 196, 768] uint8  has_image [B] int
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        for name, ported in (("variant", cfg.variant in ("baseline", "home")),
                             ("shared_text_base", not cfg.shared_text_base),
                             ("gate_type", cfg.gate_type == "dense")):
            if not ported:
                raise NotImplementedError(
                    f"model.{name}={getattr(cfg, name)!r} is not yet ported")
        d = cfg.text.hidden_size
        if cfg.image.hidden_size != d:
            raise ValueError("the experts stack: text and image hidden sizes "
                             f"must match ({d} vs {cfg.image.hidden_size})")
        self.cfg = cfg
        self.home = home = cfg.variant == "home"
        dtype = DTYPES[cfg.compute_dtype]
        flash = cfg.use_flash_attention
        drop = cfg.dropout
        self.user_expert = TextExpert(cfg.text, dtype, flash, drop, cfg.remat,
                                      final_norm=not home)
        self.item_expert = TextExpert(cfg.text, dtype, flash, drop, cfg.remat,
                                      final_norm=not home)
        if home:
            self.img_expert = ImageExpertWithProjection(cfg.image, dtype,
                                                        flash, cfg.remat)
        else:
            self.img_expert = ItemImageExpert(cfg.image, dtype, flash, drop,
                                              cfg.remat)
        self.cross_ui = RobustTextCrossExpert(
            d, cfg.cross_layers, cfg.cross_heads, dtype, flash, drop,
            final_mlp=not home, pool_nan_guard=home)
        self.concat_ui = EnhancedCrossFuse(d, cfg.fuse_depth, cfg.fuse_heads,
                                           dtype, drop, final_proj=not home)
        self.concat_ti = EnhancedCrossFuse(d, cfg.fuse_depth, cfg.fuse_heads,
                                           dtype, drop, final_proj=not home)
        if home:
            for name in EXPERTS:
                self.add_module(f"{name}_wrapper", HomeExpertWrapper(
                    d, drop, cfg.home_bn_momentum, cfg.home_bn_eps, dtype))
            self.head = HomeMMoEHead(
                d, cfg.n_experts, cfg.home_shared_experts,
                cfg.home_task_experts, cfg.home_expert_hidden,
                cfg.home_expert_dropout, cfg.home_tower_hidden,
                cfg.home_tower_dropout, dtype)
        else:
            self.head = TwoTaskMMoE(d, cfg.n_experts, cfg.tower_hidden, dtype,
                                    cfg.tower_dropout)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None,
                bn_use_running_average: Optional[bool] = None
                ) -> ModelOutputs:
        kw = dict(deterministic=deterministic, rng=rng)
        u_sent, u_mask, u_doc = self.user_expert(
            batch["user_tokens"], batch["user_sent_chunk"],
            batch["user_sent_tok"], **kw)
        i_sent, i_mask, i_doc = self.item_expert(
            batch["item_tokens"], batch["item_sent_chunk"],
            batch["item_sent_tok"], **kw)
        patches = normalize_patches(batch["patches"], batch["has_image"])
        aux = {}
        if self.home:
            img_vec, aux["projected_img"] = self.img_expert(patches, **kw)
        else:
            img_vec = self.img_expert(patches, **kw)
        ui_vec = self.cross_ui(u_sent, u_mask, i_sent, i_mask, **kw)
        xui = self.concat_ui(u_doc, img_vec, **kw)
        xti = self.concat_ti(i_doc, img_vec, **kw)
        vecs = (u_doc, i_doc, img_vec, ui_vec, xui, xti)
        aux.update(zip(EXPERTS, vecs))
        if self.home:
            if bn_use_running_average is None:
                bn_use_running_average = deterministic
            vecs = [getattr(self, f"{name}_wrapper")(
                vec, use_running_average=bn_use_running_average, **kw)
                for name, vec in zip(EXPERTS, vecs)]
        logit_good, logit_best, balance = self.head(torch.stack(vecs, dim=1),
                                                    **kw)
        aux["gate_balance"] = balance
        return ModelOutputs(logit_good.float(), logit_best.float(), aux)
