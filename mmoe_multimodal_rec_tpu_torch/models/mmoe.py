"""Full-model assembly, baseline and HoME variants.

Port of mmoe_multimodal_rec_tpu/models/mmoe.py: two text experts, the image
expert, the sentence cross expert and two fuse experts stacked in the
reference order u_doc, i_doc, img_vec, ui_vec, xui, xti (train.py:242-251)
into the dense-gated two-task head.  HoME (train_HoME.py:344-357) drops the
experts' final norms and heads, projects the ViT's CLS vector for the
contrastive losses, wraps every expert vector in BatchNorm + SiLU +
dropout and scores them with the HoME head.  `shared_text_base` runs both
text experts as one DualTextExpert pass (`text_experts`); `gate_type`
"topk" puts the top-k gates in the head; `remat` recomputes each encoder
layer in the backward under `remat_policy`.

`forward(batch, deterministic=False, rng=gen)` is the training forward:
every dropout site draws its seed from `gen` in call order (user expert,
item expert (or the shared text pass), image expert, cross expert, the two fuse experts, the HoME
wrappers, the head).  The HoME wrappers' BatchNorms use the batch's
statistics, and move their running ones, unless `bn_use_running_average`,
which defaults to `deterministic`.  In a data-parallel training step
(parallel/mesh.py) the batch is the rank's share of the global one and
`rng` a parallel.mesh.DataShard: the sites then act on the global
micro-batch (models/layers.data_axis).
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
from .text_expert import DualTextExpert, TextExpert

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
        if cfg.variant not in ("baseline", "home"):
            raise ValueError(f"unknown model.variant {cfg.variant!r}")
        d = cfg.text.hidden_size
        if cfg.image.hidden_size != d:
            raise ValueError("the experts stack: text and image hidden sizes "
                             f"must match ({d} vs {cfg.image.hidden_size})")
        self.cfg = cfg
        self.home = home = cfg.variant == "home"
        dtype = DTYPES[cfg.compute_dtype]
        flash = cfg.use_flash_attention
        drop = cfg.dropout
        remat = dict(remat=cfg.remat, remat_policy=cfg.remat_policy)
        self.shared = cfg.shared_text_base
        if self.shared:
            self.text_experts = DualTextExpert(cfg.text, dtype, flash, drop,
                                               final_norm=not home, **remat)
        else:
            self.user_expert = TextExpert(cfg.text, dtype, flash, drop,
                                          final_norm=not home, **remat)
            self.item_expert = TextExpert(cfg.text, dtype, flash, drop,
                                          final_norm=not home, **remat)
        if home:
            self.img_expert = ImageExpertWithProjection(cfg.image, dtype,
                                                        flash, **remat)
        else:
            self.img_expert = ItemImageExpert(cfg.image, dtype, flash, drop,
                                              **remat)
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
                cfg.home_tower_dropout, dtype, cfg.gate_type, cfg.gate_topk)
        else:
            self.head = TwoTaskMMoE(d, cfg.n_experts, cfg.tower_hidden, dtype,
                                    cfg.tower_dropout, cfg.gate_type,
                                    cfg.gate_topk)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None,
                bn_use_running_average: Optional[bool] = None
                ) -> ModelOutputs:
        kw = dict(deterministic=deterministic, rng=rng)
        if self.shared:
            (u_sent, u_mask, u_doc), (i_sent, i_mask, i_doc) = \
                self.text_experts(batch["user_tokens"], batch["item_tokens"],
                                  batch["user_sent_chunk"],
                                  batch["user_sent_tok"],
                                  batch["item_sent_chunk"],
                                  batch["item_sent_tok"], **kw)
        else:
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
