"""BGE-base / BERT-base text encoder (post-LayerNorm).

Port of mmoe_multimodal_rec_tpu/models/bert.py in its unrolled
`layer_{i}` layout.  With LoRA merged (eval/predict.Predictor's default)
every layer's self-attention takes the packed-qkv kernel; with LoRA kept
apart (training, `merge_lora=False`), query/value carry their adapters and
attention takes the split kernel (`flash_attention`, forward and
backward).  Dropout sits where the JAX module has it: after the embedding
norm, on the attention output and on the MLP output (hidden_dropout), on
the attention weights (attention_dropout) and on the LoRA inputs
(lora_dropout).  `model.remat` (per-layer recompute) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import TextEncoderConfig
from .layers import Attention, Embed, LayerNorm, Mlp, dropout, gelu_exact


class BertLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype,
                 use_flash: bool = False):
        super().__init__()
        d = cfg.hidden_size
        self.attention = Attention(
            d, cfg.num_heads, use_flash, dtype, lora_rank=cfg.lora_rank,
            lora_alpha=cfg.lora_alpha, lora_targets=tuple(cfg.lora_targets),
            dropout=cfg.attention_dropout, lora_dropout=cfg.lora_dropout,
            lora_fused_dropout=cfg.lora_fused_dropout)
        self.attention_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.mlp = Mlp(d, cfg.intermediate_size, d, gelu_exact, dtype,
                       out_dropout=cfg.hidden_dropout)
        self.output_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.dtype = dtype
        self.hidden_dropout = cfg.hidden_dropout

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        h = self.attention(x, x, x, pad_mask, deterministic=deterministic,
                           rng=rng)
        h = dropout(h, self.hidden_dropout, deterministic, rng)
        x = self.attention_norm(x + h.to(x.dtype))
        h = self.mlp(x.to(self.dtype), deterministic, rng)
        return self.output_norm(x + h.to(x.dtype))


class BertEncoder(nn.Module):
    """[N, L] token ids -> [N, L, D] hidden states (== last_hidden_state)."""

    def __init__(self, cfg: TextEncoderConfig,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 remat: bool = False):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError("text.scan_layers (stacked layer "
                                      "params) is not yet ported")
        if remat:
            raise NotImplementedError("model.remat (per-layer recompute) is "
                                      "not yet ported")
        d = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.word_embeddings = Embed(cfg.vocab_size, d, dtype)
        self.position_embeddings = Embed(cfg.max_position_embeddings, d, dtype)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, d, dtype)
        self.embeddings_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, dtype, use_flash))

    def forward(self, input_ids: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        l = input_ids.shape[1]
        if pad_mask is None:
            pad_mask = input_ids == self.cfg.pad_token_id
        # explicit position_ids = arange and token_type_ids = 0, as the
        # reference passes them (ref model.py:256-257)
        pos_ids = torch.arange(l, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(torch.zeros_like(pos_ids)))
        x = dropout(self.embeddings_norm(x), self.cfg.hidden_dropout,
                    deterministic, rng).to(self.dtype)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask, deterministic, rng)
        return x
