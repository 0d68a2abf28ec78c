"""TextExpert: BGE encoder over packed chunks + sentence gather + doc pooling.

Port of mmoe_multimodal_rec_tpu/models/text_expert.py (TextExpert, baseline
and HoME; the shared-base DualTextExpert is a later slice).  The packer's static routing
tensors `sent_chunk`/`sent_tok` [B, S] (global chunk row / token position,
-1 = padded sentence) turn the regroup into one index_select.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import TextEncoderConfig
from .bert import BertEncoder
from .layers import LayerNorm, dropout


def gather_sentences(h: torch.Tensor, sent_chunk: torch.Tensor,
                     sent_tok: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h [N, L, D] hidden states -> (sent_vecs [B, S, D] with exact zeros
    at padded sentences, sent_mask [B, S] True = pad, doc_vecs [B, D] fp32
    masked mean).  sent_mask comes from the VALUES, as in the reference
    (model.py:328): an all-zero sentence vector counts as padding."""
    n, l, d = h.shape
    b, s = sent_chunk.shape
    valid = (sent_chunk >= 0) & (sent_tok >= 0)
    flat_idx = sent_chunk.clamp(0, n - 1) * l + sent_tok.clamp(0, l - 1)
    sent_vecs = h.reshape(n * l, d).index_select(
        0, flat_idx.reshape(-1).long()).reshape(b, s, d)
    sent_vecs = torch.where(valid[..., None], sent_vecs,
                            torch.zeros((), dtype=h.dtype, device=h.device))
    sent_mask = sent_vecs.float().abs().sum(-1) == 0.0
    lens = (~sent_mask).float().sum(1, keepdim=True)
    doc_vecs = sent_vecs.float().sum(1) / lens.clamp_min(1.0)
    return sent_vecs, sent_mask, doc_vecs


class TextExpert(nn.Module):
    """Text expert: encoder -> gather -> (baseline, `final_norm`) LN +
    dropout on the sentence and doc vectors (the same norm for both, two
    dropout draws, ref model.py:335-336); HoME has no final norm
    (model_HoME.py:366-367) and returns the gathered vectors, the doc
    vectors cast to the compute dtype."""

    def __init__(self, cfg: TextEncoderConfig,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 dropout: float = 0.1, remat: bool = False,
                 final_norm: bool = True):
        super().__init__()
        self.encoder = BertEncoder(cfg, dtype, use_flash, remat)
        self.norm = LayerNorm(cfg.hidden_size, dtype=dtype) if final_norm \
            else None
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, tokens, sent_chunk, sent_tok, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        h = self.encoder(tokens, deterministic=deterministic, rng=rng)
        sent_vecs, sent_mask, doc_vecs = gather_sentences(h, sent_chunk,
                                                          sent_tok)
        doc_vecs = doc_vecs.to(self.dtype)
        if self.norm is not None:
            sent_vecs = dropout(self.norm(sent_vecs).to(self.dtype),
                                self.dropout, deterministic, rng)
            doc_vecs = dropout(self.norm(doc_vecs).to(self.dtype),
                               self.dropout, deterministic, rng)
        return sent_vecs, sent_mask, doc_vecs
