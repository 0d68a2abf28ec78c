"""TextExpert: BGE encoder over packed chunks + sentence gather + doc pooling.

Port of mmoe_multimodal_rec_tpu/models/text_expert.py: TextExpert
(baseline and HoME) and the shared-base DualTextExpert
(model.shared_text_base).  The packer's static routing tensors
`sent_chunk`/`sent_tok` [B, S] (global chunk row / token position, -1 =
padded sentence) turn the regroup into one index_select.

In a data-parallel forward the encoder runs on the rank's chunk rows
only, while `sent_chunk` / `sent_tok` are the global micro-batch's: the
gather fills the sentence vectors whose chunk the rank holds, sums them
over `data` (only [B, S, D] crosses ranks, never the [N, L, D] encoder
output) and keeps the rank's samples.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import TextEncoderConfig
from ..parallel.mesh import Axis, all_gather_rows, sum_over_data
from .bert import BertEncoder
from .layers import LayerNorm, data_axis, dropout


def gather_sentences(h: torch.Tensor, sent_chunk: torch.Tensor,
                     sent_tok: torch.Tensor, data: Optional[Axis] = None,
                     chunk_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h [N, L, D] hidden states -> (sent_vecs [B, S, D] with exact zeros
    at padded sentences, sent_mask [B, S] True = pad, doc_vecs [B, D] fp32
    masked mean).  sent_mask comes from the VALUES, as in the reference
    (model.py:328): an all-zero sentence vector counts as padding.

    `data` (a data-parallel forward): h is the rank's share of the global
    rows, sent_chunk/sent_tok [B_global, S] index the global ones (shifted
    by `chunk_offset`), and the result is the rank's B_global / dp
    samples."""
    n, l, d = h.shape
    b, s = sent_chunk.shape
    valid = (sent_chunk >= 0) & (sent_tok >= 0)
    if data is not None:
        sent_chunk = sent_chunk + (chunk_offset - data.rank * n)
        valid = valid & (sent_chunk >= 0) & (sent_chunk < n)
    flat_idx = sent_chunk.clamp(0, n - 1) * l + sent_tok.clamp(0, l - 1)
    sent_vecs = h.reshape(n * l, d).index_select(
        0, flat_idx.reshape(-1).long()).reshape(b, s, d)
    sent_vecs = torch.where(valid[..., None], sent_vecs,
                            torch.zeros((), dtype=h.dtype, device=h.device))
    if data is not None:
        per = b // data.size
        sent_vecs = sum_over_data(sent_vecs, data)[
            data.rank * per:(data.rank + 1) * per]
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
                 final_norm: bool = True, remat_policy: str = "dots"):
        super().__init__()
        self.encoder = BertEncoder(cfg, dtype, use_flash, remat, remat_policy)
        self.norm = LayerNorm(cfg.hidden_size, dtype=dtype) if final_norm \
            else None
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, tokens, sent_chunk, sent_tok, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        h = self.encoder(tokens, deterministic=deterministic, rng=rng)
        sent_vecs, sent_mask, doc_vecs = gather_sentences(
            h, sent_chunk, sent_tok, data_axis(rng))
        doc_vecs = doc_vecs.to(self.dtype)
        if self.norm is not None:
            sent_vecs = dropout(self.norm(sent_vecs).to(self.dtype),
                                self.dropout, deterministic, rng)
            doc_vecs = dropout(self.norm(doc_vecs).to(self.dtype),
                               self.dropout, deterministic, rng)
        return sent_vecs, sent_mask, doc_vecs


class DualTextExpert(nn.Module):
    """Both text experts as ONE encoder pass over the concatenated
    [user; item] chunk batch: one frozen base, per-side LoRA adapters
    (LoRADense sides = 2: lora_a [2, D, r], lora_b [2, r, D], 0 = user,
    1 = item) and, baseline only, per-side final LayerNorms `norm_user` /
    `norm_item`.  Equal to two TextExperts whose bases are equal, which
    the reference workflow keeps (both towers load one BGE, and the base
    is in no optimizer group); utils/shared_base.py converts between the
    layouts.  Seeds are drawn in call order: the encoder's sites, then
    the user side's two output dropouts, then the item side's.  In a
    data-parallel forward the rank encodes its equal share of the
    concatenated [user; item] rows (its user and item token rows are
    gathered first), so every dropout keys on a contiguous global range."""

    def __init__(self, cfg: TextEncoderConfig,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 dropout: float = 0.1, remat: bool = False,
                 final_norm: bool = True, remat_policy: str = "dots"):
        super().__init__()
        self.encoder = BertEncoder(cfg, dtype, use_flash, remat, remat_policy,
                                   lora_sides=2)
        if final_norm:
            self.norm_user = LayerNorm(cfg.hidden_size, dtype=dtype)
            self.norm_item = LayerNorm(cfg.hidden_size, dtype=dtype)
        self.final_norm = final_norm
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, user_tokens, item_tokens, user_sent_chunk,
                user_sent_tok, item_sent_chunk, item_sent_tok, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        """Returns ((u_sent, u_mask, u_doc), (i_sent, i_mask, i_doc)), each
        what TextExpert returns for its side."""
        data = data_axis(rng)
        nu = user_tokens.shape[0]
        tokens = torch.cat([user_tokens, item_tokens], dim=0)
        if data is not None:
            nu *= data.size
            n = tokens.shape[0]
            tokens = torch.cat([all_gather_rows(user_tokens, data),
                                all_gather_rows(item_tokens, data)], dim=0
                               )[data.rank * n:(data.rank + 1) * n]
            split = min(max(nu - data.rank * n, 0), n)
        else:
            split = nu
        h = self.encoder(tokens, deterministic=deterministic, rng=rng,
                         lora_split=split)
        outs = []
        sides = ((h, user_sent_chunk, user_sent_tok, 0),
                 (h, item_sent_chunk, item_sent_tok, nu)) \
            if data is not None else \
            ((h[:nu], user_sent_chunk, user_sent_tok, 0),
             (h[nu:], item_sent_chunk, item_sent_tok, 0))
        for side, (hs, sc, st, off) in zip(("user", "item"), sides):
            sent_vecs, sent_mask, doc_vecs = gather_sentences(hs, sc, st,
                                                              data, off)
            doc_vecs = doc_vecs.to(self.dtype)
            if self.final_norm:
                norm = getattr(self, f"norm_{side}")
                sent_vecs = dropout(norm(sent_vecs).to(self.dtype),
                                    self.dropout, deterministic, rng)
                doc_vecs = dropout(norm(doc_vecs).to(self.dtype),
                                   self.dropout, deterministic, rng)
            outs.append((sent_vecs, sent_mask, doc_vecs))
        return tuple(outs)
