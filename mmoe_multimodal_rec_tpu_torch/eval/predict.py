"""Serving-path predictor: raw (user_text, item_text, patch) -> scores.

Port of mmoe_multimodal_rec_tpu/eval/predict.py:
- batch-size buckets: each predict() pads to the smallest bucket >= n, and
  the padding is discarded from the result;
- host tokenization + static-shape chunk packing (data/packer.py) with a
  per-sample chunk allowance ceil(chunk_budget / train.batch_size);
- LoRA folded into the base kernels by default (exact at inference), so
  every text and ViT self-attention takes the packed-qkv kernel;
- scores returned as probabilities (sigmoid of the two task logits).

The predictor runs on `device` ("cuda" unless the caller asks for the CPU);
without a card it raises rather than falling back.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.decode import PATCH_SHAPE
from ..data.packer import TextPacker, packer_from_config
from ..models.layers import init_weights
from ..models.mmoe import DTYPES, MMoERecModel
from ..utils.convert import load_jax_params
from ..utils.lora import merge_lora_state, merged_model_config


class Predictor:
    def __init__(self, cfg: Config,
                 params: Optional[Mapping[str, np.ndarray]] = None, *,
                 batch_stats: Optional[Mapping[str, np.ndarray]] = None,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 batch_size: Optional[int] = None, tokenizer=None,
                 merge_lora: bool = True,
                 buckets: Optional[Sequence[int]] = None,
                 device="cuda"):
        """params: the JAX param tree flattened with '/'-joined keys (numpy
        arrays, utils/convert.py), and batch_stats its HoME BatchNorm
        statistics flattened the same way; or state: the port's own
        state_dict of an unmerged MMoERecModel (a trained, restored or
        recalibrated model's, train/checkpoint.restore_model), BatchNorm
        statistics included.  Neither: weights initialised from train.seed
        — with LoRA B at zero, the merged init equals the base init exactly.

        merge_lora: fold the (trained) LoRA adapters into the base kernels
        (utils/lora.py) so the text attention takes the packed kernel.

        buckets: ascending batch-size buckets (e.g. [4, 16, 64]); an
        explicit batch_size joins them.  Default: the single
        [batch_size or train.batch_size] bucket."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path")
        self.cfg = cfg
        base = batch_size or cfg.train.batch_size
        self.buckets = (sorted(set(buckets) | ({base} if batch_size else
                                               set()))
                        if buckets else [base])
        self.batch_size = self.buckets[-1]
        cb = cfg.model.packer.chunk_budget
        self._chunks_per_sample = (
            -(-cb // cfg.train.batch_size) if cb
            else cfg.model.packer.max_chunks_per_sample)
        self.packer = (TextPacker(tokenizer, cfg.model.packer) if tokenizer
                       else packer_from_config(cfg))
        model_cfg = cfg.model
        if merge_lora and model_cfg.text.lora_rank > 0:
            model_cfg = merged_model_config(model_cfg)
        self.model = MMoERecModel(model_cfg)
        if params is not None and state is not None:
            raise ValueError("pass params (JAX) or state (the port's), not "
                             "both")
        if state is not None:
            if merge_lora and cfg.model.text.lora_rank > 0:
                state = merge_lora_state(state, cfg.model.text.lora_alpha)
            self.model.load_state_dict(state, strict=True)
        elif params is not None:
            load_jax_params(self.model, params, cfg.model, merge_lora,
                            batch_stats=batch_stats)
        else:
            gen = torch.Generator().manual_seed(cfg.train.seed)
            init_weights(self.model, gen)
        self.model.to(device=self.device,
                      dtype=DTYPES[model_cfg.param_dtype]).eval()

    def warmup(self) -> None:
        """Run every bucket shape once before accepting traffic."""
        for b in self.buckets:
            self.predict(["warmup"] * b, ["warmup"] * b)

    @torch.inference_mode()
    def _forward(self, batch: Dict[str, np.ndarray]):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in batch.items()}
        out = self.model(batch)
        return (torch.sigmoid(out.logit_good).cpu().numpy(),
                torch.sigmoid(out.logit_best).cpu().numpy())

    def predict(self, user_texts: Sequence[str], item_texts: Sequence[str],
                patches: Optional[np.ndarray] = None,
                has_image: Optional[np.ndarray] = None
                ) -> Dict[str, np.ndarray]:
        """Score up to batch_size pairs; inputs pad to the smallest bucket
        >= n and the padding is discarded from the result."""
        n = len(user_texts)
        if len(item_texts) != n:
            raise ValueError(f"{n} user texts but {len(item_texts)} items")
        if n > self.batch_size:
            raise ValueError(f"{n} instances > batch size {self.batch_size}")
        b = next(s for s in self.buckets if s >= n)
        pad = b - n
        user_texts = list(user_texts) + [""] * pad
        item_texts = list(item_texts) + [""] * pad
        if patches is None:
            patches = np.zeros((n, *PATCH_SHAPE), np.uint8)
            has_image = np.zeros(n, np.int32)
        if has_image is None:
            has_image = np.ones(n, np.int32)
        patches = np.concatenate(
            [patches, np.zeros((pad, *PATCH_SHAPE), np.uint8)], axis=0)
        has_image = np.concatenate([has_image.astype(np.int32),
                                    np.zeros(pad, np.int32)])

        budget = b * self._chunks_per_sample
        u = self.packer.pack(user_texts, budget)
        i = self.packer.pack(item_texts, budget)
        pg, pb = self._forward({
            "user_tokens": u.tokens, "user_sent_chunk": u.sent_chunk,
            "user_sent_tok": u.sent_tok,
            "item_tokens": i.tokens, "item_sent_chunk": i.sent_chunk,
            "item_sent_tok": i.sent_tok,
            "patches": patches, "has_image": has_image,
        })
        return {"prob_good": pg[:n], "prob_best": pb[:n]}
