"""HoME hierarchical-expert head, its gates and the expert wrappers.

Port of mmoe_multimodal_rec_tpu/models/home.py (ref model_HoME.py:28-35
ExpertMLP, :224-243 FeatureGate/SelfGate, :530-638 HOME_MMoE_Complete,
train_HoME.py:100-116 HomeExpertWrapper), with the dense or the top-k
gate (model.gate_type).

The wrappers' BatchNorm statistics are taken over the whole global
micro-batch, in a data-parallel forward through sums over `data`
(models/layers.BatchNorm1D, which keeps the running ones as buffers).
Dropout seeds are drawn in call order: the meta, good and best expert MLPs,
then the two towers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .heads import make_gate, make_gates
from .layers import (BatchNorm1D, Dense, LayerNorm, Mlp, data_axis, dropout,
                     gelu_exact)


class FeatureGate(nn.Module):
    """Private per-expert inputs: x[:, None] * 2 sigmoid(Linear(d -> d*n))
    reshaped to [B, n, d] (ref model_HoME.py:224-234)."""

    def __init__(self, d: int, n_experts: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = Dense(d, d * n_experts, dtype)
        self.n_experts = n_experts

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gate(x).reshape(x.shape[0], self.n_experts, x.shape[-1])
        return x[:, None, :] * (2.0 * torch.sigmoid(g))


class SelfGate(nn.Module):
    """Gated residual: x + sigmoid(Linear(x)) * expert(x)
    (ref model_HoME.py:236-243)."""

    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = Dense(d, d, dtype)

    def forward(self, x_original: torch.Tensor,
                x_processed: torch.Tensor) -> torch.Tensor:
        return x_original + torch.sigmoid(self.gate(x_original)) * x_processed


class HomeTower(nn.Module):
    """LN -> Linear(d, hidden) -> GELU -> dropout -> Linear(hidden, 1)
    (ref model_HoME.py:581-588)."""

    def __init__(self, d: int, hidden: int = 512, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(d, dtype=dtype)
        self.fc1 = Dense(d, hidden, dtype)
        self.fc2 = Dense(hidden, 1, dtype)
        self.dropout = dropout
        self.dtype = dtype

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = gelu_exact(self.fc1(self.norm(x).to(self.dtype)))
        x = dropout(x, self.dropout, deterministic, rng)
        return self.fc2(x).squeeze(-1)


class HomeMMoEHead(nn.Module):
    """HOME_MMoE_Complete (ref model_HoME.py:530-638): [B, 6, D] -> flatten
    -> input projection + mean residual = shared input; FeatureGate-private
    inputs through 4 shared and 2 x 2 task expert MLPs; SelfGate; a dense
    gate per task over its (shared + task) experts, dense or top-k
    (`gate_type`); weighted sums; towers.  Returns (logit_good,
    logit_best, balance), balance the top-k gates' summed load-balance
    term (0 for dense gates)."""

    def __init__(self, d: int, num_input_experts: int = 6,
                 n_shared_experts: int = 4, n_task_experts: int = 2,
                 expert_hidden: int = 1024, expert_dropout: float = 0.1,
                 tower_hidden: int = 512, tower_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, gate_type: str = "dense",
                 gate_topk: int = 2):
        super().__init__()
        self.n_shared = n_shared_experts
        self.n_task = n_task_experts
        self.dtype = dtype
        self.input_projection = Dense(num_input_experts * d, d, dtype)
        self.input_norm = LayerNorm(d, dtype=dtype)
        self.fg_meta = FeatureGate(d, n_shared_experts, dtype)
        self.fg_good = FeatureGate(d, n_task_experts, dtype)
        self.fg_best = FeatureGate(d, n_task_experts, dtype)
        expert = lambda: Mlp(d, expert_hidden, d, gelu_exact, dtype,
                             expert_dropout)
        for group, n in (("meta", n_shared_experts), ("good", n_task_experts),
                         ("best", n_task_experts)):
            for i in range(n):
                self.add_module(f"{group}_expert_{i}", expert())
        self.sg_meta = SelfGate(d, dtype)
        self.sg_good = SelfGate(d, dtype)
        self.sg_best = SelfGate(d, dtype)
        n_pool = n_shared_experts + n_task_experts
        self.gate_good = make_gate(gate_type, d, n_pool, gate_topk, dtype)
        self.gate_best = make_gate(gate_type, d, n_pool, gate_topk, dtype)
        self.tower_good = HomeTower(d, tower_hidden, tower_dropout, dtype)
        self.tower_best = HomeTower(d, tower_hidden, tower_dropout, dtype)

    def forward(self, expert_vecs: torch.Tensor, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, n, d = expert_vecs.shape
        proj = self.input_norm(self.input_projection(
            expert_vecs.reshape(b, n * d)))
        shared = gelu_exact(proj.to(self.dtype)) + expert_vecs.mean(1)
        inputs = {"meta": self.fg_meta(shared), "good": self.fg_good(shared),
                  "best": self.fg_best(shared)}
        enhanced = {}
        for group, n_exp in (("meta", self.n_shared), ("good", self.n_task),
                             ("best", self.n_task)):
            gate = getattr(self, f"sg_{group}")
            enhanced[group] = [
                gate(shared, getattr(self, f"{group}_expert_{i}")(
                    inputs[group][:, i], deterministic, rng))
                for i in range(n_exp)]
        weights, balance = make_gates((self.gate_good, self.gate_best),
                                      shared, data_axis(rng))
        logits = []
        for task, w in zip(("good", "best"), weights):
            experts = torch.stack(enhanced["meta"] + enhanced[task], dim=1)
            fused = torch.einsum("bn,bnd->bd", w.to(experts.dtype), experts)
            logits.append(getattr(self, f"tower_{task}")(fused,
                                                         deterministic, rng))
        return logits[0], logits[1], balance


class HomeExpertWrapper(nn.Module):
    """BatchNorm1d -> SiLU -> dropout on an expert vector [B, D] or
    [B, L, D] (ref train_HoME.py:100-116)."""

    def __init__(self, d: int, dropout: float = 0.1, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = BatchNorm1D(d, bn_momentum, bn_eps, dtype)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                use_running_average: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.silu(self.norm(x.reshape(-1, x.shape[-1]),
                             use_running_average, data_axis(rng)))
        return dropout(y, self.dropout, deterministic, rng).reshape(x.shape)
