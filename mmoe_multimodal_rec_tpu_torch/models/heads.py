"""Two-task MMoE head (ref model.py:513-577) and its gates.

Port of mmoe_multimodal_rec_tpu/models/heads.py: the dense gate (the
reference's, and the default) and the opt-in top-k gate with its
Switch-style load-balance term (model.gate_type="topk").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import Axis, sum_over_data
from .layers import Dense, LayerNorm, data_axis, dropout, gelu_exact


class DenseGate(nn.Module):
    """softmax(Linear(d -> n_expert)) in fp32."""

    def __init__(self, d: int, n_expert: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(d, n_expert, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.fc(x).float(), dim=-1)


class TopKGate(nn.Module):
    """softmax(Linear(d -> n_expert)) masked to each row's top k and
    renormalised, and the Switch balance term n * sum_i f_i P_i (f_i: the
    share of rows routing to expert i, the top-k mask's mean / k; P_i: the
    mean probability).  The top k come from a stable descending sort, so a
    tie takes the lower index, as lax.top_k does (torch.topk promises no
    order among equal values).  In a data-parallel forward (`data`) f and P
    are the global micro-batch's means (sums over data)."""

    def __init__(self, d: int, n_expert: int, k: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(d, n_expert, dtype)
        self.n_expert = n_expert
        self.k = k

    def forward(self, x: torch.Tensor, data: Optional[Axis] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = torch.softmax(self.fc(x).float(), dim=-1)
        k = min(self.k, self.n_expert)
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        mask = torch.zeros_like(probs).scatter_(1, idx, 1.0)
        w = probs * mask
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
        if data is None:
            frac, p_mean = mask.mean(0) / k, probs.mean(0)
        else:
            n = x.shape[0] * data.size
            frac = sum_over_data(mask.sum(0), data) / n / k
            p_mean = sum_over_data(probs.sum(0), data) / n
        balance = self.n_expert * (frac * p_mean).sum()
        return w, balance


def make_gate(gate_type: str, d: int, n_expert: int, topk: int,
              dtype: torch.dtype) -> nn.Module:
    """One task's gate: DenseGate, or TopKGate for gate_type "topk"."""
    if gate_type == "topk":
        return TopKGate(d, n_expert, topk, dtype)
    if gate_type != "dense":
        raise ValueError(f"unknown gate_type {gate_type!r}")
    return DenseGate(d, n_expert, dtype)


def make_gates(gates, query: torch.Tensor, data: Optional[Axis] = None):
    """Per-task gate weights and the summed balance term (0 for dense), as
    JAX make_gates returns them; `data` as TopKGate's."""
    weights, balance = [], torch.zeros((), device=query.device)
    for gate in gates:
        if isinstance(gate, TopKGate):
            out, b = gate(query, data)
            balance = balance + b
        else:
            out = gate(query)
        weights.append(out)
    return weights, balance


class Tower(nn.Module):
    """LN -> d -> hidden -> GELU -> drop -> hidden/2 -> GELU -> drop -> 1."""

    def __init__(self, d: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.norm = LayerNorm(d, dtype=dtype)
        self.fc1 = Dense(d, hidden, dtype)
        self.fc2 = Dense(hidden, hidden // 2, dtype)
        self.fc3 = Dense(hidden // 2, 1, dtype)
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = gelu_exact(self.fc1(self.norm(x).to(self.dtype)))
        x = dropout(x, self.dropout, deterministic, rng)
        x = gelu_exact(self.fc2(x))
        x = dropout(x, self.dropout, deterministic, rng)
        return self.fc3(x).squeeze(-1)


class TwoTaskMMoE(nn.Module):
    """expert_vecs [B, N, D] -> (logit_good [B], logit_best [B], balance);
    balance is the top-k load-balance aux, 0 under dense gating."""

    def __init__(self, d: int, n_expert: int = 6, tower_hidden: int = 256,
                 dtype: torch.dtype = torch.float32,
                 tower_dropout: float = 0.0, gate_type: str = "dense",
                 gate_topk: int = 2):
        super().__init__()
        self.gate_good = make_gate(gate_type, d, n_expert, gate_topk, dtype)
        self.gate_best = make_gate(gate_type, d, n_expert, gate_topk, dtype)
        self.tower_good = Tower(d, tower_hidden, dtype, tower_dropout)
        self.tower_best = Tower(d, tower_hidden, dtype, tower_dropout)

    def forward(self, expert_vecs: torch.Tensor, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        query = expert_vecs.mean(1)
        (w_good, w_best), balance = make_gates(
            (self.gate_good, self.gate_best), query, data_axis(rng))
        fused_good = torch.einsum("bn,bnd->bd", w_good.to(expert_vecs.dtype),
                                  expert_vecs)
        fused_best = torch.einsum("bn,bnd->bd", w_best.to(expert_vecs.dtype),
                                  expert_vecs)
        return (self.tower_good(fused_good, deterministic, rng),
                self.tower_best(fused_best, deterministic, rng), balance)
