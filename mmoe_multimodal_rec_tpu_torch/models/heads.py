"""Dense-gated two-task MMoE head (ref model.py:513-577).

Port of mmoe_multimodal_rec_tpu/models/heads.py with the dense gate only
(TopKGate is a later slice).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Dense, LayerNorm, dropout, gelu_exact


class DenseGate(nn.Module):
    """softmax(Linear(d -> n_expert)) in fp32."""

    def __init__(self, d: int, n_expert: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(d, n_expert, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.fc(x).float(), dim=-1)


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
                 tower_dropout: float = 0.0):
        super().__init__()
        self.gate_good = DenseGate(d, n_expert, dtype)
        self.gate_best = DenseGate(d, n_expert, dtype)
        self.tower_good = Tower(d, tower_hidden, dtype, tower_dropout)
        self.tower_best = Tower(d, tower_hidden, dtype, tower_dropout)

    def forward(self, expert_vecs: torch.Tensor, *,
                deterministic: bool = True,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        query = expert_vecs.mean(1)
        w_good = self.gate_good(query).to(expert_vecs.dtype)
        w_best = self.gate_best(query).to(expert_vecs.dtype)
        fused_good = torch.einsum("bn,bnd->bd", w_good, expert_vecs)
        fused_best = torch.einsum("bn,bnd->bd", w_best, expert_vecs)
        balance = torch.zeros((), device=expert_vecs.device)
        return (self.tower_good(fused_good, deterministic, rng),
                self.tower_best(fused_best, deterministic, rng), balance)
