"""The dropout streams, written out again for the plain reference.

A frozen copy of the formulas the recommender's training forward keys its
dropout on, so that the reference drops the same units without calling
the program:

- every micro-batch draws its sites' int32 seeds, in call order, from a CPU
  `torch.Generator` seeded through numpy's SeedSequence on
  (train seed + 1, host step, micro-batch);
- a mask keeps index i where the murmur3 finaliser of
  i * 2654435761 + seed (mod 2^32) is at least uint32(rate * (2^32 - 1));
- hidden-state and LoRA-input dropout key on the flat index of the tensor;
  attention weights on ((b * H + h) * Lq + q) * Lk_pad + k, Lk_pad the key
  length rounded up to 128.

Everything runs in int64 on the tensor's device; products are split into
16-bit halves so that none leaves int64.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 2654435761
LANE = 128


class SeedStream:
    """The seeds of one micro-batch's dropout sites, in call order."""

    def __init__(self, train_seed: int, host_step: int, micro: int):
        state = np.random.SeedSequence(
            [train_seed + 1, host_step, micro]).generate_state(1)
        self.gen = torch.Generator().manual_seed(int(state[0]))
        self.drawn = 0

    def draw(self) -> int:
        self.drawn += 1
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.gen))


def threshold(rate: float) -> int:
    return int(min(max(rate, 0.0), 1.0) * 4294967295.0)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_bits(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """uint32 hash bits (held in int64) of counters idx < 2^32."""
    x = (_mul32(idx & M32, GOLDEN) + (seed & M32)) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def flat_keep(shape, seed: int, rate: float, device) -> torch.Tensor:
    """Keep mask of a hidden-state or LoRA-input dropout site."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (hash_bits(seed, idx) >= threshold(rate)).reshape(shape)


def attention_keep(seed: int, b0: int, b: int, heads: int, lq: int, lk: int,
                   rate: float, device) -> torch.Tensor:
    """Keep mask [b, heads, lq, lk] of rows b0 .. b0 + b of an attention's
    weights."""
    lk_pad = -(-lk // LANE) * LANE
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    idx = ((((b0 + ar(b))[:, None] * heads + ar(heads)[None, :])
            * lq)[..., None, None] + ar(lq)[:, None]) * lk_pad + ar(lk)[None, :]
    return hash_bits(seed, idx) >= threshold(rate)


def dropped(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """x / (1 - rate) where kept, 0 elsewhere."""
    keep = flat_keep(x.shape, seed, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
