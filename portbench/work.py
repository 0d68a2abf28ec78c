"""Operations and bytes: the yardstick of the rooflines and of `mfu`.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.

`bound`, `fwd_work` and `in_path_bounds` are frozen copies of
chip_smoke.py's; `bwd_work` counts, as `fwd_work` does, only the keys that
the pad mask leaves (a backward that learns to skip padding is credited).

`model_flops` counts the useful work of a forward (and, for training, of
the backward) from the inputs: every product at 2*m*n*k, over the token
positions the inputs fill (a chunk up to its [SEP], not the padding of its
384 positions), attention at the key lengths the masks leave, the ViT for
the samples that carry an image, the sentence cross expert over the
sentences a sample has.  The backward adds the input gradients of the
products that have a trainable parameter below them and the weight
gradients of the trainable weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes, flops):
    """(bound ms, what bounds it)."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _keys(pad: Optional[np.ndarray], b: int, l: int) -> int:
    """Keys the rows need: each row's real keys, every key for a row with
    none (its weights are uniform)."""
    if pad is None:
        return b * l
    n = (~pad).sum(1)
    return int(np.where(n == 0, l, n).sum())


def fwd_work(pad, b, l, heads, dh, el, stats):
    """(bytes, products, key tiles walked, key tiles) of one attention
    forward call; pad [b, l] True at padded keys, or None."""
    d, nt = heads * dh, -(-l // 64)
    keys = _keys(pad, b, l)
    if pad is None:
        walked = b * nt
    else:
        live = np.zeros((b, nt * 64), bool)
        live[:, :l] = ~pad
        live = live.reshape(b, nt, 64).any(2).sum(1)
        walked = int(np.where(live == 0, nt, live).sum())
    nbytes = ((2 * b * l + 2 * keys) * d * el + (0 if pad is None else b * l)
              + (b * heads * l * 8 if stats else 0))
    return nbytes, 4 * l * keys * d, heads * walked, heads * b * nt


def bwd_work(pad, b, l, heads, dh, el):
    """(bytes, products) of one attention backward call: q and dO read and
    dq written for every row, k and v read over the keys the mask leaves,
    dk and dv written whole, the mask and the statistics read; the five
    products (S again, dP, dV, dQ, dK) over the same keys."""
    d = heads * dh
    keys = _keys(pad, b, l)
    nbytes = ((5 * b * l + 2 * keys) * d * el + (0 if pad is None else b * l)
              + b * heads * l * 8)
    return nbytes, 10 * l * keys * d


def in_path_bounds(calls, backward: bool = False) -> Tuple[float, str]:
    """The summed bound (ms) of attention calls (b, l, heads, dh, pad, stats,
    el) and what bounds the whole."""
    ms = nbytes = flops = 0
    for b, l, heads, dh, pad, stats, el in calls:
        nb, fl = (bwd_work(pad, b, l, heads, dh, el) if backward
                  else fwd_work(pad, b, l, heads, dh, el, stats)[:2])
        ms += bound(nb, fl)[0]
        nbytes, flops = nbytes + nb, flops + fl
    return ms, bound(nbytes, flops)[1]


# -- useful work of the model ----------------------------------------------------

def _side(tokens: np.ndarray, pad_id: int = 0):
    """(filled positions, sum over chunks of filled x keys)."""
    real = tokens != pad_id
    any_real = real.any(1)
    last = np.where(any_real, tokens.shape[1] - np.argmax(real[:, ::-1], 1), 0)
    keys = real.sum(1)
    return int(last.sum()), int((last * keys).sum())


def _block(d, f, t):
    """Products of one encoder layer's dense parts over t positions."""
    return 2 * t * (4 * d * d + 2 * d * f)


def model_flops(port: Dict[str, object], batch: Dict[str, np.ndarray],
                train: bool, n_real: Optional[int] = None) -> float:
    """Useful products of one micro-batch (or serving batch, of which the
    first `n_real` samples are real)."""
    g = lambda k: port[k]
    d = int(g("model.text.hidden_size"))
    f = int(g("model.text.intermediate_size"))
    layers = int(g("model.text.num_layers"))
    rank = int(g("model.text.lora_rank"))
    home = g("model.variant") == "home"
    lora_sites = len(tuple(g("model.text.lora_targets"))) if rank else 0
    total = 0.0
    for side in ("user", "item"):
        t, a = _side(batch[f"{side}_tokens"])
        fwd = layers * (_block(d, f, t) + 4 * a * d)
        if train and rank:
            fwd += layers * lora_sites * 2 * 2 * t * d * rank
            # input gradients above layer 0's projections, layer 0's without
            # the q/k/v ones and the key gradient; LoRA's three products a
            # site (dt, dA, dB) and its input gradient above layer 0
            bwd = layers * (_block(d, f, t) + 8 * a * d) \
                - 2 * t * 3 * d * d - 2 * a * d
            bwd += layers * lora_sites * 3 * 2 * t * d * rank \
                + (layers - 1) * lora_sites * 2 * t * d * rank
            fwd += bwd
        total += fwd
    n = batch["has_image"].shape[0] if n_real is None else n_real
    imgs = int((batch["has_image"][:n] > 0).sum())
    di = int(g("model.image.hidden_size"))
    fi = int(g("model.image.intermediate_size"))
    li = int(g("model.image.num_layers"))
    l_img = int(g("model.image.num_patches")) + 1
    t = imgs * l_img
    vit_layer = _block(di, fi, t) + 4 * imgs * l_img * l_img * di
    total += 2 * imgs * (l_img - 1) * int(g("model.image.patch_dim")) * di
    total += li * vit_layer
    if train and home:
        # the last two layers: weight gradients, input gradients of layer
        # 11 whole and of layer 10 above its q/k/v projections
        total += 2 * _block(di, fi, t) + 2 * vit_layer - 2 * t * 3 * di * di
        total += 3 * 2 * imgs * 2 * di * di          # the projection head
    # sentence cross expert over the sentences a sample has
    valid = lambda side: ((batch[f"{side}_sent_chunk"][:n] >= 0)
                          & (batch[f"{side}_sent_tok"][:n] >= 0)).sum(1)
    nu, ni = valid("user").astype(np.int64), valid("item").astype(np.int64)
    cl = int(g("model.cross_layers"))
    block = lambda m: 2 * m * 12 * d * d
    cross = cl * int((block(nu) + block(ni)).sum()) \
        + cl * 4 * d * int((nu * nu + ni * ni).sum())
    cross += 2 * d * d * int((2 * nu + 2 * ni).sum()) + 4 * d * int((nu * ni).sum())
    cross += 2 * 2 * d * int(nu.sum()) + (0 if home else n * 2 * 2 * d * 4 * d)
    fd = int(g("model.fuse_depth"))
    fuse = 2 * n * (2 * 2 * d * d + fd * (block(2) + 4 * 4 * d)
                    + 2 * d * d + d + (0 if home else 2 * d * d))
    if home:
        ks, kt = int(g("model.home_shared_experts")), int(g("model.home_task_experts"))
        hid, th = int(g("model.home_expert_hidden")), int(g("model.home_tower_hidden"))
        ne = int(g("model.n_experts"))
        head = n * 2 * (ne * d * d + d * d * (ks + 2 * kt)
                        + (ks + 2 * kt) * 2 * d * hid + 3 * d * d
                        + 2 * d * (ks + kt) + 2 * (d * th + th))
    else:
        th = int(g("model.tower_hidden"))
        ne = int(g("model.n_experts"))
        head = n * 2 * (2 * d * ne + 2 * (d * th + th * th // 2 + th // 2))
    rest = cross + fuse + head
    total += 3 * rest if train else rest
    return float(total)
