"""Plain fp32 PyTorch reference of the two-task multimodal recommender.

Written from the published description of the model the benchmark runs
(two BAAI/bge-base-en-v1.5 text encoders with LoRA on query and value, a
google/vit-base-patch16-224-in21k image encoder, a sentence cross expert, two
fuse experts and a dense-gated two-task MMoE head, or the HoME head with
BatchNorm expert wrappers and contrastive losses), with no kernel, cache
or batching of the program under test.  It takes its sizes from the
configuration file's "port" table and its parameters from a dict keyed by
the parameters' dotted names (those of the program's state_dict, so that
both sides are handed the same tensors).

Numerics: every product in float32 with TF32 off, softmax and LayerNorm in
float32, GELU in its exact erf form.  `Precision("fp8")` rounds both
operands of every product to float8 e4m3 (one scale a tensor) for the
control that has to fail the comparison.

Dropout keys on the frozen hash streams of reference/hashing.py; the
seeds are drawn in the model's call order.  Text-encoder layers are
recomputed in the backward (torch.utils.checkpoint) so that a full-size
micro-batch fits; the recompute replays the same masks, since a mask is a
function of its seed and index alone.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .hashing import SeedStream, attention_keep, dropped

NEG = -1e9
EXPERTS = ("u_doc", "i_doc", "img_vec", "ui_vec", "xui", "xti")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# elements of one block of attention scores
SCORE_BLOCK = 1 << 26


class Precision:
    """How the reference rounds the operands of its products."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        r = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # the gradient passes the rounding straight through
        return t + (r - t).detach()

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


class Cfg:
    """Read access to a configuration file's "port" table."""

    def __init__(self, port: Dict[str, object]):
        self.t = dict(port)

    def __getitem__(self, key: str):
        return self.t[key]


def _nodraw(rate: float, seeds) -> bool:
    return seeds is None or rate == 0.0


def drop(x: torch.Tensor, rate: float, seeds: Optional[SeedStream]):
    """One hidden-state dropout site: draws a seed only when it drops."""
    if _nodraw(rate, seeds):
        return x
    return dropped(x, seeds.draw(), rate)


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


class Reference:
    """The model as functions of (params, batch)."""

    def __init__(self, port: Dict[str, object], params: Dict[str, torch.Tensor],
                 precision: str = "fp32"):
        self.c = Cfg(port)
        self.p = params
        self.prec = Precision(precision)
        self.home = self.c["model.variant"] == "home"
        self.rank = int(self.c["model.text.lora_rank"])
        self.lora_targets = tuple(self.c["model.text.lora_targets"])

    # -- building blocks ----------------------------------------------------
    def dense(self, x, name):
        return self.prec.linear(x, self.p[f"{name}.weight"],
                                self.p[f"{name}.bias"])

    def proj(self, x, name, target, seed: Optional[int]):
        """A q/k/v projection, with its LoRA adapter where it has one:
        x W^T + b + (alpha / r) drop(x) A B."""
        if self.rank == 0 or target not in self.lora_targets:
            return self.dense(x, name)
        y = self.prec.linear(x, self.p[f"{name}.base.weight"],
                             self.p[f"{name}.base.bias"])
        h = x
        rate = float(self.c["model.text.lora_dropout"])
        if seed is not None and rate > 0.0:
            h = dropped(x, seed, rate)
        a, b = self.p[f"{name}.lora_a"], self.p[f"{name}.lora_b"]
        scale = float(self.c["model.text.lora_alpha"]) / a.shape[-1]
        t = self.prec.einsum("...i,ir->...r", h, a)
        return y + scale * self.prec.einsum("...r,ro->...o", t, b)

    def attend(self, q, k, v, pad, heads, rate, seed):
        """Multi-head attention over [B, L, D], fp32 softmax, padded keys at
        -1e9, dropout on the weights; in blocks of rows."""
        b, lq, d = q.shape
        lk = k.shape[1]
        dh = d // heads
        step = max(1, SCORE_BLOCK // (heads * lq * lk))
        outs = []
        for b0 in range(0, b, step):
            sl = slice(b0, min(b, b0 + step))
            qh = q[sl].reshape(-1, lq, heads, dh)
            kh = k[sl].reshape(-1, lk, heads, dh)
            vh = v[sl].reshape(-1, lk, heads, dh)
            s = self.prec.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
            if pad is not None:
                s = s.masked_fill(pad[sl][:, None, None, :], NEG)
            w = torch.softmax(s, dim=-1)
            if seed is not None and rate > 0.0:
                keep = attention_keep(seed, b0, qh.shape[0], heads, lq, lk,
                                      rate, q.device)
                w = torch.where(keep, w / (1.0 - rate), 0.0)
            outs.append(self.prec.einsum("bhqk,bkhd->bqhd", w, vh)
                        .reshape(-1, lq, d))
        return torch.cat(outs, 0)

    def mha(self, xq, xkv, pad, name, heads, rate, seeds):
        """An attention without LoRA (ViT, cross and fuse experts): the
        weights' seed is drawn after the projections, which draw none."""
        q = self.dense(xq, f"{name}.query")
        k = self.dense(xkv, f"{name}.key")
        v = self.dense(xkv, f"{name}.value")
        seed = None if _nodraw(rate, seeds) else seeds.draw()
        return self.dense(self.attend(q, k, v, pad, heads, rate, seed),
                          f"{name}.out")

    def mlp(self, x, name, act, rate_in, rate_out, seeds):
        h = act(self.dense(x, f"{name}.fc1"))
        h = drop(h, rate_in, seeds)
        return drop(self.dense(h, f"{name}.fc2"), rate_out, seeds)

    # -- text ---------------------------------------------------------------
    def bert_layer(self, x, pad, name, s: Optional[List[int]]):
        c = self.c
        eps = float(c["model.text.layer_norm_eps"])
        heads = int(c["model.text.num_heads"])
        rate_h = float(c["model.text.hidden_dropout"])
        rate_a = float(c["model.text.attention_dropout"])
        s = s or [None] * 5
        att = f"{name}.attention"
        q = self.proj(x, f"{att}.query", "query", s[0])
        k = self.proj(x, f"{att}.key", "key", None)
        v = self.proj(x, f"{att}.value", "value", s[1])
        a = self.dense(self.attend(q, k, v, pad, heads, rate_a, s[2]),
                       f"{att}.out")
        if s[3] is not None:
            a = dropped(a, s[3], rate_h)
        y = layer_norm(x + a, self.p, f"{name}.attention_norm", eps)
        h = self.dense(F.gelu(self.dense(y, f"{name}.mlp.fc1")),
                       f"{name}.mlp.fc2")
        if s[4] is not None:
            h = dropped(h, s[4], rate_h)
        return layer_norm(y + h, self.p, f"{name}.output_norm", eps)

    def layer_seeds(self, seeds) -> Optional[List[int]]:
        """A text layer's seeds in call order: query's and value's LoRA
        dropout, the attention weights, the attention output, the MLP
        output (None where a site does not drop)."""
        if seeds is None:
            return None
        c = self.c
        rl = float(c["model.text.lora_dropout"]) if self.rank > 0 else 0.0
        ra = float(c["model.text.attention_dropout"])
        rh = float(c["model.text.hidden_dropout"])
        out = []
        for target, rate in (("query", rl), ("value", rl)):
            out.append(seeds.draw() if rate > 0.0 and self.rank > 0
                       and target in self.lora_targets else None)
        out.append(seeds.draw() if ra > 0.0 else None)
        out.append(seeds.draw() if rh > 0.0 else None)
        out.append(seeds.draw() if rh > 0.0 else None)
        return out

    def text_encoder(self, tokens, pre, seeds, recompute: bool):
        c, p = self.c, self.p
        n, l = tokens.shape
        pad = tokens == int(c["model.text.pad_token_id"])
        x = (p[f"{pre}.word_embeddings.weight"][tokens]
             + p[f"{pre}.position_embeddings.weight"][:l][None]
             + p[f"{pre}.token_type_embeddings.weight"][0][None, None])
        x = layer_norm(x, p, f"{pre}.embeddings_norm",
                       float(c["model.text.layer_norm_eps"]))
        x = drop(x, float(c["model.text.hidden_dropout"]), seeds)
        for i in range(int(c["model.text.num_layers"])):
            s = self.layer_seeds(seeds)
            if recompute:
                x = checkpoint(self.bert_layer, x, pad, f"{pre}.layer_{i}", s,
                               use_reentrant=False)
            else:
                x = self.bert_layer(x, pad, f"{pre}.layer_{i}", s)
        return x

    @staticmethod
    def gather(h, sent_chunk, sent_tok):
        n, l, d = h.shape
        valid = (sent_chunk >= 0) & (sent_tok >= 0)
        idx = sent_chunk.clamp(0, n - 1).long() * l + sent_tok.clamp(0, l - 1).long()
        sent = h.reshape(n * l, d)[idx.reshape(-1)].reshape(*sent_chunk.shape, d)
        sent = torch.where(valid[..., None], sent, 0.0)
        mask = sent.abs().sum(-1) == 0.0
        lens = (~mask).float().sum(1, keepdim=True)
        doc = sent.sum(1) / lens.clamp_min(1.0)
        return sent, mask, doc

    def text_expert(self, side, batch, seeds, recompute):
        pre = f"{side}_expert"
        h = self.text_encoder(batch[f"{side}_tokens"], f"{pre}.encoder", seeds,
                              recompute)
        sent, mask, doc = self.gather(h, batch[f"{side}_sent_chunk"],
                                      batch[f"{side}_sent_tok"])
        if not self.home:
            rate = float(self.c["model.dropout"])
            sent = drop(layer_norm(sent, self.p, f"{pre}.norm", 1e-6), rate,
                        seeds)
            doc = drop(layer_norm(doc, self.p, f"{pre}.norm", 1e-6), rate,
                       seeds)
        return sent, mask, doc

    # -- image --------------------------------------------------------------
    def vit(self, patches_u8, has_image, seeds):
        c, p = self.c, self.p
        pre = "img_expert.backbone"
        dev = patches_u8.device
        mean = torch.tensor(IMAGENET_MEAN, device=dev).repeat_interleave(256)
        std = torch.tensor(IMAGENET_STD, device=dev).repeat_interleave(256)
        x = (patches_u8.float() / 255.0 - mean) / std
        x = torch.where(has_image[:, None, None] > 0, x, 0.0)
        x = self.dense(x, f"{pre}.patch_embed")
        cls = p[f"{pre}.cls_token"].expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], 1) + p[f"{pre}.pos_embed"]
        eps = float(c["model.image.layer_norm_eps"])
        heads = int(c["model.image.num_heads"])
        rh = float(c["model.image.hidden_dropout"])
        ra = float(c["model.image.attention_dropout"])
        x = drop(x, rh, seeds)
        for i in range(int(c["model.image.num_layers"])):
            name = f"{pre}.layer_{i}"
            h = layer_norm(x, p, f"{name}.norm1", eps)
            h = self.mha(h, h, None, f"{name}.attention", heads, ra, seeds)
            x = x + drop(h, rh, seeds)
            h = self.mlp(layer_norm(x, p, f"{name}.norm2", eps), f"{name}.mlp",
                         F.gelu, rh, rh, seeds)
            x = x + h
        return layer_norm(x, p, f"{pre}.final_norm", eps)

    def image_expert(self, batch, seeds):
        tokens = self.vit(batch["patches"], batch["has_image"], seeds)
        if self.home:
            img = tokens[:, 0]
            projected = self.mlp(img, "img_expert.projection_head", F.gelu,
                                 0.0, 0.0, seeds)
            return img, projected
        pool = self.c["model.image.pool_type"]
        vec = tokens.mean(1) if pool == "mean" else tokens[:, 0]
        vec = layer_norm(vec, self.p, "img_expert.norm", 1e-6)
        return drop(vec, float(self.c["model.dropout"]), seeds), None

    # -- cross and fuse experts ---------------------------------------------
    def prenorm(self, x, pad, name, heads, rate, seeds):
        h = layer_norm(x, self.p, f"{name}.norm1", 1e-6)
        h = self.mha(h, h, pad, f"{name}.self_attn", heads, rate, seeds)
        x = x + drop(h, rate, seeds)
        h = self.mlp(layer_norm(x, self.p, f"{name}.norm2", 1e-6),
                     f"{name}.mlp", F.relu, rate, rate, seeds)
        return x + h

    def cross_expert(self, u, um, i, im, seeds):
        c, p = self.c, self.p
        heads = int(c["model.cross_heads"])
        rate = float(c["model.dropout"])
        for k in range(int(c["model.cross_layers"])):
            u = self.prenorm(u, um, f"cross_ui.self_user_{k}", heads, rate,
                             seeds)
        for k in range(int(c["model.cross_layers"])):
            i = self.prenorm(i, im, f"cross_ui.self_item_{k}", heads, rate,
                             seeds)
        cross = self.mha(u, i, im, "cross_ui.cross_attn", heads, rate, seeds)
        alpha = torch.sigmoid(p["cross_ui.gate"])
        fused = alpha * u + (1.0 - alpha) * cross
        d = fused.shape[-1]
        s = torch.einsum("d,bld->bl", p["cross_ui.pool.query"], fused) \
            / math.sqrt(d)
        w = torch.softmax(s.masked_fill(um, NEG), dim=-1)
        if self.home:
            w = w.masked_fill(um.all(-1, keepdim=True), 0.0)
        w = drop(w, rate, seeds)
        pooled = torch.einsum("bl,bld->bd", w, fused)
        if self.home:
            return pooled
        normed = layer_norm(pooled, p, "cross_ui.norm", 1e-6)
        return normed + self.mlp(normed, "cross_ui.mlp", F.gelu, rate, rate,
                                 seeds)

    def fuse_expert(self, name, v, t, seeds):
        c, p = self.c, self.p
        heads = int(c["model.fuse_heads"])
        rate = float(c["model.dropout"])
        identity = layer_norm(self.dense(torch.cat([v, t], -1),
                                         f"{name}.res_proj"),
                              p, f"{name}.res_norm", 1e-6)
        x = torch.stack([v, t], 1)
        for k in range(int(c["model.fuse_depth"])):
            x = self.prenorm(x, None, f"{name}.layer_{k}", heads, rate, seeds)
        vf, tf = x[:, 0], x[:, 1]
        g = torch.sigmoid(self.dense(F.gelu(self.dense(
            torch.cat([vf, tf], -1), f"{name}.gate_fc1")), f"{name}.gate_fc2"))
        fused = g * vf + (1.0 - g) * tf
        if self.home:
            return fused + identity
        out = layer_norm(fused + identity, p, f"{name}.proj_norm", 1e-6)
        return drop(F.gelu(self.dense(out, f"{name}.proj_fc")), rate, seeds)

    # -- heads --------------------------------------------------------------
    def mmoe_head(self, vecs):
        query = vecs.mean(1)
        logits = []
        for task in ("good", "best"):
            w = torch.softmax(self.dense(query, f"head.gate_{task}.fc"), -1)
            x = torch.einsum("bn,bnd->bd", w, vecs)
            t = f"head.tower_{task}"
            x = F.gelu(self.dense(layer_norm(x, self.p, f"{t}.norm", 1e-6),
                                  f"{t}.fc1"))
            x = F.gelu(self.dense(x, f"{t}.fc2"))
            logits.append(self.dense(x, f"{t}.fc3").squeeze(-1))
        return logits

    def home_head(self, vecs, seeds):
        c, p = self.c, self.p
        b, n, d = vecs.shape
        proj = layer_norm(self.dense(vecs.reshape(b, n * d),
                                     "head.input_projection"),
                          p, "head.input_norm", 1e-6)
        shared = F.gelu(proj) + vecs.mean(1)
        counts = {"meta": int(c["model.home_shared_experts"]),
                  "good": int(c["model.home_task_experts"]),
                  "best": int(c["model.home_task_experts"])}
        rate_e = float(c["model.home_expert_dropout"])
        enhanced = {}
        for group, k in counts.items():
            g = self.dense(shared, f"head.fg_{group}.gate").reshape(b, k, d)
            inputs = shared[:, None, :] * (2.0 * torch.sigmoid(g))
            gate = torch.sigmoid(self.dense(shared, f"head.sg_{group}.gate"))
            enhanced[group] = [
                shared + gate * self.mlp(inputs[:, e],
                                         f"head.{group}_expert_{e}", F.gelu,
                                         rate_e, 0.0, seeds)
                for e in range(k)]
        weights = [torch.softmax(self.dense(shared, f"head.gate_{t}.fc"), -1)
                   for t in ("good", "best")]
        rate_t = float(c["model.home_tower_dropout"])
        logits = []
        for task, w in zip(("good", "best"), weights):
            experts = torch.stack(enhanced["meta"] + enhanced[task], 1)
            x = torch.einsum("bn,bnd->bd", w, experts)
            t = f"head.tower_{task}"
            x = F.gelu(self.dense(layer_norm(x, p, f"{t}.norm", 1e-6),
                                  f"{t}.fc1"))
            x = drop(x, rate_t, seeds)
            logits.append(self.dense(x, f"{t}.fc2").squeeze(-1))
        return logits

    def wrap(self, name, x, seeds, stats: Optional[Dict[str, torch.Tensor]]):
        """HoME's BatchNorm -> SiLU -> dropout on one expert vector.  With
        `stats` (training) the batch's statistics normalise and the running
        ones in `stats` move; without, the running ones in the params."""
        c = self.c
        eps = float(c["model.home_bn_eps"])
        m = float(c["model.home_bn_momentum"])
        pre = f"{name}_wrapper.norm"
        if stats is None:
            mean, var = self.p[f"{pre}.mean"], self.p[f"{pre}.var"]
        else:
            n = x.shape[0]
            mean = x.mean(0)
            var = x.var(0, unbiased=False)
            with torch.no_grad():
                stats[f"{pre}.mean"] = (1 - m) * stats[f"{pre}.mean"] \
                    + m * mean.detach()
                stats[f"{pre}.var"] = (1 - m) * stats[f"{pre}.var"] \
                    + m * var.detach() * (n / max(n - 1, 1))
        y = (x - mean) * torch.rsqrt(var + eps) * self.p[f"{pre}.weight"] \
            + self.p[f"{pre}.bias"]
        return drop(F.silu(y), float(c["model.dropout"]), seeds)

    # -- the model ------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor],
                seeds: Optional[SeedStream] = None, recompute: bool = False,
                stats: Optional[Dict[str, torch.Tensor]] = None):
        """(logit_good, logit_best, aux).  `seeds`: the micro-batch's dropout
        stream (training), None for the deterministic forward."""
        u_sent, u_mask, u_doc = self.text_expert("user", batch, seeds,
                                                 recompute)
        i_sent, i_mask, i_doc = self.text_expert("item", batch, seeds,
                                                 recompute)
        img_vec, projected = self.image_expert(batch, seeds)
        ui_vec = self.cross_expert(u_sent, u_mask, i_sent, i_mask, seeds)
        xui = self.fuse_expert("concat_ui", u_doc, img_vec, seeds)
        xti = self.fuse_expert("concat_ti", i_doc, img_vec, seeds)
        vecs = (u_doc, i_doc, img_vec, ui_vec, xui, xti)
        aux = dict(zip(EXPERTS, vecs))
        aux["projected_img"] = projected
        if self.home:
            vecs = [self.wrap(n, v, seeds, stats) for n, v in zip(EXPERTS, vecs)]
            good, best = self.home_head(torch.stack(vecs, 1), seeds)
        else:
            good, best = self.mmoe_head(torch.stack(vecs, 1))
        return good, best, aux


# -- losses -------------------------------------------------------------------

def weighted_bce(logits, labels, pos_weight):
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits)).mean()


def contrastive(anchor, positive, temperature):
    a = anchor * torch.rsqrt((anchor * anchor).sum(1, keepdim=True) + 1e-12)
    p = positive * torch.rsqrt((positive * positive).sum(1, keepdim=True)
                               + 1e-12)
    sim = (a @ p.T) / temperature
    return (torch.logsumexp(sim, 1) - sim.diagonal()).mean()


def loss(port: Dict[str, object], good, best, aux, batch) -> torch.Tensor:
    c = Cfg(port)
    main = (weighted_bce(good, batch["label_good"],
                         float(c["train.loss.pos_weight_good"]))
            + weighted_bce(best, batch["label_best"],
                           float(c["train.loss.pos_weight_best"])))
    if c["model.variant"] != "home":
        return main
    t = float(c["train.loss.temperature"])
    return main + (
        float(c["train.loss.lambda_cross"])
        * contrastive(aux["ui_vec"], aux["i_doc"], t)
        + float(c["train.loss.lambda_user_img"])
        * contrastive(aux["u_doc"], aux["projected_img"], t)
        + float(c["train.loss.lambda_item_img"])
        * contrastive(aux["i_doc"], aux["projected_img"], t))


# -- which parameters train -----------------------------------------------------

def label(name: str, variant: str, vit_layers: int, vit_unfrozen: int = 2
          ) -> str:
    """The optimizer group of a parameter (the published training recipe):
    LoRA factors; the cross, fuse and head modules and HoME's wrappers
    ("other"); HoME's projection head and last two ViT layers ("img_ft");
    everything else frozen."""
    parts = name.split(".")
    if "lora_a" in parts or "lora_b" in parts:
        return "lora"
    top = parts[0]
    if top in ("cross_ui", "concat_ui", "concat_ti", "head") or \
            top.endswith("_wrapper"):
        return "other"
    if variant == "home" and top == "img_expert":
        if "projection_head" in parts:
            return "img_ft"
        if any(f"layer_{i}" in parts
               for i in range(vit_layers - vit_unfrozen, vit_layers)):
            return "img_ft"
    return "frozen"


# -- the parameters' names, shapes and how the benchmark draws them ----------------

def _dense(out: List, name, fan_in, fan_out, bias=0.0, bias_std=0.02):
    out.append((f"{name}.weight", (fan_out, fan_in), ("normal", fan_in ** -0.5)))
    out.append((f"{name}.bias", (fan_out,),
                ("const", bias) if bias else ("normal", bias_std)))


def _ln(out: List, name, d):
    out.append((f"{name}.weight", (d,), ("const", 1.0)))
    out.append((f"{name}.bias", (d,), ("normal", 0.02)))


def _attn(out: List, name, d, lora: Tuple[str, ...] = (), rank=0):
    for t in ("query", "key", "value"):
        if t in lora and rank > 0:
            _dense(out, f"{name}.{t}.base", d, d)
            out.append((f"{name}.{t}.lora_a", (d, rank), ("normal", d ** -0.5)))
            out.append((f"{name}.{t}.lora_b", (rank, d), ("normal", 0.02)))
        else:
            _dense(out, f"{name}.{t}", d, d)
    _dense(out, f"{name}.out", d, d)


def _mlp(out: List, name, d, hidden, d_out=None):
    _dense(out, f"{name}.fc1", d, hidden)
    _dense(out, f"{name}.fc2", hidden, d_out or d)


def _prenorm(out: List, name, d):
    _ln(out, f"{name}.norm1", d)
    _attn(out, f"{name}.self_attn", d)
    _ln(out, f"{name}.norm2", d)
    _mlp(out, f"{name}.mlp", d, 4 * d)


def param_specs(port: Dict[str, object]) -> List[Tuple[str, tuple, tuple]]:
    """Every parameter (and HoME's BatchNorm statistics) as (name, shape,
    draw), draw being ("normal", std) or ("const", value)."""
    c = Cfg(port)
    home = c["model.variant"] == "home"
    d = int(c["model.text.hidden_size"])
    out: List = []
    lora = tuple(c["model.text.lora_targets"])
    rank = int(c["model.text.lora_rank"])
    for side in ("user", "item"):
        pre = f"{side}_expert.encoder"
        out.append((f"{pre}.word_embeddings.weight",
                    (int(c["model.text.vocab_size"]), d), ("normal", 0.02)))
        out.append((f"{pre}.position_embeddings.weight",
                    (int(c["model.text.max_position_embeddings"]), d),
                    ("normal", 0.02)))
        out.append((f"{pre}.token_type_embeddings.weight",
                    (int(c["model.text.type_vocab_size"]), d),
                    ("normal", 0.02)))
        _ln(out, f"{pre}.embeddings_norm", d)
        for i in range(int(c["model.text.num_layers"])):
            name = f"{pre}.layer_{i}"
            _attn(out, f"{name}.attention", d, lora, rank)
            _ln(out, f"{name}.attention_norm", d)
            _mlp(out, f"{name}.mlp", d, int(c["model.text.intermediate_size"]))
            _ln(out, f"{name}.output_norm", d)
        if not home:
            _ln(out, f"{side}_expert.norm", d)
    pre = "img_expert.backbone"
    di = int(c["model.image.hidden_size"])
    _dense(out, f"{pre}.patch_embed", int(c["model.image.patch_dim"]), di)
    out.append((f"{pre}.cls_token", (1, 1, di), ("normal", 0.02)))
    out.append((f"{pre}.pos_embed", (1, int(c["model.image.num_patches"]) + 1,
                                     di), ("normal", 0.02)))
    for i in range(int(c["model.image.num_layers"])):
        name = f"{pre}.layer_{i}"
        _ln(out, f"{name}.norm1", di)
        _attn(out, f"{name}.attention", di)
        _ln(out, f"{name}.norm2", di)
        _mlp(out, f"{name}.mlp", di, int(c["model.image.intermediate_size"]))
    _ln(out, f"{pre}.final_norm", di)
    if home:
        _mlp(out, "img_expert.projection_head", di, 2 * di)
    else:
        _ln(out, "img_expert.norm", di)
    for side in ("user", "item"):
        for k in range(int(c["model.cross_layers"])):
            _prenorm(out, f"cross_ui.self_{side}_{k}", d)
    _attn(out, "cross_ui.cross_attn", d)
    out.append(("cross_ui.gate", (1,), ("const", 0.5)))
    out.append(("cross_ui.pool.query", (d,), ("normal", d ** -0.5)))
    if not home:
        _ln(out, "cross_ui.norm", d)
        _mlp(out, "cross_ui.mlp", d, 4 * d)
    for name in ("concat_ui", "concat_ti"):
        _dense(out, f"{name}.res_proj", 2 * d, d)
        _ln(out, f"{name}.res_norm", d)
        for k in range(int(c["model.fuse_depth"])):
            _prenorm(out, f"{name}.layer_{k}", d)
        _dense(out, f"{name}.gate_fc1", 2 * d, d // 2)
        _dense(out, f"{name}.gate_fc2", d // 2, 1, bias=0.5)
        if not home:
            _ln(out, f"{name}.proj_norm", d)
            _dense(out, f"{name}.proj_fc", d, d)
    n = int(c["model.n_experts"])
    if home:
        for name in EXPERTS:
            pre = f"{name}_wrapper.norm"
            out.append((f"{pre}.weight", (d,), ("const", 1.0)))
            out.append((f"{pre}.bias", (d,), ("normal", 0.02)))
            out.append((f"{pre}.mean", (d,), ("const", 0.0)))
            out.append((f"{pre}.var", (d,), ("const", 1.0)))
        _dense(out, "head.input_projection", n * d, d)
        _ln(out, "head.input_norm", d)
        ks = int(c["model.home_shared_experts"])
        kt = int(c["model.home_task_experts"])
        hid = int(c["model.home_expert_hidden"])
        for group, k in (("meta", ks), ("good", kt), ("best", kt)):
            _dense(out, f"head.fg_{group}.gate", d, d * k)
        for group, k in (("meta", ks), ("good", kt), ("best", kt)):
            for e in range(k):
                _mlp(out, f"head.{group}_expert_{e}", d, hid)
        for group in ("meta", "good", "best"):
            _dense(out, f"head.sg_{group}.gate", d, d)
        for task in ("good", "best"):
            _dense(out, f"head.gate_{task}.fc", d, ks + kt)
        th = int(c["model.home_tower_hidden"])
        for task in ("good", "best"):
            t = f"head.tower_{task}"
            _ln(out, f"{t}.norm", d)
            _dense(out, f"{t}.fc1", d, th)
            _dense(out, f"{t}.fc2", th, 1)
    else:
        for task in ("good", "best"):
            _dense(out, f"head.gate_{task}.fc", d, n)
        th = int(c["model.tower_hidden"])
        for task in ("good", "best"):
            t = f"head.tower_{task}"
            _ln(out, f"{t}.norm", d)
            _dense(out, f"{t}.fc1", d, th)
            _dense(out, f"{t}.fc2", th, th // 2)
            _dense(out, f"{t}.fc3", th // 2, 1)
    return out


BUFFERS = (".mean", ".var")


def is_buffer(name: str) -> bool:
    """HoME's BatchNorm running statistics: state, not parameters."""
    return name.endswith(BUFFERS) and "_wrapper.norm" in name
