"""Convert torch/HF state_dicts into the JAX package's param tree layout,
and load reference checkpoints into the port's model.

Covers every module the reference checkpoints contain (ckpt keys
{user, item, img, cross_ui, concat_ui, concat_ti, head} + the six HoME BN
wrappers, ref train.py:351-363 / train_HoME.py:432-449), so the published
checkpoints (HF `jingxiang11111/mmoe-multimodal-rec` / `HoME-rec`) load
directly for AUC-parity evaluation.

All converters take a flat torch-style state_dict {name: numpy array} and
return nested param dicts in the JAX package's (flax) layout.  torch Linear
stores [out, in]; flax Dense kernels are [in, out] — transposed here, once,
on the host.

The converters are the PyTorch port's own copy of
mmoe_multimodal_rec_tpu/utils/hf_convert.py (numpy only).  The port's
modules are named after the JAX tree, so `load_reference_checkpoint`
reaches the model through utils/convert.params_from_jax, the one place
where names map.  With model.shared_text_base the two towers merge into
the shared-base `text_experts` tree (utils/shared_base.py), as the JAX
converter does; with text.scan_layers the tree stays unrolled, the
layout of the port's layers.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ImageEncoderConfig, TextEncoderConfig
from .convert import params_from_jax
from .shared_base import two_tower_to_shared

Params = Dict[str, object]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Mapping, prefix: str) -> Params:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Mapping, prefix: str) -> Params:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def strip_prefixes(sd: Mapping, prefixes: Tuple[str, ...]) -> Dict[str, object]:
    """Remove wrapper prefixes (peft 'base_model.model.', DDP 'module.', ...)."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def _maybe_lora_linear(sd: Mapping, prefix: str, lora: bool) -> Params:
    """HF/peft Linear (+ optional LoRA A/B) -> Dense or LoRADense params.

    peft names: `{prefix}.base_layer.weight`, `{prefix}.lora_A.default.weight`
    [r, in], `{prefix}.lora_B.default.weight` [out, r].
    """
    base_key = (f"{prefix}.base_layer.weight" if f"{prefix}.base_layer.weight"
                in sd else f"{prefix}.weight")
    base = {"kernel": _np(sd[base_key]).T}
    bias_key = base_key.replace("weight", "bias")
    if bias_key in sd:
        base["bias"] = _np(sd[bias_key])
    if not lora:
        return base
    out: Params = {"base": base}
    for peft_a in (f"{prefix}.lora_A.default.weight", f"{prefix}.lora_A.weight"):
        if peft_a in sd:
            out["lora_a"] = _np(sd[peft_a]).T
            out["lora_b"] = _np(sd[peft_a.replace("lora_A", "lora_B")]).T
            break
    else:
        # No trained LoRA in the checkpoint: keep fresh zeros-B semantics.
        d_in = base["kernel"].shape[0]
        out["lora_a"] = np.zeros((d_in, 1), np.float32)
        out["lora_b"] = np.zeros((1, base["kernel"].shape[1]), np.float32)
    return out


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def convert_bert(sd: Mapping, cfg: TextEncoderConfig) -> Params:
    """HF BertModel state_dict -> BertEncoder params (models/bert.py)."""
    sd = strip_prefixes(sd, ("base_model.model.", "model.", "bert."))
    lora = cfg.lora_rank > 0
    params: Params = {
        "word_embeddings": {"embedding": _np(sd["embeddings.word_embeddings.weight"])},
        "position_embeddings": {"embedding": _np(sd["embeddings.position_embeddings.weight"])},
        "token_type_embeddings": {"embedding": _np(sd["embeddings.token_type_embeddings.weight"])},
        "embeddings_norm": _layernorm(sd, "embeddings.LayerNorm"),
    }
    vocab_rows = params["word_embeddings"]["embedding"].shape[0]
    if vocab_rows < cfg.vocab_size:
        # resize_token_embeddings for "<SENT>" (ref model.py:598): new rows
        # init from the embedding mean like HF does.
        emb = params["word_embeddings"]["embedding"]
        extra = np.tile(emb.mean(0, keepdims=True), (cfg.vocab_size - vocab_rows, 1))
        params["word_embeddings"]["embedding"] = np.concatenate([emb, extra], 0)
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": _maybe_lora_linear(sd, f"{p}.attention.self.query",
                                            lora and "query" in cfg.lora_targets),
                "key": _maybe_lora_linear(sd, f"{p}.attention.self.key",
                                          lora and "key" in cfg.lora_targets),
                "value": _maybe_lora_linear(sd, f"{p}.attention.self.value",
                                            lora and "value" in cfg.lora_targets),
                "out": _linear(sd, f"{p}.attention.output.dense"),
            },
            "attention_norm": _layernorm(sd, f"{p}.attention.output.LayerNorm"),
            "mlp": {"fc1": _linear(sd, f"{p}.intermediate.dense"),
                    "fc2": _linear(sd, f"{p}.output.dense")},
            "output_norm": _layernorm(sd, f"{p}.output.LayerNorm"),
        }
    return params


def convert_vit(sd: Mapping, cfg: ImageEncoderConfig) -> Params:
    """HF ViTModel state_dict -> ViTEncoder params (models/vit.py).

    The patch-embedding Conv2d(3, D, 16, 16) kernel [D, 3, 16, 16] flattens to
    a Dense kernel [768, D]: its (in_c, kh, kw) row-major flattening matches
    the stored patch-row byte order (newpatch.py:102-104).
    """
    sd = strip_prefixes(sd, ("vit_model.", "backbone.", "vit."))
    conv_w = _np(sd["embeddings.patch_embeddings.projection.weight"])
    d = conv_w.shape[0]
    params: Params = {
        "cls_token": _np(sd["embeddings.cls_token"]),
        "pos_embed": _np(sd["embeddings.position_embeddings"]),
        "patch_embed": {
            "kernel": conv_w.reshape(d, -1).T,
            "bias": _np(sd["embeddings.patch_embeddings.projection.bias"]),
        },
        "final_norm": _layernorm(sd, "layernorm"),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "norm1": _layernorm(sd, f"{p}.layernorm_before"),
            "attention": {
                "query": _linear(sd, f"{p}.attention.attention.query"),
                "key": _linear(sd, f"{p}.attention.attention.key"),
                "value": _linear(sd, f"{p}.attention.attention.value"),
                "out": _linear(sd, f"{p}.attention.output.dense"),
            },
            "norm2": _layernorm(sd, f"{p}.layernorm_after"),
            "mlp": {"fc1": _linear(sd, f"{p}.intermediate.dense"),
                    "fc2": _linear(sd, f"{p}.output.dense")},
        }
    return params


# ---------------------------------------------------------------------------
# torch MultiheadAttention / TransformerEncoderLayer (cross & fuse experts)
# ---------------------------------------------------------------------------

def _mha(sd: Mapping, prefix: str) -> Params:
    """torch nn.MultiheadAttention -> models/layers.Attention params."""
    w = _np(sd[f"{prefix}.in_proj_weight"])           # [3d, d]
    b = _np(sd[f"{prefix}.in_proj_bias"])             # [3d]
    d = w.shape[1]
    return {
        "query": {"kernel": w[:d].T, "bias": b[:d]},
        "key": {"kernel": w[d:2 * d].T, "bias": b[d:2 * d]},
        "value": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
        "out": _linear(sd, f"{prefix}.out_proj"),
    }


def _prenorm_block(sd: Mapping, prefix: str) -> Params:
    """torch TransformerEncoderLayer -> models/layers.PreNormBlock params."""
    return {
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "self_attn": _mha(sd, f"{prefix}.self_attn"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "mlp": {"fc1": _linear(sd, f"{prefix}.linear1"),
                "fc2": _linear(sd, f"{prefix}.linear2")},
    }


# ---------------------------------------------------------------------------
# Experts & heads (reference checkpoint keys)
# ---------------------------------------------------------------------------

def convert_text_expert(sd: Mapping, cfg: TextEncoderConfig,
                        final_norm: bool = True) -> Params:
    """Reference TextExpert state_dict (model.py:214-221: `encoder.*` peft
    model + `norm.*`) -> models/text_expert.TextExpert params."""
    sd = strip_prefixes(sd, ("module.",))
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    params: Params = {"encoder": convert_bert(enc_sd, cfg)}
    if final_norm and "norm.weight" in sd:
        params["norm"] = _layernorm(sd, "norm")
    return params


def convert_image_expert(sd: Mapping, cfg: ImageEncoderConfig) -> Params:
    """Reference ItemImageExpert (model.py:343-364: `backbone.*` + `norm.*`)."""
    sd = strip_prefixes(sd, ("module.",))
    bb = {k[len("backbone."):]: v for k, v in sd.items()
          if k.startswith("backbone.")}
    return {"backbone": convert_vit(bb, cfg), "norm": _layernorm(sd, "norm")}


def convert_image_expert_with_projection(sd: Mapping,
                                         cfg: ImageEncoderConfig) -> Params:
    """HoME ImageExpertWithProjection (model_HoME.py:373-399)."""
    sd = strip_prefixes(sd, ("module.",))
    vit_sd = {k[len("vit_model."):]: v for k, v in sd.items()
              if k.startswith("vit_model.")}
    return {
        "backbone": convert_vit(vit_sd, cfg),
        "projection_head": {"fc1": _linear(sd, "projection_head.0"),
                            "fc2": _linear(sd, "projection_head.2")},
    }


def convert_cross_expert(sd: Mapping, n_layers: int = 2,
                         final_mlp: bool = True) -> Params:
    """RobustTextCrossExpert (model.py:386-424)."""
    sd = strip_prefixes(sd, ("module.",))
    params: Params = {}
    for i in range(n_layers):
        params[f"self_user_{i}"] = _prenorm_block(sd, f"self_user.{i}")
        params[f"self_item_{i}"] = _prenorm_block(sd, f"self_item.{i}")
    params["cross_attn"] = _mha(sd, "cross_attn")
    params["gate"] = _np(sd["gate"])
    params["pool"] = {"query": _np(sd["pool.query"]).reshape(-1)}
    if final_mlp:
        params["norm"] = _layernorm(sd, "norm")
        params["mlp"] = {"fc1": _linear(sd, "mlp.0"),
                         "fc2": _linear(sd, "mlp.3")}
    return params


def convert_fuse_expert(sd: Mapping, depth: int = 2,
                        final_proj: bool = True) -> Params:
    """EnhancedCrossFuse (model.py:454-489)."""
    sd = strip_prefixes(sd, ("module.",))
    params: Params = {}
    for i in range(depth):
        params[f"layer_{i}"] = _prenorm_block(sd, f"layers.{i}")
    params["res_proj"] = _linear(sd, "res_proj.0")
    params["res_norm"] = _layernorm(sd, "res_proj.1")
    params["gate_fc1"] = _linear(sd, "gate.0")
    params["gate_fc2"] = _linear(sd, "gate.2")
    if final_proj:
        params["proj_norm"] = _layernorm(sd, "proj.0")
        params["proj_fc"] = _linear(sd, "proj.1")
    return params


def convert_two_task_head(sd: Mapping) -> Params:
    """TwoTaskMMoE (model.py:527-557). Towers are Sequential
    (LN,Linear,GELU,Drop,Linear,GELU,Drop,Linear) -> indices 0,1,4,7."""
    sd = strip_prefixes(sd, ("module.",))

    def tower(p):
        return {"norm": _layernorm(sd, f"{p}.0"),
                "fc1": _linear(sd, f"{p}.1"),
                "fc2": _linear(sd, f"{p}.4"),
                "fc3": _linear(sd, f"{p}.7")}

    return {
        "gate_good": {"fc": _linear(sd, "gate_good.fc")},
        "gate_best": {"fc": _linear(sd, "gate_best.fc")},
        "tower_good": tower("tower_good"),
        "tower_best": tower("tower_best"),
    }


def convert_home_head(sd: Mapping, n_shared: int = 4, n_task: int = 2) -> Params:
    """HOME_MMoE_Complete (model_HoME.py:530-588). ExpertMLP Sequential
    (Linear,GELU,Drop,Linear) -> 0,3; tower (LN,Linear,GELU,Drop,Linear)
    -> 0,1,4; input_projection (Linear,LN,GELU) -> 0,1."""
    sd = strip_prefixes(sd, ("module.",))

    def expert(p):
        return {"fc1": _linear(sd, f"{p}.0"), "fc2": _linear(sd, f"{p}.3")}

    def tower(p):
        return {"norm": _layernorm(sd, f"{p}.0"),
                "fc1": _linear(sd, f"{p}.1"),
                "fc2": _linear(sd, f"{p}.4")}

    params: Params = {
        "input_projection": _linear(sd, "input_projection.0"),
        "input_norm": _layernorm(sd, "input_projection.1"),
        "fg_meta": {"gate": _linear(sd, "fg_meta.gate")},
        "fg_good": {"gate": _linear(sd, "fg_good.gate")},
        "fg_best": {"gate": _linear(sd, "fg_best.gate")},
        "sg_meta": {"gate": _linear(sd, "sg_meta.gate.0")},
        "sg_good": {"gate": _linear(sd, "sg_good.gate.0")},
        "sg_best": {"gate": _linear(sd, "sg_best.gate.0")},
        "gate_good": {"fc": _linear(sd, "gate_good.fc")},
        "gate_best": {"fc": _linear(sd, "gate_best.fc")},
        "tower_good": tower("tower_good"),
        "tower_best": tower("tower_best"),
    }
    for i in range(n_shared):
        params[f"meta_expert_{i}"] = expert(f"meta_experts.{i}")
    for i in range(n_task):
        params[f"good_expert_{i}"] = expert(f"task_experts_good.{i}")
        params[f"best_expert_{i}"] = expert(f"task_experts_best.{i}")
    return params


def convert_bn_wrapper(sd: Mapping) -> Tuple[Params, Params]:
    """HomeExpertWrapper (train_HoME.py:100-116) -> (params, batch_stats)."""
    sd = strip_prefixes(sd, ("module.",))
    params = {"norm": {"scale": _np(sd["norm.weight"]),
                       "bias": _np(sd["norm.bias"])}}
    stats = {"norm": {"mean": _np(sd["norm.running_mean"]),
                      "var": _np(sd["norm.running_var"])}}
    return params, stats


# ---------------------------------------------------------------------------
# Whole-checkpoint conversion
# ---------------------------------------------------------------------------

def convert_reference_checkpoint(ckpt: Mapping, model_cfg,
                                 ) -> Tuple[Params, Optional[Params]]:
    """Reference torch checkpoint dict (train.py:351-363 /
    train_HoME.py:432-449 layout) -> (params, batch_stats) for MMoERecModel.
    """
    home = model_cfg.variant == "home"
    params: Params = {
        "user_expert": convert_text_expert(ckpt["user"], model_cfg.text,
                                           final_norm=not home),
        "item_expert": convert_text_expert(ckpt["item"], model_cfg.text,
                                           final_norm=not home),
        "cross_ui": convert_cross_expert(ckpt["cross_ui"],
                                         model_cfg.cross_layers,
                                         final_mlp=not home),
        "concat_ui": convert_fuse_expert(ckpt["concat_ui"],
                                         model_cfg.fuse_depth,
                                         final_proj=not home),
        "concat_ti": convert_fuse_expert(ckpt["concat_ti"],
                                         model_cfg.fuse_depth,
                                         final_proj=not home),
    }
    stats: Params = {}
    if home:
        params["img_expert"] = convert_image_expert_with_projection(
            ckpt["img"], model_cfg.image)
        params["head"] = convert_home_head(ckpt["head"],
                                           model_cfg.home_shared_experts,
                                           model_cfg.home_task_experts)
        for key in ("u_doc_wrapper", "i_doc_wrapper", "img_vec_wrapper",
                    "ui_vec_wrapper", "xui_wrapper", "xti_wrapper"):
            p, s = convert_bn_wrapper(ckpt[key])
            params[key] = p
            stats[key] = s
    else:
        params["img_expert"] = convert_image_expert(ckpt["img"],
                                                    model_cfg.image)
        params["head"] = convert_two_task_head(ckpt["head"])
    # text.scan_layers: the port keeps its layers unrolled, so the tree
    # stays as it is (the JAX converter stacks it, utils/scan_convert.py)
    if getattr(model_cfg, "shared_text_base", False):
        # one text_experts subtree (models/text_expert.DualTextExpert);
        # exact, and raises if the two towers' frozen bases diverge
        params = _unflatten(two_tower_to_shared(_flatten(params)))
    return params, (stats or None)


# ---------------------------------------------------------------------------
# Into the port's model
# ---------------------------------------------------------------------------

def _flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Params:
    tree: Params = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _load_named(own: Mapping[str, torch.Tensor],
                state: Mapping[str, torch.Tensor]) -> Tuple[list, list]:
    """Copy every tensor of `state` whose name and shape `own` has into it;
    (missing, unexpected) as the JAX package's `load_into` counts them: a
    shape mismatch is unexpected and keeps the model's value."""
    missing = [k for k in own if k not in state]
    unexpected = []
    with torch.no_grad():
        for k, v in state.items():
            if k not in own:
                unexpected.append(k)
            elif tuple(v.shape) != tuple(own[k].shape):
                unexpected.append(f"{k} (shape {tuple(v.shape)} != "
                                  f"{tuple(own[k].shape)})")
            else:
                own[k].copy_(v)
    return missing, unexpected


def load_reference_checkpoint(model: torch.nn.Module, ckpt: Mapping,
                              model_cfg, log=print
                              ) -> Tuple[List[str], List[str]]:
    """Non-strict load of a reference torch checkpoint dict (train.py:
    351-363 / train_HoME.py:432-449 layout) into the port's unmerged
    MMoERecModel, in place, with the missing/unexpected report the JAX CLI
    prints (infer_auc_HoME:47-56 behaviour): what the checkpoint lacks
    keeps the model's current (init) value.  Returns the parameters'
    (missing, unexpected)."""
    converted, stats = convert_reference_checkpoint(ckpt, model_cfg)
    state = params_from_jax(_flatten(converted), model_cfg, merge_lora=False)
    missing, unexpected = _load_named(dict(model.named_parameters()), state)
    for key in missing[:20]:
        log(f"[ckpt] missing: {key}")
    for key in unexpected[:20]:
        log(f"[ckpt] unexpected: {key}")
    log(f"[ckpt] loaded: {len(missing)} missing, {len(unexpected)} "
        "unexpected")
    if stats:
        stats_state = {k.replace("/", "."): torch.tensor(
            np.asarray(v, np.float32)) for k, v in _flatten(stats).items()}
        s_missing, s_unexp = _load_named(dict(model.named_buffers()),
                                         stats_state)
        log(f"[ckpt] batch_stats: {len(s_missing)} missing, {len(s_unexp)} "
            "unexpected")
    return missing, unexpected
