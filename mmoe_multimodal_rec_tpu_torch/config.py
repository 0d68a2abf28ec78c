"""Single dataclass config tree for the whole framework (the PyTorch
port's own copy of mmoe_multimodal_rec_tpu/config.py, field for field, so
both packages parse the same `--a.b=c` flags into the same tree).

Replaces the reference's per-script argparse sprawl and hardcoded constants
(ref: train.py:86-99,143-148,189-191; train_HoME.py:127-145,204-209;
infer_auc_HoME:166,243-256) with one serializable tree plus CLI overrides
(`Config.from_flags`).  Every constant the reference buries in code is a field
here with the reference value as default.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass
class TextEncoderConfig:
    """BGE-base (BERT-base) encoder config (ref model.py:585-620 uses
    BAAI/bge-base-en-v1.5, a standard 12-layer post-LN BERT)."""
    vocab_size: int = 30523          # 30522 + "<SENT>" (ref train.py:103)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    # LoRA (ref model.py:592-599: r=8, alpha=32, dropout=0.1 on query/value)
    lora_rank: int = 8
    # lax.scan ONE compiled layer body over stacked [num_layers, ...] params
    # instead of unrolling num_layers copies into the HLO: identical math
    # (tests/test_scan_layers.py), measured 1.9x faster cold compile of the
    # flagship train step (302 -> 162 s) at a 20% step-time cost (136 ->
    # 109 ex/s — scan serializes the per-layer weight slices XLA otherwise
    # prefetches across layers); an edit-compile-run iteration knob, NOT the
    # production default (BENCHMARKS.md "Compile time").  Param layout
    # changes to `encoder/layers/layer/...`; utils/scan_convert.py converts
    # existing unrolled checkpoints.  Text encoders only — the HoME ViT
    # keeps its unrolled layout because its last-2-layers finetune partition
    # (train/optimizer.label_param) splits at layer granularity.
    scan_layers: bool = False
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1
    lora_targets: Tuple[str, ...] = ("query", "value")
    # Fuse the LoRA input dropout into the thin matmuls via the Pallas op
    # (ops/lora_dropout.py): the mask regenerates in-kernel from the TPU
    # hardware PRNG, so the dropped [N*L, D] tensor is never materialized
    # (the plain-XLA formulation costs ~32-48 ms/step at the bench shape,
    # BENCHMARKS.md "Round-5 experiment log").  Same iid-Bernoulli
    # semantics, different mask stream; auto-falls back off-TPU.
    lora_fused_dropout: bool = True


@dataclass
class ImageEncoderConfig:
    """ViT-base-patch16-224 config (ref model.py:623-628).

    TPU-native difference: the expert consumes the WebDataset patch rows
    [196, 768] directly (the offline pipeline already patchified the image,
    newpatch.py:102-104); the patch-embedding conv collapses to one matmul, so
    the reference's reconstruct-image-then-re-patchify round trip
    (model.py:168-171) is never executed on device.
    """
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_patches: int = 196           # 14x14 grid of 16x16 patches
    patch_dim: int = 768             # 3*16*16 flattened (C, ph, pw) bytes
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.0      # HF ViT default
    attention_dropout: float = 0.0
    pool_type: str = "mean"          # "mean" | "cls" (ref train.py:125)


@dataclass
class PackerConfig:
    """Static-shape replacement for preprocess_batch (ref model.py:29-117).

    The reference emits batch-dependent [N_chunks, max_chunk_len] /
    [N_chunks, max_sents_per_chunk]; under XLA those dynamic shapes would
    recompile every step, so we pad to the caps that already exist in the
    reference: 4 chunks/sample, 384 tokens/chunk, 64 sentences/sample.
    """
    max_tok: int = 384               # tokens per chunk incl. [CLS]/[SEP]
    max_chunks_per_sample: int = 4
    fixed_sent_count: int = 64       # ref model.py:34 (comment says 128; code fixes 64)
    # Flat chunk budget per batch side (user or item). The reference allots
    # exactly B*max_chunks rows; real text mostly packs into 1-2 chunks, so a
    # tighter budget (e.g. 2*B) saves encoder FLOPs while staying static.
    # None -> batch_size * max_chunks_per_sample (exact reference shape).
    chunk_budget: Optional[int] = None
    sent_token: str = "<SENT>"


@dataclass
class ModelConfig:
    d: int = 768
    n_experts: int = 6
    # RobustTextCrossExpert (ref model.py:386-451)
    cross_layers: int = 2
    cross_heads: int = 8
    # EnhancedCrossFuse (ref model.py:454-507)
    fuse_depth: int = 2
    fuse_heads: int = 8
    dropout: float = 0.1
    # TwoTaskMMoE towers (ref model.py:537-557)
    tower_hidden: int = 256
    tower_dropout: float = 0.0
    # Expert gating: "dense" = reference parity (model.py:513-524);
    # "topk" = sparse top-k routing + Switch load-balance aux, the future
    # work the reference README (:672) names (opt-in, changes numerics)
    gate_type: str = "dense"
    gate_topk: int = 2
    # HoME head (ref model_HoME.py:530-588; trainer overrides tower=512)
    home_shared_experts: int = 4
    home_task_experts: int = 2
    home_tower_hidden: int = 512
    home_expert_hidden: int = 1024
    home_expert_dropout: float = 0.1
    home_tower_dropout: float = 0.1
    home_bn_momentum: float = 0.1    # torch BatchNorm1d default
    home_bn_eps: float = 1e-5
    variant: str = "baseline"        # "baseline" | "home"
    # Run both text experts as ONE encoder pass over the concatenated
    # [user; item] chunk batch: one shared frozen BGE base + per-side LoRA
    # adapters (models/text_expert.DualTextExpert).  Mathematically
    # identical to the two-tower layout whenever the two base trees are
    # equal — which the reference workflow guarantees (both towers load the
    # same pretrained encoder and the base is frozen, ref train.py:118-123,
    # 151-186; exactness tested in tests/test_shared_base.py).  Halves the
    # encoder matmul launches and runs them at 2x M (+~20% MXU rate on the
    # [M,768]x[768,768] projections, BENCHMARKS.md "shared text base"),
    # and drops one full frozen base copy from HBM.  Param layout changes
    # (text_experts/...); utils/shared_base.py converts checkpoints both
    # ways.  Default off = exact reference checkpoint layout.
    shared_text_base: bool = False
    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    image: ImageEncoderConfig = field(default_factory=ImageEncoderConfig)
    packer: PackerConfig = field(default_factory=PackerConfig)
    # numerics
    compute_dtype: str = "bfloat16"  # replaces CUDA AMP fp16 (ref train.py:241)
    param_dtype: str = "float32"
    use_flash_attention: bool = True # Pallas fused attention on TPU
    remat: bool = False              # jax.checkpoint each encoder layer
                                     # (HBM <-> FLOPs trade, SURVEY build note)
    remat_policy: str = "quant"      # "full" (recompute all) | "dots" (save
                                     # every dot output; too big at prod
                                     # batch) | "attn" (save the
                                     # post-attention residual only — skips
                                     # the attention-kernel + out-proj
                                     # recompute) | "quant" ("attn" + int8
                                     # saves of q/k/v + fc1 preact: backward
                                     # dequantizes instead of recomputing the
                                     # 7D^2/layer of matmuls — fastest
                                     # measured, production default; see
                                     # models/layers.resolve_remat_policy)
                                     # | "quant4" ("quant" with the fc1
                                     # preact packed to int4 — half that
                                     # save's HBM traffic; convergence-gated
                                     # in tests/test_quant_convergence.py)


@dataclass
class OptimConfig:
    """AdamW groups + freeze->warmup schedule (ref train.py:143-186)."""
    lr: float = 2e-5
    weight_decay: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    grad_accum: int = 8
    # LoRA freeze/warmup in *optimizer* steps (ref train.py:145-148)
    freeze_steps: int = 2_000
    unfreeze_steps: int = 1_200
    # HoME overrides (ref train_HoME.py:204-209)
    home_freeze_steps: int = 2_400
    home_unfreeze_steps: int = 1_600


@dataclass
class LossConfig:
    # BCE pos_weights hardcoded in the reference (train.py:189-191)
    pos_weight_good: float = 858_627 / 990_303
    pos_weight_best: float = 1_328_721 / 520_209
    # HoME contrastive aux losses (ref train_HoME.py:140-143, 360-368)
    lambda_cross: float = 0.1
    lambda_user_img: float = 0.1
    lambda_item_img: float = 0.1
    temperature: float = 0.07
    # weight on the top-k gate load-balance aux (only with gate_type=topk)
    lambda_gate_balance: float = 0.01


@dataclass
class MeshConfig:
    """Device mesh for SPMD. The reference's only parallelism is 2-GPU DDP
    (SURVEY §2f); here DP rides the `data` axis and optional tensor
    parallelism rides `model` (attention heads / FFN shards), with XLA
    inserting psum/all-gather over ICI."""
    data_axis: str = "data"
    model_axis: str = "model"
    # n_data x n_model; (None, 1) -> all devices on data.
    data_parallel: Optional[int] = None
    model_parallel: int = 1


@dataclass
class TrainConfig:
    batch_size: int = 128            # per-device micro batch (ref README 128/GPU)
    epochs: int = 4
    steps_per_epoch: int = 5_600     # micro-steps (ref train.py:143,218)
    home_steps_per_epoch: int = 7_200
    seed: int = 0
    log_every: int = 8
    checkpoint_dir: str = "./outputs/ckpt"
    output_dir: str = "./outputs"
    resume: bool = True              # the reference can only save (SURVEY §5)
    checkpoint_every: int = 0        # mid-epoch ckpt every N optimizer steps
                                     # (0 = per-epoch only); each carries the
                                     # exact resume position
    eval_every: int = 0              # mid-training validation AUC every N
                                     # optimizer steps over data.valid_pattern
                                     # (0 = off; reference has no in-training
                                     # eval at all)
    eval_max_batches: int = 0        # cap streamed eval batches per
                                     # mid-training eval (0 = full pass)
    # PRNG impl for dropout streams: "rbg" is far cheaper than threefry on
    # TPU and dropout needs no cross-impl reproducibility.
    rng_impl: str = "rbg"
    # jax.profiler tracing (reference has none — SURVEY §5): capture steps
    # [profile_start, profile_start + profile_steps) of the first epoch.
    profile: bool = False
    profile_dir: str = "./outputs/profile"
    profile_start: int = 3
    profile_steps: int = 3
    # Extra XLA options for the step compiles (train step, eval/BN-recal
    # steps, serving forward — forwarded to jax.jit's compiler_options):
    # the surface for TPU scheduling/fusion knobs, e.g.
    # {"xla_tpu_scoped_vmem_limit_kib": "65536"}.  CLI:
    # --train.compiler_options='{"k": "v"}'.  None = compiler defaults.
    compiler_options: Optional[dict] = None
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass
class DataConfig:
    train_pattern: str = ""
    valid_pattern: str = ""
    shuffle_buffer: int = 512        # ref train.py:52
    shard_shuffle: bool = True
    num_prefetch: int = 4            # host->device pipeline depth
    num_tokenizer_threads: int = 2
    vocab_path: Optional[str] = None # WordPiece vocab.txt (BGE/BERT format)
    # Guard against silently tokenizing REAL text with the deterministic
    # hash stand-in (data/wordpiece.HashTokenizer): production entry points
    # (train/eval/serve/pretokenize) ERROR when vocab_path is unset unless
    # this is explicitly true (synthetic corpora / tests / benchmarks).
    # The reference always loads a real vocab (ref train.py:102-103).
    allow_hash_tokenizer: bool = False
    on_shard_error: str = "skip"     # train loader: "skip" (log + continue
                                     # past a corrupt shard) or "raise";
                                     # eval is always strict
    # feature-engineering knobs (ref data4moe_beam.py)
    neg_k: int = 5
    five_star_keep_rate: float = 0.2
    train_end: str = "2023-06-30"
    valid_end: str = "2023-09-30"
    all_pids_sample: int = 10_000
    samples_per_shard: int = 1024    # ref data4model.py:315


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    # ---- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return _from_dict(cls, d)

    def override(self, **dotted: Any) -> "Config":
        """Return a new Config with dotted-path overrides, e.g.
        cfg.override(**{"train.batch_size": 32, "model.variant": "home"})."""
        d = self.to_dict()
        # An explicitly-set epoch length wins for BOTH variants: the two
        # defaults mirror the reference's separate training-script hardcodes
        # (train.py:143 5600 vs train_HoME.py's 7200), but a user passing
        # --train.steps_per_epoch=N with --model.variant=home means N —
        # silently running 7200 micro-steps instead is a footgun.
        if ("train.steps_per_epoch" in dotted
                and "train.home_steps_per_epoch" not in dotted):
            dotted = dict(dotted,
                          **{"train.home_steps_per_epoch":
                             dotted["train.steps_per_epoch"]})
        for key, val in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config field: {key}")
            node[parts[-1]] = val
        return Config.from_dict(d)

    @classmethod
    def from_flags(cls, argv: Sequence[str]) -> "Config":
        """Parse `--a.b.c=value` style overrides from a CLI arg list."""
        cfg = cls()
        overrides = {}
        for arg in argv:
            if not arg.startswith("--") or "=" not in arg:
                raise ValueError(f"expected --path.to.field=value, got {arg!r}")
            key, _, raw = arg[2:].partition("=")
            try:
                val = json.loads(raw)
            except json.JSONDecodeError:
                val = raw
            overrides[key] = val
        return cfg.override(**overrides) if overrides else cfg


def tiny_config(variant: str = "baseline", batch_size: int = 4,
                accum: int = 2, data_parallel: int = 2,
                model_parallel: int = 1) -> Config:
    """Small-dims config for tests / multi-chip dryruns (full architecture,
    tiny widths)."""
    cfg = Config()
    m = cfg.model
    m.variant = variant
    m.d = 32
    m.compute_dtype = "float32"
    m.use_flash_attention = False
    m.cross_heads = 4
    m.fuse_heads = 4
    m.tower_hidden = 16
    m.home_tower_hidden = 16
    m.home_expert_hidden = 24
    t = m.text
    t.vocab_size = 201
    t.hidden_size = 32
    t.num_layers = 2
    t.num_heads = 4
    t.intermediate_size = 64
    t.max_position_embeddings = 48
    t.lora_rank = 2
    i = m.image
    i.hidden_size = 32
    i.num_layers = 2
    i.num_heads = 4
    i.intermediate_size = 64
    p = m.packer
    p.max_tok = 24
    p.max_chunks_per_sample = 2
    p.fixed_sent_count = 6
    tr = cfg.train
    tr.batch_size = batch_size
    tr.optim.grad_accum = accum
    tr.optim.freeze_steps = 2
    tr.optim.unfreeze_steps = 2
    tr.optim.home_freeze_steps = 2
    tr.optim.home_unfreeze_steps = 2
    tr.mesh.data_parallel = data_parallel
    tr.mesh.model_parallel = model_parallel
    cfg.data.allow_hash_tokenizer = True   # tests run on synthetic corpora
    return cfg


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            ftype = f.type if not isinstance(f.type, str) else None
            default = f.default_factory() if f.default_factory is not dataclasses.MISSING else None
            if dataclasses.is_dataclass(default):
                v = _from_dict(type(default), v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)
