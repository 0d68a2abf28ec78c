"""The port's training layer (mmoe_multimodal_rec_tpu_torch/train and the
dropout of models/layers) against the JAX package's, on the CPU, fp32.

Tolerances: dropout masks bit for bit; losses and schedule values within
1e-6 relative (the same fp32 formulas); an AdamW + clip update within 1e-6
(optax and torch order the same few operations differently); a whole
training step within 1e-5 on the loss and 1e-4 relative on grad_norm (the
model's sums run in another order, as in tests/test_torch_model.py) and
1e-6 on every updated parameter.  That step runs AdamW at eps 1 and lr
0.1: its first update is then 0.1 * g / (|g| + 1), nearly linear in the
gradient, so the parameters hold every gradient to about 1e-5.  (At the
default eps 1e-8 the first update is lr * sign(g), which would blow the
rounding noise of exactly-zero gradients, such as a key bias's, up to lr.)"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from mmoe_multimodal_rec_tpu.models import layers as jlayers
from mmoe_multimodal_rec_tpu.models.mmoe import MMoERecModel as JModel
from mmoe_multimodal_rec_tpu.train import losses as jlosses
from mmoe_multimodal_rec_tpu.train import optimizer as jopt
from mmoe_multimodal_rec_tpu.train.step import TrainState, make_train_step
from mmoe_multimodal_rec_tpu_torch import cli
from mmoe_multimodal_rec_tpu_torch.config import Config as TConfig
from mmoe_multimodal_rec_tpu_torch.models import layers as tlayers
from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel
from mmoe_multimodal_rec_tpu_torch.train import losses as tlosses
from mmoe_multimodal_rec_tpu_torch.train import optimizer as topt
from mmoe_multimodal_rec_tpu_torch.train.checkpoint import (
    CheckpointManager, frozen_fingerprint)
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer, dummy_batch
from mmoe_multimodal_rec_tpu_torch.utils.convert import params_from_jax
from util import stacked_batch, tiny_cli_flags, tiny_config

import chip_smoke

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)


def _port_cfg(cfg):
    return TConfig.from_dict(cfg.to_dict())


def _jax_variables(cfg, seed):
    """Flat '/'-keyed numpy params of the JAX model, every leaf non-zero,
    and its batch_stats (HoME's BatchNorm statistics; empty for the
    baseline): running means N(0, 0.1^2), variances in [0.5, 1.5]."""
    micro = {k: v[0] for k, v in stacked_batch(cfg, seed=0).items()}
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            micro)
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in traverse_util.flatten_dict(shapes["params"]).items():
        std = leaf.shape[-2] ** -0.5 if key[-1] == "kernel" else 0.1
        v = rng.normal(0, std, leaf.shape)
        out["/".join(key)] = (1.0 + v if key[-1] == "scale" else v).astype(
            np.float32)
    stats = {}
    for key, leaf in traverse_util.flatten_dict(
            shapes.get("batch_stats", {})).items():
        v = (0.5 + rng.random(leaf.shape) if key[-1] == "var"
             else 0.1 * rng.normal(size=leaf.shape))
        stats["/".join(key)] = v.astype(np.float32)
    return out, stats


def _to_torch(jax_key: str, value):
    """(port parameter name, value in the port's layout) of a JAX leaf."""
    (name, t), = params_from_jax({jax_key: np.asarray(value)}, None,
                                 merge_lora=False).items()
    return name, t.numpy()


def _torch_name(jax_key: str) -> str:
    return _to_torch(jax_key, np.zeros((1, 1)))[0]


# ---------------------------------------------------------------------------
# dropout masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,rate,seed", [((4, 128, 96), 0.1, 12345),
                                             ((7, 33), 0.3, 2 ** 31 - 2),
                                             ((3, 5, 2, 16), 0.5, 0)])
def test_hash_dropout_matches_jax(monkeypatch, shape, rate, seed):
    """JAX HashDropout with its seed draw pinned to `seed` against the
    port's hash_dropout on the same seed: the same zeros, the same scale."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(seed, jnp.int32))
    module = jlayers.HashDropout(rate)
    want = np.asarray(module.apply({}, jnp.asarray(x), deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0)}))
    got = tlayers.hash_dropout(torch.from_numpy(x), rate, seed).numpy()
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs((want != 0).mean() - (1 - rate)) < 0.05


def test_dropout_sites_draw_seeds_in_order_and_only_when_active():
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(4, 8)
    assert tlayers.dropout(x, 0.0, False, gen) is x
    assert tlayers.dropout(x, 0.5, True, None) is x
    a = tlayers.dropout(x, 0.5, False, gen)
    b = tlayers.dropout(x, 0.5, False, gen)
    again = torch.Generator().manual_seed(3)
    assert torch.equal(tlayers.dropout(x, 0.5, False, again), a)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="needs rng"):
        tlayers.dropout(x, 0.5, False, None)


# ---------------------------------------------------------------------------
# losses, groups, schedule, optimizer
# ---------------------------------------------------------------------------

def test_weighted_bce_and_contrastive_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=32).astype(np.float32) * 3
    labels = (rng.random(32) < 0.4).astype(np.float32)
    valid = (rng.random(32) < 0.8).astype(np.float32)
    for pw in (0.867, 2.554, 1.0):
        for v in (None, valid):
            want = jlosses.weighted_bce_with_logits(
                jnp.asarray(logits), jnp.asarray(labels), pw,
                None if v is None else jnp.asarray(v))
            got = tlosses.weighted_bce_with_logits(
                torch.from_numpy(logits), torch.from_numpy(labels), pw,
                None if v is None else torch.from_numpy(v))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    a, p = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(tlosses.contrastive_loss(torch.from_numpy(a),
                                       torch.from_numpy(p))),
        float(jlosses.contrastive_loss(jnp.asarray(a), jnp.asarray(p))),
        rtol=1e-6)


def test_label_param_over_the_full_baseline_tree():
    """Every parameter of the port's model gets the JAX label of its JAX
    counterpart, and split_trainable freezes exactly the frozen ones."""
    cfg = tiny_config()
    flat, _ = _jax_variables(cfg, 0)
    model = MMoERecModel(_port_cfg(cfg).model)
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(_torch_name(k) for k in flat)
    for key in flat:
        want = jopt.label_param(tuple(key.split("/")), "baseline")
        got = topt.label_param(tuple(_torch_name(key).split(".")), "baseline")
        assert got == want, key
    trainable, frozen = topt.split_trainable(model, "baseline")
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    assert any("lora_a" in k for k in trainable)
    assert all(k.startswith(("user_expert", "item_expert", "img_expert"))
               for k in frozen)


def test_schedule_values_match_jax():
    want = jopt.freeze_warmup_schedule(2e-5, 2000, 1200)
    got = topt.freeze_warmup_schedule(2e-5, 2000, 1200)
    for count in (0, 1, 1999, 2000, 2001, 2600, 3199, 3200, 9999):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)


def _opt_case():
    rng = np.random.default_rng(4)
    params = {("head", "fc", "kernel"): rng.normal(size=(6, 5)),
              ("head", "fc", "bias"): rng.normal(size=(5,)),
              ("user_expert", "q", "lora_a"): rng.normal(size=(6, 2)),
              ("user_expert", "q", "lora_b"): rng.normal(size=(2, 5))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.01, 2.0)]
    return params, grads


def test_adamw_and_clip_updates_match_optax():
    """Three updates, the first and last clipped (norm > 1), the second
    not, with the LoRA group frozen for the first count and warming up
    after, against the JAX package's optax chain on the same gradients."""
    ocfg = _port_cfg(tiny_config()).train.optim
    ocfg.lr, ocfg.freeze_steps, ocfg.unfreeze_steps = 1e-2, 1, 2
    params, grads = _opt_case()
    labels = {k: jopt.label_param(k, "baseline") for k in params}
    tx = jopt.make_optimizer(ocfg, "baseline", labels)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {".".join(k): torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, sched = topt.make_optimizer(ocfg, "baseline", tp)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        want_norm = optax.global_norm(jg)
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.from_numpy(g[k].copy()) for k in params]
        norm = topt.global_norm(tg)
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        topt.clip_by_global_norm(tg, ocfg.max_grad_norm, norm)
        for k, t in zip(params, tg):
            tp[".".join(k)].grad = t
        opt.step()
        sched.step()
        for k in params:
            np.testing.assert_allclose(tp[".".join(k)].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6,
                                       err_msg=str(k))
    assert sched.last_epoch == 3


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

def _no_dropout(cfg):
    m = cfg.model
    m.dropout = m.tower_dropout = 0.0
    m.home_expert_dropout = m.home_tower_dropout = 0.0
    t = m.text
    t.hidden_dropout = t.attention_dropout = t.lora_dropout = 0.0
    o = cfg.train.optim
    # the schedule gives LoRA lr 0 at counts <= freeze_steps: -1 with a
    # one-count warmup gives it the full lr on the first update
    o.freeze_steps, o.unfreeze_steps, o.lr, o.eps = -1, 1, 0.1, 1.0
    o.home_freeze_steps, o.home_unfreeze_steps = -1, 1
    return cfg


@pytest.mark.parametrize("variant", ["baseline", "home"])
def test_train_step_matches_jax_make_train_step(variant):
    """One optimizer step (accum 2, every rate 0, LoRA and HoME's img_ft
    group at full lr) from the same params, BatchNorm statistics and batch:
    the loss, its contrastive part (HoME), grad_norm, every updated
    trainable parameter and the BatchNorm statistics, which carry from one
    micro-batch to the next, against JAX make_train_step."""
    cfg = _no_dropout(tiny_config(variant))
    flat, stats = _jax_variables(cfg, 7)
    batch = stacked_batch(cfg, seed=1)
    unflat = lambda f: traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in f.items()})
    trainable, frozen = jopt.split_trainable(unflat(flat), variant)
    labels = {k: jopt.label_param(k, variant) for k in trainable}
    tx = jopt.make_optimizer(cfg.train.optim, variant, labels)
    state = TrainState(step=jnp.zeros((), jnp.int32), trainable=trainable,
                       frozen=frozen,
                       batch_stats=unflat(stats) if stats else {},
                       opt_state=tx.init(trainable))
    step = jax.jit(make_train_step(cfg, JModel(cfg.model), tx))
    new_state, want = step(state, batch, jax.random.PRNGKey(0))

    trainer = Trainer(_port_cfg(cfg), device="cpu", params=flat,
                      batch_stats=stats)
    got = trainer.run_step(batch)
    assert got["skipped_micro"] == int(want["skipped_micro"]) == 0
    np.testing.assert_allclose(got["loss"], float(want["loss"]), atol=1e-5)
    np.testing.assert_allclose(got["contrastive_loss"],
                               float(want["contrastive_loss"]), atol=1e-5)
    assert (got["contrastive_loss"] > 0) == (variant == "home")
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]),
                               rtol=1e-4)
    assert trainer.step == int(new_state.step) == 1
    buffers = dict(trainer.model.named_buffers())
    new_stats = traverse_util.flatten_dict(new_state.batch_stats or {})
    assert len(buffers) == len(new_stats) == len(stats)
    for key, value in new_stats.items():
        np.testing.assert_allclose(buffers[".".join(key)].numpy(),
                                   np.asarray(value), atol=1e-5,
                                   err_msg=str(key))
    moved = set()
    for key, value in new_state.trainable.items():
        name, want_p = _to_torch("/".join(key), value)
        after = trainer.trainable[name].detach().numpy()
        np.testing.assert_allclose(after, want_p, atol=1e-6, err_msg=name)
        if not np.array_equal(after, _to_torch("/".join(key),
                                               flat["/".join(key)])[1]):
            moved.add(name.rsplit(".", 1)[-1])
    assert {"lora_a", "lora_b", "weight", "bias"} <= moved


def test_nan_micro_batch_is_skipped():
    """As tests/test_train.py::test_train_step_nan_batch_skipped: a step
    whose every micro-batch has a NaN loss changes nothing and does not
    count; one good micro-batch of two still updates."""
    cfg = _port_cfg(tiny_config())
    trainer = Trainer(cfg, device="cpu")
    good = stacked_batch(cfg, seed=0)
    trainer.run_step(good)
    before = {k: p.detach().clone() for k, p in trainer.trainable.items()}
    opt_before = trainer.optimizer.state_dict()["state"][0]["step"].item()
    bad = dict(good)
    bad["label_good"] = np.full_like(good["label_good"], np.nan)
    m = trainer.run_step(bad)
    assert m["skipped_micro"] == cfg.train.optim.grad_accum
    assert trainer.step == 1 and trainer.host_step == 2
    assert trainer.optimizer.state_dict()["state"][0]["step"].item() \
        == opt_before
    assert all(torch.equal(before[k], p) for k, p in trainer.trainable.items())
    half = dict(good)
    half["label_good"] = good["label_good"].copy()
    half["label_good"][0] = np.nan
    m = trainer.run_step(half)
    assert m["skipped_micro"] == 1 and np.isfinite(m["loss"])
    assert trainer.step == 2


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """3 steps unbroken against 2 steps, save, restore into a fresh
    Trainer, 1 step: the same metrics (dropout on, its streams keyed on
    host_step) and the same parameters.  The frozen-weight guard refuses
    another base, and max_to_keep prunes old payloads."""
    cfg = _port_cfg(tiny_config())
    batches = [stacked_batch(cfg, seed=s) for s in range(3)]
    unbroken = Trainer(cfg, device="cpu")
    want = [unbroken.run_step(b) for b in batches]

    first = Trainer(cfg, device="cpu")
    got = [first.run_step(b) for b in batches[:2]]
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2):
        ckpt.save(step, first, extra={"epoch": 0, "opt_step_in_epoch": 2,
                                      "host_step": first.host_step})
    resumed = Trainer(cfg, device="cpu")
    extra = ckpt.restore(resumed)
    assert extra == {"epoch": 0, "opt_step_in_epoch": 2, "host_step": 2}
    resumed.host_step = extra["host_step"]
    assert resumed.step == first.step == 2
    got.append(resumed.run_step(batches[2]))
    assert got == want
    for k, p in unbroken.trainable.items():
        assert torch.equal(p, resumed.trainable[k]), k

    ckpt.save(3, resumed)
    assert ckpt.all_steps() == [2, 3]
    fp = frozen_fingerprint(resumed.frozen)
    with torch.no_grad():
        next(iter(resumed.frozen.values())).add_(1.0)
    assert frozen_fingerprint(resumed.frozen) != fp
    with pytest.raises(ValueError, match="frozen base weights"):
        ckpt.save(4, resumed)
    assert CheckpointManager(str(tmp_path / "empty")).restore(resumed) is None


@pytest.mark.parametrize("variant,loss_range", [("baseline", (1.0, 2.0)),
                                                 ("home", (1.0, 3.0))])
def test_synth_and_train_cli_on_cpu(tmp_path, variant, loss_range):
    """`synth` + `train --device=cpu` at the tiny widths: finite losses in
    the range the JAX CLI shows (HoME adds its three contrastive terms, 0.1
    each), no skipped micro-batch, a checkpoint and metrics.jsonl."""
    shards = tmp_path / "shards"
    assert cli.main(["synth", f"--output={shards}", "--samples=48",
                     "--samples-per-shard=16"]) == 0
    assert cli.main(["train", "--device=cpu",
                     f"--data.train_pattern={shards}/*.tar.gz",
                     f"--train.checkpoint_dir={tmp_path / 'ckpt'}",
                     f"--train.output_dir={tmp_path / 'out'}",
                     "--train.epochs=1", "--train.steps_per_epoch=4",
                     "--train.optim.grad_accum=2", "--train.log_every=1",
                     *tiny_cli_flags(variant)]) == 0
    lines = [json.loads(line) for line in
             open(tmp_path / "out" / "metrics.jsonl")]
    steps = [line for line in lines if "loss" in line]
    assert len(steps) == 2
    for line in steps:
        assert loss_range[0] < line["loss"] < loss_range[1]
        assert line["skipped_micro"] == 0
        assert (line["contrastive_loss"] > 0) == (variant == "home")
    assert any("epoch_loss" in line for line in lines)
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2


# ---------------------------------------------------------------------------
# chip_smoke.py's train_check and lora_check limits against wrong backwards
# ---------------------------------------------------------------------------

def _check_cfg(flash: bool, fused: bool = False,
               dtype: str = "bfloat16"):
    """chip_smoke's small model (hidden 128, dh 64, 128-token chunks) with
    the card's LoRA rank and dropout 0.1 everywhere."""
    cfg = chip_smoke.small_config()
    cfg.model.compute_dtype = dtype
    cfg.model.text.lora_rank = 8
    cfg.model.text.lora_fused_dropout = fused
    cfg.model.use_flash_attention = flash
    return cfg


def _check_micro(cfg, seed: int = 1):
    """Random ids in every chunk, 4 sentences per sample in its chunks."""
    b, pk = cfg.train.batch_size, cfg.model.packer
    n = pk.chunk_budget or b * pk.max_chunks_per_sample
    per = n // b
    r = np.random.default_rng(seed)
    batch = dummy_batch(cfg, batch_size=b)
    for side in ("user", "item"):
        batch[f"{side}_tokens"] = r.integers(
            5, cfg.model.text.vocab_size, (n, pk.max_tok)).astype(np.int32)
        batch[f"{side}_sent_chunk"][:, :4] = (np.arange(b)[:, None] * per
                                              + r.integers(0, per, (b, 4)))
        batch[f"{side}_sent_tok"][:, :4] = r.integers(1, pk.max_tok - 1,
                                                      (b, 4))
    img = cfg.model.image
    batch["patches"] = r.integers(0, 256, (b, img.num_patches,
                                           img.patch_dim)).astype(np.uint8)
    batch["has_image"] = (r.random(b) < 0.8).astype(np.int32)
    batch["label_good"] = (r.random(b) < 0.5).astype(np.float32)
    batch["label_best"] = (r.random(b) < 0.3).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _scaled_dq_dk(ref):
    def bwd(q, k, v, pad, seed, dout, n_heads, rate):
        dq, dk, dv = ref(q, k, v, pad, seed, dout, n_heads, rate)
        return dq * (1 - rate), dk * (1 - rate), dv
    return bwd


WRONG_BACKWARDS = {
    "right": lambda ref: ref,
    "another_keep_mask": lambda ref: (
        lambda q, k, v, pad, seed, dout, n_heads, rate:
        ref(q, k, v, pad, seed + 1, dout, n_heads, rate)),
    "no_dropout": lambda ref: (
        lambda q, k, v, pad, seed, dout, n_heads, rate:
        ref(q, k, v, pad, seed, dout, n_heads, 0.0)),
    "dq_dk_without_dropout_scale": _scaled_dq_dk,
}


@pytest.fixture(scope="module")
def plain_path_lora_grads():
    cfg = _check_cfg(flash=False)
    trainer, lora = chip_smoke.check_trainer(cfg, "cpu")
    return chip_smoke.micro_grads(trainer, lora, _check_micro(cfg))


@pytest.mark.parametrize("backward", sorted(WRONG_BACKWARDS))
def test_train_check_limits_fail_wrong_backwards(monkeypatch, backward,
                                                 plain_path_lora_grads):
    """chip_smoke.py's train_check holds the kernel path's LoRA gradients
    to the plain attention path's within CHECK_GRAD_TOL (max) and
    CHECK_GRAD_L2_TOL (L2).  Here the kernel path's backward on the CPU is
    its plain version (right: the bf16 paths differ within the limits) or
    that version made wrong: the keep mask of the next seed, no dropout,
    or dq and dk without their 1/(1-r).  Each wrong one exceeds a limit."""
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as tfa
    monkeypatch.setattr(
        tfa, "flash_attention_bwd_reference",
        WRONG_BACKWARDS[backward](tfa.flash_attention_bwd_reference))
    cfg = _check_cfg(flash=True)
    trainer, lora = chip_smoke.check_trainer(cfg, "cpu")
    loss, grads = chip_smoke.micro_grads(trainer, lora,
                                              _check_micro(cfg))
    plain_loss, plain = plain_path_lora_grads
    gap, gap_l2, _ = chip_smoke.grad_gaps(grads, plain)
    print(backward, {"loss_gap": abs(loss - plain_loss),
                     "lora_grad_max_rel_gap": gap,
                     "lora_grad_l2_rel_gap": gap_l2})
    assert abs(loss - plain_loss) <= chip_smoke.CHECK_LOSS_TOL
    within = (gap <= chip_smoke.CHECK_GRAD_TOL
              and gap_l2 <= chip_smoke.CHECK_GRAD_L2_TOL)
    assert within == (backward == "right"), (gap, gap_l2)


def _lora_grads(cfg):
    trainer, lora = chip_smoke.check_trainer(cfg, "cpu")
    return chip_smoke.micro_grads(trainer, lora, _check_micro(cfg))


WRONG_LORA_BACKWARDS = {
    "right": None,
    "da_with_the_next_keep_mask": ("lora_dropout_da_reference", lambda ref: (
        lambda h, dt, seed, rate: ref(h, dt, seed + 1, rate))),
    "dh_with_the_next_keep_mask": ("lora_dropout_dh_reference", lambda ref: (
        lambda dt, a, seed, rate: ref(dt, a, seed + 1, rate))),
    "dh_without_dropout_scale": ("lora_dropout_dh_reference", lambda ref: (
        lambda dt, a, seed, rate: ref(dt, a, seed, rate) * (1 - rate))),
}


@pytest.fixture(scope="module")
def unfused_lora_grads():
    return _lora_grads(_check_cfg(False, fused=False, dtype="float32"))


@pytest.mark.parametrize("backward", sorted(WRONG_LORA_BACKWARDS))
def test_lora_check_limits_fail_wrong_lora_backwards(monkeypatch, backward,
                                                     unfused_lora_grads):
    """chip_smoke.py's lora_check holds the fused LoRA dropout's LoRA
    gradients to the unfused branch's, fp32, within LORA_CHECK_GRAD_TOL
    (max) and LORA_CHECK_GRAD_L2_TOL (L2).  Here the fused branch's
    backward on the CPU is its plain version (right: the branches differ
    in the last fp32 bits) or that version made wrong: dA (#5) or dh (#6)
    with the keep mask of the next seed, or dh without its 1/(1-r).  Each
    wrong one exceeds a limit."""
    from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as tld
    if WRONG_LORA_BACKWARDS[backward] is not None:
        name, wrong = WRONG_LORA_BACKWARDS[backward]
        monkeypatch.setattr(tld, name, wrong(getattr(tld, name)))
    loss, grads = _lora_grads(_check_cfg(False, fused=True, dtype="float32"))
    plain_loss, plain = unfused_lora_grads
    gap, gap_l2, _ = chip_smoke.grad_gaps(grads, plain)
    print(backward, {"loss_gap": abs(loss - plain_loss),
                     "lora_grad_max_rel_gap": gap,
                     "lora_grad_l2_rel_gap": gap_l2})
    assert abs(loss - plain_loss) <= chip_smoke.LORA_CHECK_LOSS_TOL
    within = (gap <= chip_smoke.LORA_CHECK_GRAD_TOL
              and gap_l2 <= chip_smoke.LORA_CHECK_GRAD_L2_TOL)
    assert within == (backward == "right"), (gap, gap_l2)
