"""The port's shared text base (model.shared_text_base: DualTextExpert over
side-stacked LoRA), its converters (utils/shared_base.py,
utils/scan_convert.py, the stacked scan-layers tree into params_from_jax)
and the top-k gate (model.gate_type="topk"), against the JAX package on
the CPU, fp32.

Params come from the flax init's shapes (`jax.eval_shape`) with values
drawn by numpy and reach the port through utils/convert.load_jax_params.
Dropout, where it is on, draws one pinned seed at every site of both
packages (as tests/test_torch_home.py does); attention dropout stays 0,
since JAX on the CPU draws bernoulli bits there.

Tolerances: converters and labels exact; modules within 2e-5 and whole
models within 1e-4 (tests/test_torch_model.py's PART_ATOL and MODEL_ATOL:
the frameworks sum products in another order); a training step as
tests/test_torch_train.py holds it (loss 1e-5, grad_norm 1e-4 relative,
parameters 1e-6 at AdamW eps 1).  The shared base against two towers in
the port: 1e-5 (one encoder pass over twice the rows sums in another
order than two passes)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mmoe_multimodal_rec_tpu.models import heads as jheads
from mmoe_multimodal_rec_tpu.models.mmoe import MMoERecModel as JModel
from mmoe_multimodal_rec_tpu.train import optimizer as jopt
from mmoe_multimodal_rec_tpu.train.step import TrainState, make_train_step
from mmoe_multimodal_rec_tpu.utils import hf_convert as jconv
from mmoe_multimodal_rec_tpu.utils import scan_convert as jscan
from mmoe_multimodal_rec_tpu.utils import shared_base as jshared
from mmoe_multimodal_rec_tpu_torch import cli
from mmoe_multimodal_rec_tpu_torch.config import Config as TConfig
from mmoe_multimodal_rec_tpu_torch.eval.predict import Predictor
from mmoe_multimodal_rec_tpu_torch.models import heads as theads
from mmoe_multimodal_rec_tpu_torch.models import layers as tlayers
from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel
from mmoe_multimodal_rec_tpu_torch.train import optimizer as topt
from mmoe_multimodal_rec_tpu_torch.train.checkpoint import CheckpointManager
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
from mmoe_multimodal_rec_tpu_torch.utils import hf_convert as tconv
from mmoe_multimodal_rec_tpu_torch.utils import scan_convert as tscan
from mmoe_multimodal_rec_tpu_torch.utils import shared_base as tshared
from mmoe_multimodal_rec_tpu_torch.utils.convert import (load_jax_params,
                                                          params_from_jax)
from test_torch_eval import _reference_ckpt
from util import packed_batch, stacked_batch, tiny_cli_flags, tiny_config

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

PART_ATOL = 2e-5
MODEL_ATOL = 1e-4
PAIR_ATOL = 1e-5
SEED = 424242
MODEL_KEYS = ("user_tokens", "user_sent_chunk", "user_sent_tok",
              "item_tokens", "item_sent_chunk", "item_sent_tok", "patches",
              "has_image")


def _port_cfg(cfg):
    return TConfig.from_dict(cfg.to_dict())


def _tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


def _variables(cfg, seed):
    """Flat numpy params and batch_stats of the JAX model at `cfg`."""
    micro = {k: v for k, v in packed_batch(cfg, seed=0).items()}
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            micro)
    rng = np.random.default_rng(seed)
    params = {}
    for key, leaf in traverse_util.flatten_dict(shapes["params"]).items():
        if key[-1] == "kernel":
            v = rng.normal(0, leaf.shape[-2] ** -0.5, leaf.shape)
        elif key[-1] == "scale":
            v = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            v = 0.1 * rng.normal(size=leaf.shape)
        params["/".join(key)] = v.astype(np.float32)
    stats = {}
    for key, leaf in traverse_util.flatten_dict(
            shapes.get("batch_stats", {})).items():
        v = (0.5 + rng.random(leaf.shape) if key[-1] == "var"
             else 0.1 * rng.normal(size=leaf.shape))
        stats["/".join(key)] = v.astype(np.float32)
    return params, stats


def _jax_eval(cfg, params, stats, batch):
    variables = {"params": _tree(params)}
    if stats:
        variables["batch_stats"] = _tree(stats)
    return jax.jit(lambda v, b: JModel(cfg.model).apply(
        v, b, deterministic=True))(variables, batch)


def _port_eval(cfg, params, stats, batch):
    model = MMoERecModel(_port_cfg(cfg).model)
    load_jax_params(model, params, cfg.model, merge_lora=False,
                    batch_stats=stats)
    with torch.no_grad():
        return model.eval()({k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()})


def _shared_cfg(variant="baseline"):
    cfg = tiny_config(variant)
    cfg.model.shared_text_base = True
    return cfg


@pytest.fixture
def pinned_seeds(monkeypatch):
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(SEED, jnp.int32))
    monkeypatch.setattr(tlayers, "draw_seed", lambda rng: SEED)


# ---------------------------------------------------------------------------
# the shared base
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["baseline", "home"])
def test_shared_model_matches_jax(variant):
    """The shared-base model (one text pass, side-stacked LoRA) against
    JAX's, deterministic: the logits and every expert vector."""
    cfg = _shared_cfg(variant)
    params, stats = _variables(cfg, 3)
    assert any(k.startswith("text_experts/") for k in params)
    batch = {k: v for k, v in packed_batch(cfg, seed=1).items()
             if k in MODEL_KEYS}
    want = _jax_eval(cfg, params, stats, batch)
    got = _port_eval(cfg, params, stats, batch)
    for key in ("logit_good", "logit_best"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   atol=MODEL_ATOL, err_msg=key)
    for key in ("u_doc", "i_doc", "ui_vec", "xui", "xti"):
        np.testing.assert_allclose(got.aux[key].numpy(),
                                   np.asarray(want.aux[key]),
                                   atol=MODEL_ATOL, err_msg=key)


def test_shared_train_step_matches_jax(pinned_seeds):
    """One optimizer step of the shared-base baseline (accum 2) with hidden
    and LoRA dropout 0.1 on pinned seeds, the port's LoRA dropout through
    lora_dropout_matmul at the folded rank 2r (its plain version on the
    CPU), against JAX make_train_step: the loss, grad_norm and every
    updated parameter, the side-stacked LoRA factors among them."""
    cfg = _shared_cfg()
    m = cfg.model
    m.dropout = m.tower_dropout = 0.0
    m.text.attention_dropout = 0.0
    o = cfg.train.optim
    o.freeze_steps, o.unfreeze_steps, o.lr, o.eps = -1, 1, 0.1, 1.0
    flat, _ = _variables(cfg, 7)
    batch = stacked_batch(cfg, seed=1)
    trainable, frozen = jopt.split_trainable(_tree(flat), "baseline")
    labels = {k: jopt.label_param(k, "baseline") for k in trainable}
    tx = jopt.make_optimizer(cfg.train.optim, "baseline", labels)
    state = TrainState(step=jnp.zeros((), jnp.int32), trainable=trainable,
                       frozen=frozen, batch_stats={},
                       opt_state=tx.init(trainable))
    step = jax.jit(make_train_step(cfg, JModel(cfg.model), tx))
    new_state, want = step(state, batch, jax.random.PRNGKey(0))

    trainer = Trainer(_port_cfg(cfg), device="cpu", params=flat)
    got = trainer.run_step(batch)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]),
                               rtol=1e-4)
    moved = set()
    for key, value in new_state.trainable.items():
        (name, want_p), = params_from_jax(
            {"/".join(key): np.asarray(value)}, None,
            merge_lora=False).items()
        after = trainer.trainable[name].detach()
        np.testing.assert_allclose(after.numpy(), want_p.numpy(), atol=1e-6,
                                   err_msg=name)
        if name.startswith("text_experts") and not torch.equal(
                after, torch.from_numpy(flat["/".join(key)])):
            moved.add(name.rsplit(".", 1)[-1])
    assert moved == {"lora_a", "lora_b"}


def test_shared_base_equals_two_towers_with_equal_bases():
    """In the port, the shared-base model and the two-tower model whose
    towers carry the same base (its state expanded by shared_to_two_tower)
    give the same logits, and at rate 0 the same LoRA gradients, each side
    of the stacked factors its tower's; the fused LoRA dropout at the
    folded rank 2r equals the unfused branch."""
    cfg = _shared_cfg()
    m = cfg.model
    m.dropout = m.tower_dropout = 0.0
    t = m.text
    t.hidden_dropout = t.attention_dropout = t.lora_dropout = 0.0
    shared = MMoERecModel(_port_cfg(cfg).model)
    tlayers.init_weights(shared, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in shared.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    tower_cfg = _port_cfg(cfg)
    tower_cfg.model.shared_text_base = False
    towers = MMoERecModel(tower_cfg.model)
    towers.load_state_dict(tshared.shared_to_two_tower(shared.state_dict(),
                                                       sep="."))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in packed_batch(cfg, seed=2).items()}
    outs, grads = [], []
    for model in (shared, towers):
        out = model(batch, deterministic=False,
                    rng=torch.Generator().manual_seed(0))
        (out.logit_good.sum() + out.logit_best.sum()).backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if n.endswith(("lora_a", "lora_b"))})
    np.testing.assert_allclose(outs[0].logit_good.detach().numpy(),
                               outs[1].logit_good.detach().numpy(),
                               atol=PAIR_ATOL)
    as_towers = tshared.shared_to_two_tower(grads[0], sep=".")
    assert sorted(as_towers) == sorted(grads[1])
    for name, g in grads[1].items():
        np.testing.assert_allclose(as_towers[name].numpy(), g.numpy(),
                                   atol=PAIR_ATOL, err_msg=name)

    layer = tlayers.LoRADense(32, 32, 2, 8.0, dropout=0.1, sides=2,
                              fused_dropout=True)
    tlayers.init_weights(layer, torch.Generator().manual_seed(3))
    with torch.no_grad():
        layer.lora_b.normal_(generator=torch.Generator().manual_seed(4))
    x = torch.randn(6, 24, 32, generator=torch.Generator().manual_seed(5))
    fused = layer.delta(x, False, torch.Generator().manual_seed(6), split=2)
    layer.fused_dropout = False
    plain = layer.delta(x, False, torch.Generator().manual_seed(6), split=2)
    np.testing.assert_allclose(fused.detach().numpy(),
                               plain.detach().numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# converters, labels, stacked layers, reference checkpoints
# ---------------------------------------------------------------------------

def test_converters_match_jax_both_ways():
    """shared_to_two_tower and two_tower_to_shared equal JAX's on the
    HoME and baseline trees, leaf for leaf, and invert each other; the
    '.'-keyed torch-state form gives the same tensors."""
    for variant in ("baseline", "home"):
        shared, _ = _variables(_shared_cfg(variant), 4)
        want_towers = _flat(jshared.shared_to_two_tower(_tree(shared)))
        towers = tshared.shared_to_two_tower(shared)
        assert sorted(towers) == sorted(want_towers)
        for k, v in want_towers.items():
            np.testing.assert_array_equal(towers[k], v, err_msg=k)
        back = tshared.two_tower_to_shared(towers)
        want_back = _flat(jshared.two_tower_to_shared(_tree(towers)))
        assert sorted(back) == sorted(want_back) == sorted(shared)
        for k, v in shared.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
            np.testing.assert_array_equal(want_back[k], v, err_msg=k)
        state = {k.replace("/", "."): torch.from_numpy(v)
                 for k, v in shared.items()}
        as_state = tshared.shared_to_two_tower(state, sep=".")
        assert sorted(as_state) == sorted(k.replace("/", ".")
                                          for k in towers)
        assert all(np.array_equal(as_state[k.replace("/", ".")].numpy(), v)
                   for k, v in towers.items())


def test_diverged_bases_raise():
    """Towers whose frozen bases differ cannot share one: both packages
    raise; an atol that covers the gap lets it through."""
    shared, _ = _variables(_shared_cfg(), 4)
    towers = tshared.shared_to_two_tower(shared)
    key = "item_expert/encoder/layer_0/attention/key/kernel"
    towers[key] = towers[key] + 1e-3
    with pytest.raises(ValueError, match="diverge"):
        tshared.two_tower_to_shared(towers)
    with pytest.raises(ValueError, match="diverge"):
        jshared.two_tower_to_shared(_tree(towers))
    assert tshared.is_shared_layout(
        tshared.two_tower_to_shared(towers, atol=2e-3))


def test_optimizer_labels_over_the_shared_tree():
    """As JAX test_shared_base::test_optimizer_labels_shared_tree: every
    port parameter gets its JAX leaf's label; the side-stacked LoRA
    factors train in the `lora` group, the shared base and the per-side
    norms stay frozen."""
    cfg = _shared_cfg()
    flat, _ = _variables(cfg, 0)
    model = MMoERecModel(_port_cfg(cfg).model)
    names = {n: p for n, p in model.named_parameters()}
    for key in flat:
        (name, _), = params_from_jax({key: flat[key]}, None,
                                     merge_lora=False).items()
        assert name in names, key
        want = jopt.label_param(tuple(key.split("/")), "baseline")
        assert topt.label_param(tuple(name.split(".")), "baseline") == want
    trainable, _ = topt.split_trainable(model, "baseline")
    lora = [n for n in trainable if n.startswith("text_experts")]
    assert lora and all(n.endswith(("lora_a", "lora_b")) for n in lora)
    assert all(names[n].shape[0] == 2 for n in lora)


@pytest.mark.parametrize("shared", [False, True])
def test_scan_layers_tree_loads_with_equal_logits(shared):
    """A JAX model trained with text.scan_layers=True keeps its text layers
    stacked (`encoder/layers/layer/...`, a leading [num_layers] axis).
    params_from_jax unstacks it into the port's unrolled layers, which
    give JAX's logits; the port's stack/unstack equal JAX's."""
    cfg = _shared_cfg() if shared else tiny_config()
    cfg.model.text.scan_layers = True
    params, _ = _variables(cfg, 5)
    assert any("/encoder/layers/layer/" in k for k in params)
    batch = {k: v for k, v in packed_batch(cfg, seed=1).items()
             if k in MODEL_KEYS}
    want = _jax_eval(cfg, params, None, batch)
    got = _port_eval(cfg, params, None, batch)
    np.testing.assert_allclose(got.logit_good.numpy(),
                               np.asarray(want.logit_good), atol=MODEL_ATOL)
    np.testing.assert_allclose(got.logit_best.numpy(),
                               np.asarray(want.logit_best), atol=MODEL_ATOL)
    unrolled = tscan.unstack_layers(params)
    want_unrolled = _flat(jscan.unstack_layers(_tree(params)))
    assert sorted(unrolled) == sorted(want_unrolled)
    for k, v in want_unrolled.items():
        np.testing.assert_array_equal(unrolled[k], v, err_msg=k)
    restacked = tscan.stack_layers(unrolled)
    assert sorted(restacked) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(restacked[k], v, err_msg=k)


def test_reference_checkpoint_converts_into_the_shared_layout():
    """A reference .pt (two full towers of one BGE) converts into the
    shared-base tree as JAX's converter does, array for array, and loads
    into the shared-base model with JAX's report; with text.scan_layers
    the port keeps the unrolled tree it runs."""
    cfg = _shared_cfg()
    ckpt = _reference_ckpt(cfg, 5)
    ckpt["item"] = dict(ckpt["user"])      # one BGE under both towers
    want, _ = jconv.convert_reference_checkpoint(ckpt, cfg.model)
    pcfg = _port_cfg(cfg)
    got, _ = tconv.convert_reference_checkpoint(ckpt, pcfg.model)
    assert sorted(_flat(got)) == sorted(_flat(want))
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k], v, err_msg=k)
    lines = []
    model = MMoERecModel(pcfg.model)
    missing, unexpected = tconv.load_reference_checkpoint(
        model, ckpt, pcfg.model, log=lines.append)
    assert unexpected == []
    assert all(n.endswith(("lora_a", "lora_b")) for n in missing)
    pcfg.model.text.scan_layers = True
    scan, _ = tconv.convert_reference_checkpoint(ckpt, pcfg.model)
    assert sorted(_flat(scan)) == sorted(_flat(got))
    ckpt["item"]["encoder.embeddings.word_embeddings.weight"] = (
        ckpt["item"]["encoder.embeddings.word_embeddings.weight"] + 1.0)
    with pytest.raises(ValueError, match="diverge"):
        tconv.convert_reference_checkpoint(ckpt, pcfg.model)


def test_shared_checkpoint_trains_evaluates_and_serves(tmp_path):
    """CLI `train --model.shared_text_base=true` on the CPU, then `eval`
    of its checkpoint, then the serving Predictor over it: with LoRA
    merged (the shared tree expanded to two towers, then folded) it scores
    as the unmerged shared model does."""
    shards = tmp_path / "shards"
    flags = [*tiny_cli_flags(), "--model.shared_text_base=true",
             f"--train.checkpoint_dir={tmp_path / 'ckpt'}",
             f"--train.output_dir={tmp_path / 'out'}"]
    assert cli.main(["synth", f"--output={shards}", "--samples=48",
                     "--samples-per-shard=16"]) == 0
    assert cli.main(["train", "--device=cpu",
                     f"--data.train_pattern={shards}/*.tar.gz",
                     "--train.epochs=1", "--train.steps_per_epoch=4",
                     "--train.optim.grad_accum=2", "--train.log_every=1",
                     *flags]) == 0
    steps = [json.loads(line) for line in open(tmp_path / "out" /
                                               "metrics.jsonl")]
    assert all(np.isfinite(s["loss"]) for s in steps if "loss" in s)
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    assert cli.main(["eval", "--device=cpu",
                     f"--data.valid_pattern={shards}/*.tar.gz",
                     *flags]) == 0
    cfg = TConfig.from_flags(flags)
    model, step = cli._inference_model(cfg, None, None, "serve", "cpu")
    assert step == 2 and hasattr(model, "text_experts")
    state = model.state_dict()
    texts = (["A sturdy tent.", "Rain got in."], ["Tent.", "Stove."])
    merged = Predictor(cfg, state=state, device="cpu").predict(*texts)
    plain = Predictor(cfg, state=state, merge_lora=False,
                      device="cpu").predict(*texts)
    for key in ("prob_good", "prob_best"):
        np.testing.assert_allclose(merged[key], plain[key], atol=1e-5)


# ---------------------------------------------------------------------------
# top-k gating
# ---------------------------------------------------------------------------

def test_topk_gate_matches_jax():
    """TopKGate's masked, renormalised weights and its Switch balance term
    against JAX's, over random rows and rows of exact ties (zero weights,
    equal biases: every probability equal), where both take the lowest
    indices."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 32)).astype(np.float32)
    for k, tie in ((2, False), (3, False), (2, True), (8, False)):
        gate = jheads.TopKGate(6, k=k)
        shapes = jax.eval_shape(gate.init, jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"]
        params = {"fc/kernel": rng.normal(0, 0.3, (32, 6)),
                  "fc/bias": rng.normal(0, 0.1, (6,))}
        if tie:
            params = {"fc/kernel": np.zeros((32, 6)),
                      "fc/bias": np.full((6,), 0.5)}
        params = {kk: v.astype(np.float32) for kk, v in params.items()}
        assert sorted(_flat(shapes)) == sorted(params)
        w, bal = gate.apply({"params": _tree(params)}, jnp.asarray(x))
        port = theads.TopKGate(32, 6, k)
        load_jax_params(port, params, None, merge_lora=False)
        with torch.no_grad():
            pw, pbal = port(torch.from_numpy(x))
        np.testing.assert_allclose(pw.numpy(), np.asarray(w), atol=PART_ATOL)
        np.testing.assert_allclose(float(pbal), float(bal), atol=PART_ATOL)
        assert ((pw.numpy() > 0).sum(1) == min(k, 6)).all()
        if tie:
            assert (pw.numpy()[:, :k] > 0).all()


@pytest.mark.parametrize("variant", ["baseline", "home"])
def test_topk_model_matches_jax(variant):
    """The whole model with gate_type="topk" (gate_topk 2) against JAX's,
    deterministic: the logits and the gate balance term, which the loss
    adds at lambda_gate_balance as JAX's total_loss does."""
    from mmoe_multimodal_rec_tpu.train import losses as jlosses
    from mmoe_multimodal_rec_tpu_torch.train import losses as tlosses
    cfg = tiny_config(variant)
    cfg.model.gate_type = "topk"
    params, stats = _variables(cfg, 6)
    batch = {k: v for k, v in packed_batch(cfg, seed=1).items()
             if k in MODEL_KEYS}
    want = _jax_eval(cfg, params, stats, batch)
    got = _port_eval(cfg, params, stats, batch)
    np.testing.assert_allclose(got.logit_good.numpy(),
                               np.asarray(want.logit_good), atol=MODEL_ATOL)
    np.testing.assert_allclose(got.logit_best.numpy(),
                               np.asarray(want.logit_best), atol=MODEL_ATOL)
    balance = float(want.aux["gate_balance"])
    assert balance > 0
    np.testing.assert_allclose(float(got.aux["gate_balance"]), balance,
                               atol=PART_ATOL)
    labels = np.arange(got.logit_good.shape[0]) % 2
    jl = jlosses.total_loss(want.logit_good, want.logit_best,
                            jnp.asarray(labels, jnp.float32),
                            jnp.asarray(1 - labels, jnp.float32),
                            cfg.train.loss, aux=want.aux,
                            home=variant == "home")
    tl = tlosses.total_loss(got.logit_good, got.logit_best,
                            torch.tensor(labels, dtype=torch.float32),
                            torch.tensor(1 - labels, dtype=torch.float32),
                            _port_cfg(cfg).train.loss, aux=got.aux,
                            home=variant == "home")
    np.testing.assert_allclose(float(tl.main), float(jl.main),
                               atol=MODEL_ATOL)
