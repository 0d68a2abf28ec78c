"""The port's evaluation (mmoe_multimodal_rec_tpu_torch/eval/auc.py,
eval/evaluate.py, train/step.make_eval_step / make_bn_recalibration_step,
train/checkpoint.restore_model, utils/hf_convert.py, the CLI's `eval`,
`serve --checkpoint` and `train.eval_every`) against the JAX package's, on
the CPU, fp32, at the tiny widths.  Params and BatchNorm statistics are
laid out by the flax init (`jax.eval_shape`) and drawn with numpy; the same
numpy batches (the JAX eval loader's, over synthetic shards whose 20
samples leave a padded trailing batch of 8) go through both.

Tolerances: AUC, ROC and the streamed predictions exact to 1e-12 (the same
numpy code); probabilities within 1e-5 (fp32 end to end, the logits agree
to ~1e-7, tests/test_torch_serving.py); BatchNorm statistics within 1e-5 of
each tensor's largest value (fp32 means and variances summed in another
order); AUCs within 1e-6 with `n` equal (the probabilities' order is the
same on both sides, so the AUCs are equal); converted checkpoints
identical."""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from mmoe_multimodal_rec_tpu.data.loader import make_eval_loader as j_loader
from mmoe_multimodal_rec_tpu.data.packer import TextPacker as JPacker
from mmoe_multimodal_rec_tpu.eval import auc as jauc
from mmoe_multimodal_rec_tpu.eval.predict import Predictor as JPredictor
from mmoe_multimodal_rec_tpu.models.mmoe import MMoERecModel as JModel
from mmoe_multimodal_rec_tpu.train import split_trainable
from mmoe_multimodal_rec_tpu.train import step as jstep
from mmoe_multimodal_rec_tpu.train.loop import dummy_batch
from mmoe_multimodal_rec_tpu.utils import hf_convert as jconv
from mmoe_multimodal_rec_tpu_torch import cli
from mmoe_multimodal_rec_tpu_torch.config import Config as TConfig
from mmoe_multimodal_rec_tpu_torch.data.packer import packer_from_config
from mmoe_multimodal_rec_tpu_torch.data.synthetic import write_synthetic_shards
from mmoe_multimodal_rec_tpu_torch.eval import auc as tauc
from mmoe_multimodal_rec_tpu_torch.eval.evaluate import evaluate
from mmoe_multimodal_rec_tpu_torch.eval.predict import Predictor
from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel
from mmoe_multimodal_rec_tpu_torch.train import step as tstep
from mmoe_multimodal_rec_tpu_torch.train.checkpoint import CheckpointManager
from mmoe_multimodal_rec_tpu_torch.utils import hf_convert as tconv
from mmoe_multimodal_rec_tpu_torch.utils.convert import load_jax_params
from test_checkpoint_convert import (_bert_sd, _cross_sd, _flat, _fuse_sd,
                                     _head_sd, _ln, _vit_sd)
from util import tiny_cli_flags, tiny_config, tiny_tokenizer

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

AUC_TOL = 1e-12
PROB_ATOL = 1e-5
STATS_RTOL = 1e-5
EVAL_AUC_TOL = 1e-6
BATCH = 8
N_SAMPLES = 20      # 8 + 8 + a trailing batch of 4 padded to 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USERS = ["Great bike, highly recommend. The frame is solid!", "Bad helmet.",
         "Arrived late. Works fine though. Meh."]
ITEMS = ["Mountain bike with solid frame.", "Cheap helmet.", "USB cable"]


def _port_cfg(cfg):
    return TConfig.from_dict(cfg.to_dict())


def _tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jax.numpy.asarray(v) for k, v in flat.items()})


def _variables(cfg, seed):
    """Flat '/'-keyed numpy params of the JAX model (kernels N(0, 1/fan_in),
    scales near 1, the rest N(0, 0.1^2), LoRA B non-zero as after training)
    and its batch_stats (HoME: running means N(0, 0.1^2), variances in
    [0.5, 1.5])."""
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            dummy_batch(cfg, batch_size=BATCH))
    rng = np.random.default_rng(seed)
    params = {}
    for key, leaf in traverse_util.flatten_dict(shapes["params"]).items():
        std = leaf.shape[-2] ** -0.5 if key[-1] == "kernel" else 0.1
        v = rng.normal(0, std, leaf.shape)
        params["/".join(key)] = (1.0 + v if key[-1] == "scale" else v
                                 ).astype(np.float32)
    stats = {}
    for key, leaf in traverse_util.flatten_dict(
            shapes.get("batch_stats", {})).items():
        v = (0.5 + rng.random(leaf.shape) if key[-1] == "var"
             else 0.1 * rng.normal(size=leaf.shape))
        stats["/".join(key)] = v.astype(np.float32)
    return params, stats


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    out = tmp_path_factory.mktemp("shards")
    return write_synthetic_shards(str(out), n_samples=N_SAMPLES,
                                  samples_per_shard=8, seed=7)


class _Case:
    """One variant's JAX side (params, jitted steps) and a factory of port
    models loaded with the same params and statistics."""

    def __init__(self, variant, seed):
        self.variant = variant
        self.cfg = tiny_config(variant, batch_size=BATCH)
        self.flat, self.stats = _variables(self.cfg, seed)
        self.jmodel = JModel(self.cfg.model)
        self.trainable, self.frozen = split_trainable(_tree(self.flat),
                                                      variant)
        self.jstats = _tree(self.stats) if self.stats else {}
        self.jeval = jax.jit(jstep.make_eval_step(self.cfg, self.jmodel))
        self.jpacker = JPacker(tiny_tokenizer(self.cfg),
                               self.cfg.model.packer)
        self.tcfg = _port_cfg(self.cfg)

    def port_model(self):
        model = MMoERecModel(self.tcfg.model)
        return load_jax_params(model, self.flat, self.tcfg.model,
                               merge_lora=False, batch_stats=self.stats)


@pytest.fixture(scope="module")
def cases():
    return {"baseline": _Case("baseline", 11), "home": _Case("home", 12)}


@pytest.fixture(scope="module")
def batches(shards, cases):
    """The JAX eval loader's numpy batches of the shards (valid mask
    included; the packers of both variants are the same)."""
    loader = j_loader(shards, BATCH, cases["baseline"].jpacker)
    try:
        return list(loader)
    finally:
        loader.close()


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# AUC, ROC, streamed predictions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_auc_roc_and_streaming_match_jax(ties):
    rng = np.random.default_rng(3)
    labels = rng.random(300) < 0.3
    scores = rng.normal(size=300) + 0.8 * labels
    if ties:
        scores = np.round(scores, 1)
    assert abs(tauc.roc_auc(labels, scores)
               - jauc.roc_auc(labels, scores)) <= AUC_TOL
    for got, want in zip(tauc.roc_curve(labels, scores),
                         jauc.roc_curve(labels, scores)):
        np.testing.assert_allclose(got, want, atol=AUC_TOL)
    streams = tauc.StreamingPredictions(), jauc.StreamingPredictions()
    for lo in range(0, 300, 64):
        hi = min(lo + 64, 300)
        valid = np.arange(64) < hi - lo
        pad = lambda x: np.resize(x[lo:hi], 64)
        out = {"prob_good": pad(scores), "label_good": pad(labels * 1.0),
               "prob_best": pad(-scores), "label_best": pad(~labels * 1.0),
               "valid": valid}
        for s in streams:
            s.update(out)
    assert streams[0].n == streams[1].n == 300
    got, want = streams[0].aucs(), streams[1].aucs()
    for task in ("good", "best"):
        assert abs(got[task] - want[task]) <= AUC_TOL
        for a, b in zip(streams[0].concatenated(task),
                        streams[1].concatenated(task)):
            np.testing.assert_array_equal(a, b)
    assert np.isnan(tauc.StreamingPredictions().aucs()["good"])


# ---------------------------------------------------------------------------
# the eval and recalibration steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["baseline", "home"])
def test_eval_step_matches_jax(cases, batches, variant):
    """make_eval_step on the same params, statistics and batches: the
    probabilities within PROB_ATOL; labels and `valid` pass through."""
    case = cases[variant]
    step = tstep.make_eval_step(case.tcfg, case.port_model())
    for batch in batches:
        want = case.jeval(case.trainable, case.frozen, case.jstats, batch)
        got = step(_torch_batch(batch))
        for key in ("prob_good", "prob_best"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=PROB_ATOL)
        for key in ("label_good", "label_best", "valid"):
            np.testing.assert_array_equal(got[key].numpy(), batch[key])
    assert not batches[-1]["valid"].all()


def test_bn_recalibration_step_matches_jax(cases, batches):
    """HoME: three recalibration steps move the running statistics as JAX's
    do (within STATS_RTOL of each tensor's largest value) and leave every
    parameter as it was."""
    case = cases["home"]
    recal = jax.jit(jstep.make_bn_recalibration_step(case.cfg, case.jmodel))
    stats = case.jstats
    model = case.port_model()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = tstep.make_bn_recalibration_step(case.tcfg, model)
    assert len(batches) == 3
    for batch in batches:
        stats = recal(case.trainable, case.frozen, stats, batch)
        got = step(_torch_batch(batch))
    want = {".".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(stats).items()}
    assert sorted(got) == sorted(want) and len(want) == 12
    for key, w in want.items():
        err = np.abs(got[key].numpy() - w).max()
        assert err <= STATS_RTOL * np.abs(w).max(), key
        assert not np.allclose(w, case.stats[key.replace(".", "/")])
    for k, p in model.named_parameters():
        assert torch.equal(p, params[k]), k


@pytest.mark.parametrize("variant", ["baseline", "home"])
def test_evaluate_end_to_end_matches_jax(cases, shards, tmp_path, variant):
    """evaluate over the shards (HoME recalibrates first, one full pass at
    batch 8): the AUCs within EVAL_AUC_TOL, n equal to JAX's, and
    output_dir/preds.csv with a row per sample."""
    from mmoe_multimodal_rec_tpu.eval.evaluate import evaluate as jevaluate
    case = cases[variant]
    home = variant == "home"
    want = jevaluate(case.cfg, case.jmodel, case.trainable, case.frozen,
                     case.jstats, shards, packer=case.jpacker,
                     batch_size=BATCH, recalibrate=home, bn_batch_size=BATCH,
                     eval_step=case.jeval)
    got = evaluate(case.tcfg, case.port_model(), shards,
                   packer=packer_from_config(case.tcfg), batch_size=BATCH,
                   recalibrate=home, bn_batch_size=BATCH,
                   output_dir=str(tmp_path), save_preds="preds.csv")
    assert got["n"] == want["n"] == N_SAMPLES
    for task in ("good", "best"):
        assert abs(got[task] - want[task]) <= EVAL_AUC_TOL, task
    with open(tmp_path / "preds.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "prob_good,label_good,prob_best,label_best"
    assert len(rows) == N_SAMPLES + 1


# ---------------------------------------------------------------------------
# reference checkpoints
# ---------------------------------------------------------------------------

def _reference_ckpt(cfg, seed):
    """A reference-layout baseline checkpoint (tests/test_checkpoint_
    convert.py's helpers: every key, random values)."""
    mc = cfg.model
    rng = np.random.default_rng(seed)
    d = mc.d
    ckpt = {
        "user": {"encoder." + k: v for k, v in _bert_sd(rng, mc.text).items()},
        "item": {"encoder." + k: v for k, v in _bert_sd(rng, mc.text).items()},
        "img": ({"backbone." + k: v for k, v in _vit_sd(rng, mc.image).items()}
                | _flat("norm", _ln(rng, d), {})),
        "cross_ui": _cross_sd(rng, d),
        "concat_ui": _fuse_sd(rng, d),
        "concat_ti": _fuse_sd(rng, d),
        "head": _head_sd(rng, d, mc.tower_hidden),
    }
    for side in ("user", "item"):
        _flat("norm", _ln(rng, d), ckpt[side])
    # modest scales, so the small model's probabilities stay spread
    return {k: {kk: (0.3 * vv if vv.ndim > 1 else vv).astype(np.float32)
                for kk, vv in v.items()} for k, v in ckpt.items()}


def test_hf_convert_matches_jax():
    """The port's converter gives JAX's arrays, key for key, and its load
    into the port's model reports what JAX's load_into reports."""
    cfg = tiny_config("baseline", batch_size=BATCH)
    ckpt = _reference_ckpt(cfg, 5)
    want, want_stats = jconv.convert_reference_checkpoint(ckpt, cfg.model)
    got, got_stats = tconv.convert_reference_checkpoint(
        ckpt, _port_cfg(cfg).model)
    assert want_stats is None and got_stats is None
    flat = lambda t: traverse_util.flatten_dict(t)
    assert sorted(flat(got)) == sorted(flat(want))
    for key, value in flat(want).items():
        np.testing.assert_array_equal(flat(got)[key], value)
    # drop one tensor and add one: both sides report them alike
    ckpt["head"].pop("gate_good.fc.bias")
    ckpt["head"]["extra.weight"] = np.zeros((2, 2), np.float32)
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            dummy_batch(cfg, batch_size=BATCH))["params"]
    init = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, j_missing, j_unexp = jconv.load_into(
        init, jconv.convert_reference_checkpoint(ckpt, cfg.model)[0])
    lines = []
    model = MMoERecModel(_port_cfg(cfg).model)
    missing, unexpected = tconv.load_reference_checkpoint(
        model, ckpt, _port_cfg(cfg).model, log=lines.append)
    assert (len(missing), len(unexpected)) == (len(j_missing),
                                               len(j_unexp)) == (1, 0)
    assert missing == ["head.gate_good.fc.bias"]
    assert lines[-1] == "[ckpt] loaded: 1 missing, 0 unexpected"


# ---------------------------------------------------------------------------
# the CLI: train -> eval / serve, and eval --reference-ckpt
# ---------------------------------------------------------------------------

def _valid_flags(shards):
    return [f"--data.valid_pattern={os.path.dirname(shards[0])}/*.tar.gz"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, shards):
    """`train --device=cpu` at the tiny widths, 2 optimizer steps with
    train.eval_every=1 over the eval shards (at most 2 batches)."""
    work = tmp_path_factory.mktemp("run")
    flags = [f"--train.checkpoint_dir={work / 'ckpt'}",
             f"--train.output_dir={work / 'out'}", *tiny_cli_flags(),
             *_valid_flags(shards)]
    assert cli.main(["train", "--device=cpu",
                     f"--data.train_pattern={os.path.dirname(shards[0])}/"
                     "*.tar.gz", "--train.epochs=1",
                     "--train.steps_per_epoch=4", "--train.optim.grad_accum=2",
                     "--train.log_every=1", "--train.eval_every=1",
                     "--train.eval_max_batches=2", *flags]) == 0
    return work, flags


def test_train_eval_every_logs_its_fields(trained, tmp_path, shards):
    work, _ = trained
    lines = [json.loads(line) for line in open(work / "out" / "metrics.jsonl")]
    evals = [line for line in lines if "eval_auc_good" in line]
    assert [line["step"] for line in evals] == [1, 2]
    for line in evals:
        assert line["eval_n"] == 2 * 4      # 2 batches of tiny batch 4
        assert 0.0 <= line["eval_auc_good"] <= 1.0
        assert set(line) - {"ts"} == {"epoch", "step", "eval_auc_good",
                                      "eval_auc_best", "eval_n"}
    with pytest.raises(FileNotFoundError, match="train.eval_every"):
        cli.main(["train", "--device=cpu",
                  f"--data.train_pattern={os.path.dirname(shards[0])}/"
                  "*.tar.gz", "--train.eval_every=1",
                  f"--data.valid_pattern={tmp_path}/none-*.tar.gz",
                  *tiny_cli_flags()])


def _restored(cfg):
    model = MMoERecModel(cfg.model)
    assert CheckpointManager(cfg.train.checkpoint_dir).restore_model(
        model) == 2
    return model


def test_cli_eval_on_the_trained_checkpoint(trained, shards, capsys):
    """`eval --device=cpu` loads the trained checkpoint and prints the AUCs
    evaluate() gives for that checkpoint restored in this process."""
    work, flags = trained
    assert cli.main(["eval", "--device=cpu", *flags]) == 0
    out = capsys.readouterr().out
    assert "[eval] restored step=2" in out
    res = json.loads(out.strip().splitlines()[-1])
    cfg = TConfig.from_flags(flags)
    want = evaluate(cfg, _restored(cfg), shards)
    assert res == {"auc_good": want["good"], "auc_best": want["best"],
                   "n": N_SAMPLES}
    assert os.path.exists(work / "out" / "preds.csv")


def test_cli_serve_loads_the_trained_checkpoint(trained):
    """`serve --checkpoint=<dir> --device=cpu` in a subprocess answers with
    the scores of a Predictor built from that checkpoint's state (LoRA
    merged), which equal the unmerged model's."""
    work, flags = trained
    cfg = TConfig.from_flags(flags)
    state = _restored(cfg).state_dict()
    merged = Predictor(cfg, state=state, batch_size=2, device="cpu")
    apart = Predictor(cfg, state=state, batch_size=2, merge_lora=False,
                      device="cpu")
    want = merged.predict(USERS[:1], ITEMS[:1])
    np.testing.assert_allclose(apart.predict(USERS[:1], ITEMS[:1])[
        "prob_good"], want["prob_good"], atol=PROB_ATOL)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmoe_multimodal_rec_tpu_torch", "serve",
         "--device=cpu", "--host=127.0.0.1", "--port=0", "--batch-size=2",
         f"--checkpoint={work / 'ckpt'}", *flags], cwd=work, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    watchdog = threading.Timer(180, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("{"):
                break
        assert any("[serve] restored step=2" in ln for ln in lines), lines
        port = int(json.loads(lines[-1])["serving"].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/predict", body=json.dumps({"instances": [
            {"user_text": USERS[0], "item_text": ITEMS[0]}]}),
            headers={"Content-Type": "application/json"})
        got = json.loads(conn.getresponse().read())["predictions"][0]
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["step"] == 2
        for key in ("prob_good", "prob_best"):
            assert abs(got[key] - float(want[key][0])) <= PROB_ATOL
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def test_cli_eval_reference_ckpt_matches_jax(cases, shards, tmp_path,
                                             capsys):
    """`eval --reference-ckpt` converts a reference .pt and prints the AUCs
    JAX's evaluate gives for the params JAX's converter makes of it."""
    from mmoe_multimodal_rec_tpu.eval.evaluate import evaluate as jevaluate
    case = cases["baseline"]
    ckpt = _reference_ckpt(case.cfg, 9)
    params, _ = jconv.convert_reference_checkpoint(ckpt, case.cfg.model)
    trainable, frozen = split_trainable(
        jax.tree.map(jax.numpy.asarray, params), "baseline")
    want = jevaluate(case.cfg, case.jmodel, trainable, frozen, {}, shards,
                     packer=case.jpacker, batch_size=BATCH,
                     eval_step=case.jeval)
    path = tmp_path / "ref.pt"
    torch.save({"epoch": 3, **{k: {kk: torch.from_numpy(vv)
                                   for kk, vv in v.items()}
                               for k, v in ckpt.items()}}, path)
    flags = [f"--train.output_dir={tmp_path / 'out'}",
             f"--train.batch_size={BATCH}", *tiny_cli_flags()[1:],
             *_valid_flags(shards)]
    assert cli.main(["eval", "--device=cpu", f"--reference-ckpt={path}",
                     *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "[ckpt] loaded: 0 missing, 0 unexpected" in lines
    res = json.loads(lines[-1])
    assert res["n"] == want["n"] == N_SAMPLES
    for task in ("good", "best"):
        assert abs(res[f"auc_{task}"] - want[task]) <= EVAL_AUC_TOL


def test_home_predictor_takes_batch_stats_or_a_state(cases):
    """HoME serving: the port's Predictor from JAX params + batch_stats, and
    from a (recalibrated) model's own state_dict, scores as the JAX
    Predictor does with the same batch_stats."""
    case = cases["home"]
    jpred = JPredictor(case.cfg, case.trainable, case.frozen, case.jstats,
                       batch_size=4, tokenizer=tiny_tokenizer(case.cfg))
    want = jpred.predict(USERS, ITEMS)
    from_params = Predictor(case.tcfg, case.flat, batch_stats=case.stats,
                            batch_size=4, device="cpu")
    from_state = Predictor(case.tcfg, state=case.port_model().state_dict(),
                           batch_size=4, device="cpu")
    for pred in (from_params, from_state):
        got = pred.predict(USERS, ITEMS)
        for key in ("prob_good", "prob_best"):
            np.testing.assert_allclose(got[key], want[key], atol=PROB_ATOL)
    with pytest.raises(ValueError, match="not both"):
        Predictor(case.tcfg, case.flat, state={}, device="cpu")
