"""tools/orbax_to_torch.py: checkpoints of the JAX trainer (orbax) in the
PyTorch port's layout, on the CPU at tiny widths, baseline and HoME.

A JAX Trainer takes 2 optimizer steps (every rate 0; AdamW at eps 1 and
lr 0.1 with LoRA and HoME's img_ft group at the full lr from the first
update, as tests/test_torch_train.py's step) and saves step 2 with its
CheckpointManager; the converter turns it into the port's directory.
Held against the JAX package:

- every parameter, frozen tensor, BatchNorm statistic and AdamW moment
  bit for bit after the converter's transposes (the moments against the
  restored optax state), the AdamW steps and the schedule as the port's
  own Trainer leaves them after 2 steps;
- the port's `ckpt-info` reports JAX's steps, resume position and
  parameter counts;
- the port's `eval` on the converted directory writes the preds.csv that
  JAX's eval of the orbax directory writes, within 1e-5 (both fp32);
- one more step on the same batch gives JAX's next step within
  tests/test_torch_train.py's tolerances for a step (loss 1e-5, grad norm
  1e-4 relative, parameters 1e-6), and `train --train.resume=true`
  resumes the converted directory at its position;
- a pre-split payload (its frozen tree inside the step, no frozen_once/)
  converts to the same files."""
import csv
import json
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from flax import traverse_util

from mmoe_multimodal_rec_tpu import cli as jcli
from mmoe_multimodal_rec_tpu.config import Config as JConfig
from mmoe_multimodal_rec_tpu.eval.evaluate import evaluate_from_config
from mmoe_multimodal_rec_tpu.train import CheckpointManager as JCheckpoints
from mmoe_multimodal_rec_tpu.train import Trainer as JTrainer
from mmoe_multimodal_rec_tpu.train.checkpoint import (_stringify,
                                                      state_to_saveable)
from mmoe_multimodal_rec_tpu_torch import cli
from mmoe_multimodal_rec_tpu_torch.config import Config
from mmoe_multimodal_rec_tpu_torch.train.checkpoint import CheckpointManager
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
from mmoe_multimodal_rec_tpu_torch.utils.convert import params_from_jax
from util import stacked_batch, tiny_cli_flags

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import orbax_to_torch  # noqa: E402

EXTRA = {"epoch": 0, "opt_step_in_epoch": 2, "host_step": 2}


def _flags(variant):
    """The CLI flags of the tiny model (tests/util.tiny_cli_flags) and of
    the optimizer and rates `_jax_config` sets."""
    return tiny_cli_flags(variant) + [
        "--model.dropout=0.0", "--model.tower_dropout=0.0",
        "--model.home_expert_dropout=0.0", "--model.home_tower_dropout=0.0",
        "--model.text.hidden_dropout=0.0",
        "--model.text.attention_dropout=0.0",
        "--model.text.lora_dropout=0.0",
        "--train.optim.freeze_steps=-1", "--train.optim.unfreeze_steps=1",
        "--train.optim.home_freeze_steps=-1",
        "--train.optim.home_unfreeze_steps=1",
        "--train.optim.lr=0.1", "--train.optim.eps=1.0"]


def _jax_config(variant, *more):
    return JConfig.from_flags(_flags(variant) + list(more))


def _numpy(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module", params=["baseline", "home"])
def case(request, tmp_path_factory):
    """A JAX Trainer's 2 steps saved as orbax (split and pre-split), the
    converter's output, and JAX's step 3 on the batch of seed 2."""
    variant = request.param
    tmp = tmp_path_factory.mktemp(f"orbax_{variant}")
    jcfg = _jax_config(variant)
    trainer = JTrainer(jcfg)
    for s in range(2):
        trainer.run_step(stacked_batch(jcfg, seed=s))
    mngr = JCheckpoints(str(tmp / "jax"))
    mngr.save(trainer.host_step, trainer.state, extra=EXTRA, wait=True)
    mngr.close()
    pre = ocp.CheckpointManager(str(tmp / "jax_presplit"))
    pre.save(trainer.host_step, args=ocp.args.StandardSave(
        {**state_to_saveable(trainer.state, EXTRA),
         "frozen": _stringify(trainer.state.frozen)}))
    pre.wait_until_finished()
    pre.close()
    state = _numpy(trainer.state)
    pcfg = Config.from_flags(_flags(variant))
    out = orbax_to_torch.convert(str(tmp / "jax"), str(tmp / "port"), pcfg)
    metrics = trainer.run_step(stacked_batch(jcfg, seed=2))
    return {"variant": variant, "tmp": tmp, "jcfg": jcfg, "pcfg": pcfg,
            "state": state, "out": out, "trainer": trainer,
            "next": (_numpy(trainer.state.trainable),
                     {k: float(v) for k, v in metrics.items()})}


def _port(jax_key, value):
    (name, t), = params_from_jax({jax_key: np.asarray(value)}, None,
                                 merge_lora=False).items()
    return name, t


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_converted_tensors_are_jax_bit_for_bit(case):
    """Parameters, frozen tensors, BatchNorm statistics and AdamW moments
    equal JAX's restored values; the AdamW steps, param groups and the
    schedule equal those of the port's own Trainer after 2 steps."""
    state, port = case["state"], case["tmp"] / "port"
    assert case["out"]["step"] == 2 and case["out"]["resume"] == EXTRA
    assert case["out"]["files"] == ["ckpt_000000002.pt",
                                    "frozen_once.fingerprint.json",
                                    "frozen_once.pt"]
    payload = _load(port / "ckpt_000000002.pt")
    frozen = _load(port / "frozen_once.pt")
    assert payload["extra"] == EXTRA
    for group, tree in ((payload["trainable"], state.trainable),
                        (frozen, state.frozen)):
        assert len(group) == len(tree)
        for key, value in tree.items():
            name, want = _port("/".join(key), value)
            assert group[name].dtype == torch.float32
            assert torch.equal(group[name], want), name
    stats = traverse_util.flatten_dict(state.batch_stats or {})
    assert len(payload["batch_stats"]) == len(stats)
    assert bool(stats) == (case["variant"] == "home")
    for key, value in stats.items():
        assert np.array_equal(payload["batch_stats"][".".join(key)].numpy(),
                              value), key

    native = Trainer(case["pcfg"], device="cpu")
    for s in range(2):
        native.run_step(stacked_batch(case["jcfg"], seed=s))
    want_opt = native.optimizer.state_dict()
    assert payload["optimizer"]["param_groups"] == want_opt["param_groups"]
    assert payload["scheduler"] == native.scheduler.state_dict()
    index = {id(p): k for k, p in native.trainable.items()}
    names = [index[id(p)] for g in native.optimizer.param_groups
             for p in g["params"]]
    moments = {}
    adam = state.opt_state[1].inner_states
    for label, inner in adam.items():
        st = inner.inner_state[0]
        for m, tree in (("exp_avg", st.mu), ("exp_avg_sq", st.nu)):
            for key, value in tree.items():
                if not isinstance(value, optax.MaskedNode):
                    name, want = _port("/".join(key), value)
                    assert (m, name) not in moments
                    moments[m, name] = (int(st.count), want)
    got = payload["optimizer"]["state"]
    assert sorted(got) == list(range(len(names)))
    for i, name in enumerate(names):
        for m in ("exp_avg", "exp_avg_sq"):
            count, want = moments[m, name]
            assert torch.equal(got[i][m], want), (m, name)
        assert got[i]["step"].dtype == want_opt["state"][i]["step"].dtype
        assert float(got[i]["step"]) == count == 2
        assert set(got[i]) == set(want_opt["state"][i])


def test_ckpt_info_matches_jax(case, capsys):
    tmp = case["tmp"]
    assert jcli.main(["ckpt-info", f"--checkpoint={tmp / 'jax'}"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["ckpt-info", f"--checkpoint={tmp / 'port'}"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("steps", "latest_step", "resume", "frozen_once"):
        assert got[k] == want[k], k
    for part in ("trainable", "batch_stats"):
        assert got["param_counts"][part] == want["param_counts"][part]
    assert got["resume"] == EXTRA


def _preds(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["prob_good", "label_good", "prob_best", "label_best"]
    return np.array(rows[1:], np.float64)


def test_eval_of_converted_matches_jax_eval(case, capsys):
    """JAX's eval of the orbax directory and the port's `eval` of the
    converted one over the same synthetic shards: preds.csv within 1e-5."""
    tmp, variant = case["tmp"], case["variant"]
    assert cli.main(["synth", f"--output={tmp / 'shards'}", "--samples=48",
                     "--samples-per-shard=16"]) == 0
    pattern = f"--data.valid_pattern={tmp / 'shards'}/*.tar.gz"
    jcfg = _jax_config(variant, pattern,
                       f"--train.output_dir={tmp / 'jeval'}")
    # what JAX's `eval --checkpoint` does, on the fixture's Trainer
    restored, _ = JCheckpoints(str(tmp / "jax")).restore(
        case["trainer"].state)
    want = evaluate_from_config(jcfg, restored)
    assert cli.main(["eval", "--device=cpu", *_flags(variant), pattern,
                     f"--checkpoint={tmp / 'port'}",
                     f"--train.output_dir={tmp / 'peval'}"]) == 0
    out = capsys.readouterr().out
    assert "[eval] restored step=2" in out
    got = json.loads(out.strip().splitlines()[-1])
    assert got["n"] == want["n"] == 48
    np.testing.assert_allclose([got["auc_good"], got["auc_best"]],
                               [want["good"], want["best"]], atol=1e-4)
    g, w = _preds(tmp / "peval" / "preds.csv"), _preds(
        tmp / "jeval" / "preds.csv")
    assert g.shape == w.shape == (48, 4)
    np.testing.assert_array_equal(g[:, [1, 3]], w[:, [1, 3]])
    np.testing.assert_allclose(g[:, [0, 2]], w[:, [0, 2]], atol=1e-5)


def test_step_after_conversion_matches_jax_next_step(case):
    """The converted directory restored into the port's Trainer: one step
    on the batch of seed 2 against JAX's third step on it."""
    jparams, want = case["next"]
    trainer = Trainer(case["pcfg"], device="cpu")
    extra = CheckpointManager(str(case["tmp"] / "port")).restore(trainer)
    trainer.host_step = extra["host_step"]
    assert trainer.step == 2
    got = trainer.run_step(stacked_batch(case["jcfg"], seed=2))
    assert got["skipped_micro"] == 0 and trainer.step == 3
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    for key, value in jparams.items():
        name, p = _port("/".join(key), value)
        np.testing.assert_allclose(trainer.trainable[name].detach().numpy(),
                                   p.numpy(), atol=1e-6, err_msg=name)


def test_train_resume_and_presplit_conversion(case, capsys):
    """`train --train.resume=true` resumes the converted directory at its
    position; the pre-split payload converts to the same tensors."""
    tmp, variant = case["tmp"], case["variant"]
    presplit = orbax_to_torch.convert(str(tmp / "jax_presplit"),
                                      str(tmp / "port_presplit"),
                                      case["pcfg"])
    assert presplit["files"] == case["out"]["files"]
    for name in ("ckpt_000000002.pt", "frozen_once.pt"):
        a, b = _load(tmp / "port" / name), _load(tmp / "port_presplit" / name)
        flat = lambda t, p="": ({f"{p}{k}": v for k, v in t.items()
                                 if torch.is_tensor(v)} if isinstance(t, dict)
                                else {})
        for part in ((a, b),) if name == "frozen_once.pt" else (
                (a["trainable"], b["trainable"]),
                (a["batch_stats"], b["batch_stats"])):
            x, y = flat(part[0]), flat(part[1])
            assert x.keys() == y.keys()
            assert all(torch.equal(x[k], y[k]) for k in x)
        if name != "frozen_once.pt":
            for i, st in a["optimizer"]["state"].items():
                assert all(torch.equal(v, b["optimizer"]["state"][i][k])
                           for k, v in st.items())
            assert a["scheduler"] == b["scheduler"]
            assert a["extra"] == b["extra"]
    assert cli.main(["synth", f"--output={tmp / 'tshards'}", "--samples=16",
                     "--samples-per-shard=16"]) == 0
    assert cli.main(["train", "--device=cpu", *_flags(variant),
                     f"--data.train_pattern={tmp / 'tshards'}/*.tar.gz",
                     f"--train.checkpoint_dir={tmp / 'port_presplit'}",
                     f"--train.output_dir={tmp / 'tout'}",
                     "--train.resume=true", "--train.epochs=1",
                     "--train.steps_per_epoch=6",
                     "--train.optim.grad_accum=2",
                     "--train.log_every=1"]) == 0
    out = capsys.readouterr().out
    assert ("[resume] restored step=2 epoch=0 opt_step=2 host_step=2"
            in out)
    logged = [json.loads(line) for line in
              (tmp / "tout" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged if "loss" in r] == [3]
    assert CheckpointManager(str(tmp / "port_presplit")).latest_step() == 3
