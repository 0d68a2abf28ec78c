"""The port's `train.profile` (torch.profiler in Trainer.fit) and its PNGs
(utils/plotting.py: the loss curves at the end of fit, the ROC curves
from evaluate), on the CPU at tiny widths.

The PNGs are held pixel for pixel (matplotlib.image.imread, equal arrays)
against the JAX package's plotting functions drawing the same series: the
history and epoch losses that fit returns, and the ROC curves that the JAX
package's auc module computes from the probabilities the port's eval step
gave.  Without matplotlib no PNG is written, one stderr line names each,
and metrics.jsonl and preds.csv are written all the same."""
import json
import sys

import numpy as np
import pytest
import torch
from matplotlib.image import imread

from mmoe_multimodal_rec_tpu.eval import auc as jauc
from mmoe_multimodal_rec_tpu.utils import plotting as jplot
from mmoe_multimodal_rec_tpu_torch import cli
from mmoe_multimodal_rec_tpu_torch.config import Config, tiny_config
from mmoe_multimodal_rec_tpu_torch.eval.evaluate import evaluate
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
from mmoe_multimodal_rec_tpu_torch.train.step import make_eval_step
from mmoe_multimodal_rec_tpu_torch.utils import plotting
from util import packed_batch

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

PNGS = ("train_loss_curves.png", "train_epoch_losses.png")


def _cfg(tmp_path, **train):
    cfg = tiny_config(data_parallel=1)
    cfg.train.output_dir = str(tmp_path / "out")
    cfg.train.profile_dir = str(tmp_path / "profile")
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return Config.from_dict(cfg.to_dict())


def _fit(cfg, epochs=2, opt_steps=2):
    """fit over `epochs` epochs of `opt_steps` optimizer steps (grad_accum
    micro-batches each) of seeded tiny batches."""
    micro = epochs * opt_steps * cfg.train.optim.grad_accum
    batches = [packed_batch(cfg, seed=s) for s in range(micro)]
    trainer = Trainer(cfg, device="cpu")
    result = trainer.fit(iter(batches), epochs=epochs,
                         steps_per_epoch=opt_steps * cfg.train.optim.grad_accum)
    return trainer, result


@pytest.mark.parametrize("start,steps,spans", [(1, 2, 2), (3, 5, 1)])
def test_fit_profile_traces_profile_steps_train_steps(tmp_path, start, steps,
                                                      spans):
    """fit with train.profile over 4 optimizer steps: a Chrome trace in
    profile_dir holding one `train_step` span per traced step, the window
    [profile_start, profile_start + profile_steps) cut at the end of fit."""
    cfg = _cfg(tmp_path, profile=True, profile_start=start,
               profile_steps=steps)
    _, result = _fit(cfg)
    assert len(result["history"]["step"]) == 4
    trace = json.loads((tmp_path / "profile" / "train_trace.json")
                       .read_text())
    events = [e for e in trace["traceEvents"]
              if e.get("name") == "train_step" and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    assert len(events) == spans
    # the optimizer steps inside the spans ran the model (autograd's
    # backward ops are in the trace) and nothing before the window
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and min(e["ts"] for e in ops) >= \
        min(e["ts"] for e in events) - 1e3


def test_fit_without_profile_writes_no_trace(tmp_path):
    _fit(_cfg(tmp_path), epochs=1, opt_steps=1)
    assert not (tmp_path / "profile").exists()


def _synth(tmp_path):
    assert cli.main(["synth", f"--output={tmp_path / 'shards'}",
                     "--samples=48", "--samples-per-shard=16"]) == 0
    return sorted(str(p) for p in (tmp_path / "shards").glob("*.tar.gz"))


def _jax_roc(outputs, directory):
    """The JAX package's evaluate's ROC figure of these eval outputs."""
    preds = jauc.StreamingPredictions()
    for out in outputs:
        preds.update(out)
    aucs = preds.aucs()
    curves = {}
    for task in ("good", "best"):
        labels, probs = preds.concatenated(task)
        if len(np.unique(labels)) == 2:
            fpr, tpr, _ = jauc.roc_curve(labels, probs)
            curves[task] = (fpr, tpr, aucs[task])
    assert set(curves) == {"good", "best"}
    return jplot.plot_roc(curves, str(directory))


def test_fit_and_evaluate_pngs_match_jax(tmp_path, capsys):
    """The loss curves of fit and the ROC curves of evaluate, pixel for
    pixel the JAX package's plotting of the same series."""
    cfg = _cfg(tmp_path)
    trainer, result = _fit(cfg)
    out = tmp_path / "out"
    history = result["history"]
    assert len(history["step"]) == 4 and len(result["epoch_losses"]
                                             ["total"]) == 2
    want = tmp_path / "jax"
    jplot.plot_loss_curves(history["step"],
                           {"total": history["loss"],
                            "main": history["main_loss"],
                            "contrastive": history["contrastive_loss"]},
                           str(want))
    jplot.plot_epoch_losses(result["epoch_losses"], str(want))
    for png in PNGS:
        assert np.array_equal(imread(out / png), imread(want / png)), png

    step = make_eval_step(cfg, trainer.model)
    outputs = []

    def recorded(batch):
        o = step(batch)
        outputs.append({k: v.cpu().numpy() for k, v in o.items()})
        return o
    r = evaluate(cfg, trainer.model, _synth(tmp_path),
                 output_dir=str(tmp_path / "eval"), save_preds="preds.csv",
                 eval_step=recorded)
    assert r["n"] == 48
    got = imread(tmp_path / "eval" / "roc_curve.png")
    assert np.array_equal(got, imread(_jax_roc(outputs, want)))
    assert "not written" not in capsys.readouterr().err


def test_without_matplotlib_no_png_and_a_line_each(tmp_path, monkeypatch,
                                                   capsys):
    """matplotlib hidden from the import: fit and evaluate write
    metrics.jsonl and preds.csv, no PNG, and one stderr line per PNG
    naming it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    cfg = _cfg(tmp_path)
    trainer, _ = _fit(cfg, epochs=1)
    evaluate(cfg, trainer.model, _synth(tmp_path),
             output_dir=cfg.train.output_dir, save_preds="preds.csv")
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir()) == ["metrics.jsonl",
                                                     "preds.csv"]
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if "not written" in ln]
    assert [ln.split(": ")[-1] for ln in lines] == [
        f"{out / name} not written" for name in PNGS + ("roc_curve.png",)]


def test_other_plotting_failures_propagate(tmp_path, monkeypatch):
    """Only the ImportError of matplotlib itself is caught."""
    class Broken:
        __name__ = "matplotlib"

        @staticmethod
        def use(backend):
            raise RuntimeError("backend refused")
    monkeypatch.setitem(sys.modules, "matplotlib", Broken())
    with pytest.raises(RuntimeError, match="backend refused"):
        plotting.plot_epoch_losses({"total": [1.0]}, str(tmp_path))

    def missing_dependency(name, *a, **k):
        err = ImportError("No module named 'kiwisolver'")
        err.name = "kiwisolver"
        raise err
    monkeypatch.delitem(sys.modules, "matplotlib")
    monkeypatch.setattr("builtins.__import__", missing_dependency)
    with pytest.raises(ImportError, match="kiwisolver"):
        plotting.plot_roc({}, str(tmp_path))
