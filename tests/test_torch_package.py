"""Package-level checks of the PyTorch port: it imports neither JAX nor the
JAX package, its entry points run on the card unless asked for the CPU,
and its `serve` entry point starts, answers and stops.  The import and
serve checks run in a subprocess, because this test process has JAX loaded
(tests/conftest.py)."""
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from mmoe_multimodal_rec_tpu_torch import cli
from util import tiny_cli_flags

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT_PKG = REPO / "mmoe_multimodal_rec_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|orbax|"
    r"mmoe_multimodal_rec_tpu)(?![\w])", re.MULTILINE)


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    return env


def test_port_imports_no_jax():
    code = r"""
import importlib, json, pkgutil, sys
import mmoe_multimodal_rec_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
exported = {}
for sub in ("data", "models", "train", "eval", "ops", "utils", "parallel"):
    mod = importlib.import_module(pkg.__name__ + "." + sub)
    exported[sub] = sorted(n for n in mod.__all__ if getattr(mod, n))
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "mmoe_multimodal_rec_tpu"))
print(json.dumps({"modules": names, "bad": bad, "exported": exported}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("ops.flash_attention", "ops.cuda_lib", "ops.lora_dropout",
                "models.mmoe", "models.home",
                "eval.predict", "eval.server", "eval.auc", "eval.evaluate",
                "utils.convert", "utils.hf_convert", "cli",
                "train.losses", "train.optimizer", "train.step", "train.loop",
                "train.checkpoint", "train.preemption", "utils.metrics",
                "data.decode", "data.io", "data.tar_io", "data.synthetic",
                "data.loader", "data.pretokenize", "data.textbuild",
                "data.features", "data.minibeam", "data.beam_pipeline",
                "data.ingest", "data.patches", "data.native_tokenizer",
                "native", "models.text_expert", "utils.shared_base",
                "utils.scan_convert", "utils.lora", "utils.plotting",
                "parallel.mesh"):
        assert f"mmoe_multimodal_rec_tpu_torch.{mod}" in res["modules"]
    # each subpackage re-exports the JAX one's public names, but for the
    # JAX package's pytree plumbing and the split-attention function, whose
    # name is its module's
    import importlib
    not_exported = {"TrainState", "init_model_variables", "merge_params",
                    "param_labels", "flash_attention"}
    for sub, names in res["exported"].items():
        jax_all = importlib.import_module(
            f"mmoe_multimodal_rec_tpu.{sub}").__all__
        assert set(jax_all) - not_exported <= set(names), sub
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention
    assert callable(flash_attention.flash_attention)
    # imports inside functions too: no source line of the port names them
    for path in sorted(PORT_PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not _FORBIDDEN.search(path.read_text()), path


def test_port_mirrors_the_jax_package():
    """The port has a module for each of the JAX package's, and of its own
    only ops/cuda_lib.py (the kernels' loader) and utils/convert.py (JAX
    params into the port); nothing but minibeam's abstract methods raises
    NotImplementedError."""
    jax_pkg = REPO / "mmoe_multimodal_rec_tpu"
    files = lambda root: {str(p.relative_to(root))
                          for p in root.rglob("*.py")}
    assert files(jax_pkg) - files(PORT_PKG) == set()
    assert files(PORT_PKG) - files(jax_pkg) == {"ops/cuda_lib.py",
                                                "utils/convert.py"}
    raising = sorted(str(p.relative_to(PORT_PKG))
                     for p in PORT_PKG.rglob("*.py")
                     if "NotImplementedError" in p.read_text())
    assert raising == ["data/minibeam.py"]


def test_cli_usage_and_unported_options(capsys, tmp_path, monkeypatch):
    """Usage; a checkpoint that is not there raises before a model is
    built, and an orbax directory of the JAX trainer is refused, by eval,
    serve, ckpt-info and train, with the converter's command."""
    assert cli.main([]) == 2
    assert cli.main(["--help"]) == 0
    assert cli.main(["no-such-command"]) == 2
    usage = capsys.readouterr().out
    assert all(c in usage for c in ("synth", "train", "eval", "serve"))
    assert all(c in usage for c in (
        "features", "build-dataset", "patches", "ingest-meta",
        "ingest-reviews", "pretokenize", "validate", "ckpt-info"))
    for command in ("serve", "eval"):
        with pytest.raises(FileNotFoundError, match="--checkpoint"):
            cli.main([command, "--checkpoint=/nowhere", "--device=cpu"])
        with pytest.raises(FileNotFoundError, match="--reference-ckpt"):
            cli.main([command, "--reference-ckpt=/nowhere.pt",
                      "--device=cpu"])
    (tmp_path / "orbax" / "frozen_once").mkdir(parents=True)
    (tmp_path / "orbax" / "4").mkdir()
    (tmp_path / "shard.tar.gz").touch()
    converter = (r"orbax checkpoints.*python tools/orbax_to_torch.py "
                 rf"--checkpoint={tmp_path / 'orbax'} --output=")
    with pytest.raises(ValueError, match=converter):
        cli.main(["eval", f"--checkpoint={tmp_path / 'orbax'}",
                  "--device=cpu"])
    with pytest.raises(ValueError, match=converter):
        cli.main(["serve", "--device=cpu",
                  f"--train.checkpoint_dir={tmp_path / 'orbax'}"])
    with pytest.raises(ValueError, match=converter):
        cli.main(["ckpt-info", f"--checkpoint={tmp_path / 'orbax'}"])
    with pytest.raises(ValueError, match=converter):
        cli.main(["train", "--device=cpu", "--train.resume=true",
                  f"--data.train_pattern={tmp_path / 'shard.tar.gz'}",
                  f"--train.checkpoint_dir={tmp_path / 'orbax'}"])
    with pytest.raises(FileNotFoundError):
        cli.main(["ckpt-info", "--checkpoint=/nowhere"])
    # --multihost joins the group torchrun describes, and refuses to start
    # without it rather than train on one process
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["train", "--multihost", "--device=cpu"])


def test_entry_points_default_to_the_card(monkeypatch):
    """Trainer, Predictor and the CLI's --device all default to cuda, and
    with no card they raise instead of running on the CPU."""
    import inspect

    from mmoe_multimodal_rec_tpu_torch.config import tiny_config
    from mmoe_multimodal_rec_tpu_torch.eval.predict import Predictor
    from mmoe_multimodal_rec_tpu_torch.train.loop import (Trainer,
                                                          train_from_config)
    for fn in (Trainer.__init__, Predictor.__init__, train_from_config,
               cli._inference_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_config())
    for command in ("eval", "serve"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command])


def test_serve_entry_point_answers_and_stops(tmp_path):
    """`python -m mmoe_multimodal_rec_tpu_torch serve` on the CPU with seeded
    init weights: warns that it has no checkpoint, answers /healthz and
    /v1/predict, and exits 0 on SIGTERM."""
    cmd = [sys.executable, "-m", "mmoe_multimodal_rec_tpu_torch", "serve",
           "--device=cpu", "--host=127.0.0.1", "--port=0", "--batch-size=2",
           *tiny_cli_flags()]
    err = open(tmp_path / "stderr.txt", "w")
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=_env(),
                            stdout=subprocess.PIPE, stderr=err, text=True)
    watchdog = threading.Timer(180, proc.kill)  # a hang fails, not stalls
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("{"):
                break
        assert lines and lines[-1].startswith("{"), (
            lines, (tmp_path / "stderr.txt").read_text())
        info = json.loads(lines[-1])
        assert any("no checkpoint found, using init weights" in ln
                   for ln in lines)
        assert info["batch_size"] == 2
        port = int(info["serving"].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["lora_merged"] is True
        conn.request("POST", "/v1/predict", body=json.dumps({"instances": [
            {"user_text": "Nice tent.", "item_text": "Two-person tent."}]}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        pred = json.loads(resp.read())["predictions"][0]
        conn.close()
        assert resp.status == 200 and 0.0 < pred["prob_good"] < 1.0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        err.close()
