"""Convert a checkpoint of the JAX trainer (orbax) into the PyTorch port's.

    python tools/orbax_to_torch.py --checkpoint=<JAX checkpoint_dir> \\
        --output=<port checkpoint_dir> [--step=N] [--key=value ...]

Reads the `checkpoint_dir` that mmoe_multimodal_rec_tpu/train/checkpoint.py
writes (a step directory per save, the frozen base weights once in
`frozen_once/`; or a pre-split payload that holds the frozen tree itself)
and writes the layout of mmoe_multimodal_rec_tpu_torch/train/checkpoint.py:
`frozen_once.pt` with its fingerprint, and `ckpt_<step>.pt` with the
trainable parameters, the BatchNorm statistics, the AdamW and schedule
state and the resume position.  `eval`, `serve`, `ckpt-info` and
`train --train.resume=true` of the port then read the output directory as
one the port wrote.

orbax stores its arrays through tensorstore (OCDBT, zstd-compressed
chunks), which only orbax reads, so the conversion runs where the JAX
package runs (a TPU host, or any host with the JAX package installed);
the GPU host needs only the output, which torch.load reads.

`--step` picks the saved step (default: the latest).  The `--key=value`
overrides are the CLI's (`--model.variant=home`, the widths of a tiny run,
...) and must describe the model the JAX run trained: the port's Trainer is
built from them on the CPU, the checkpoint's parameters are carried into it
(utils/convert.load_jax_params: kernels transposed, `scale`/`embedding`
renamed), and the optimizer state follows the parameters:

- JAX's optimizer is optax.chain(clip_by_global_norm, multi_transform({
  other, lora, img_ft: adamw})), so its state is, per label,
  ScaleByAdamState(count, mu, nu) over the whole trainable tree with the
  other labels' leaves masked out (None), beside the schedule's count;
- mu and nu become torch AdamW's exp_avg and exp_avg_sq of the same
  parameter, transposed as the parameter is; each label's count becomes
  the `step` of its parameters (AdamW's bias correction reads it), and
  the optimizer step count becomes the LambdaLR schedule's last_epoch.

Every tensor comes across bit for bit (tests/test_torch_orbax.py).  The
files are written by the port's own CheckpointManager.  Prints one JSON
line: the step, its resume position, the files written and the seconds.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

_SEP = "|"   # the JAX checkpoint's key separator (train/checkpoint.py)


def _restore(path: str):
    """An orbax StandardSave item as numpy arrays, whatever the topology it
    was saved on: the target is built from the item's own metadata."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(path)
    tree = getattr(meta, "item_metadata", meta)
    tree = getattr(tree, "tree", tree)
    target = jax.tree.map(
        lambda m: np.empty(m.shape, m.dtype) if hasattr(m, "dtype") else m,
        tree)
    return ckptr.restore(path, target)


def read_orbax(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The payload of step `step` (default: the latest) of a JAX
    checkpoint_dir, with its frozen tree: {'step', 'extra', 'trainable',
    'frozen', 'batch_stats', 'opt_state'} (parameter keys '/'-joined,
    arrays numpy)."""
    directory = os.path.abspath(directory)
    steps = sorted(int(e) for e in os.listdir(directory)
                   if e.isdigit() and os.path.isdir(os.path.join(directory,
                                                                 e)))
    if not steps:
        raise FileNotFoundError(f"{directory!r} holds no orbax step")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"{directory!r} has no step {step}: {steps}")
    saved = _restore(os.path.join(directory, str(step), "default"))
    frozen_dir = os.path.join(directory, "frozen_once")
    if os.path.isdir(frozen_dir):
        frozen = _restore(frozen_dir)
    elif saved.get("frozen") is not None:   # a pre-split payload
        frozen = saved["frozen"]
    else:
        raise FileNotFoundError(f"{directory!r} holds neither frozen_once/ "
                                f"nor a payload with its frozen tree")
    from flax import traverse_util
    key = lambda k: k.replace(_SEP, "/")
    return {"step": int(saved["step"]), "orbax_step": step,
            "extra": {k: int(v) for k, v in (saved.get("extra")
                                             or {}).items()},
            "trainable": {key(k): v for k, v in saved["trainable"].items()},
            "frozen": {key(k): v for k, v in frozen.items()},
            "batch_stats": traverse_util.flatten_dict(
                saved.get("batch_stats") or {}, sep="/"),
            "opt_state": saved["opt_state"]}


def adam_states(opt_state) -> Dict[str, Dict[str, Any]]:
    """{label: {'count', 'mu', 'nu', 'schedule_count'}} out of the restored
    optax chain state: mu and nu keyed by '/'-joined parameter path, the
    masked leaves dropped."""
    inner = None
    for part in opt_state:
        if isinstance(part, dict) and "inner_states" in part:
            inner = part["inner_states"]
    if inner is None:
        raise ValueError("the optimizer state holds no multi_transform "
                         "(train/optimizer.make_optimizer's chain)")
    out = {}
    for label, state in inner.items():
        adam, *rest = state["inner_state"]
        path = lambda k: "/".join(ast.literal_eval(k))
        out[label] = {
            "count": int(adam["count"]),
            "mu": {path(k): v for k, v in adam["mu"].items()
                   if v is not None},
            "nu": {path(k): v for k, v in adam["nu"].items()
                   if v is not None},
            "schedule_count": [int(r["count"]) for r in rest
                               if isinstance(r, dict) and "count" in r]}
    return out


def load_optimizer(trainer, opt_state, step: int) -> None:
    """Fill `trainer`'s AdamW state and LambdaLR from JAX's optax state
    after `step` optimizer steps (module docstring)."""
    import torch

    from mmoe_multimodal_rec_tpu_torch.utils.convert import params_from_jax

    want = {}
    for label, st in adam_states(opt_state).items():
        if any(c != st["count"] for c in st["schedule_count"]) or \
                st["count"] != step:
            raise ValueError(f"optimizer label {label!r}: counts "
                             f"{st['count']}/{st['schedule_count']} differ "
                             f"from the optimizer step {step}")
        if set(st["mu"]) != set(st["nu"]):
            raise ValueError(f"optimizer label {label!r}: mu and nu cover "
                             "different parameters")
        for jkey in st["mu"]:
            moments = [params_from_jax({jkey: st[m][jkey]}, None,
                                       merge_lora=False) for m in ("mu", "nu")]
            (name, mu), = moments[0].items()
            (_, nu), = moments[1].items()
            want[name] = (st["count"], mu, nu)
    missing = sorted(set(trainer.trainable) - set(want))
    unused = sorted(set(want) - set(trainer.trainable))
    if missing or unused:
        raise KeyError(f"optimizer state does not match the trainable "
                       f"parameters: missing {missing}, unused {unused}")
    for name, p in trainer.trainable.items():
        count, mu, nu = want[name]
        if mu.shape != p.shape:
            raise ValueError(f"{name}: moments {tuple(mu.shape)}, parameter "
                             f"{tuple(p.shape)}")
        trainer.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu.to(p.dtype), "exp_avg_sq": nu.to(p.dtype)}
    sched = trainer.scheduler
    lrs = [base * factor(step)
           for factor, base in zip(sched.lr_lambdas, sched.base_lrs)]
    for group, lr in zip(trainer.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched.last_epoch = step
    sched._last_lr = lrs
    sched._step_count = step + 1


def convert(checkpoint: str, output: str, cfg, step: Optional[int] = None
            ) -> Dict[str, Any]:
    """Convert step `step` (default: the latest) of the JAX checkpoint_dir
    `checkpoint` for the model of the port Config `cfg` into the port's
    checkpoint directory `output`."""
    from mmoe_multimodal_rec_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    saved = read_orbax(checkpoint, step)
    read_s = time.perf_counter() - t0
    # a strict load: the flags must give the model the JAX run trained
    trainer = Trainer(cfg, device="cpu",
                      params={**saved["frozen"], **saved["trainable"]},
                      batch_stats=saved["batch_stats"])
    load_optimizer(trainer, saved["opt_state"], saved["step"])
    CheckpointManager(output).save(saved["orbax_step"], trainer,
                                   extra=saved["extra"])
    files: List[str] = sorted(os.listdir(output))
    return {"step": saved["orbax_step"], "optimizer_steps": saved["step"],
            "resume": saved["extra"], "output": os.path.abspath(output),
            "files": files, "read_s": read_s,
            "seconds": time.perf_counter() - t0}


def main(argv: Optional[List[str]] = None) -> int:
    from mmoe_multimodal_rec_tpu_torch.cli import _split_flags
    from mmoe_multimodal_rec_tpu_torch.config import Config

    argv = sys.argv[1:] if argv is None else argv
    cfg_flags, rest = _split_flags(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="the JAX trainer's checkpoint_dir (orbax)")
    ap.add_argument("--output", required=True,
                    help="the port's checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None,
                    help="the orbax step to convert (default: the latest)")
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)
    print(json.dumps(convert(args.checkpoint, args.output, cfg, args.step)))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
