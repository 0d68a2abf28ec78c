"""Checkpoints with exact resume, in torch's own format.

Port of mmoe_multimodal_rec_tpu/train/checkpoint.py (which writes orbax).
The periodic payload `ckpt_<step>.pt` holds what changes during training:
the trainable parameters, the model's buffers (HoME's BatchNorm running
statistics), the optimizer and schedule state, the optimizer step count,
and `extra`, the resume position {epoch, opt_step_in_epoch,
host_step}.  The frozen base weights (BERT x2 + ViT, most of the model)
never change, so they are written once per run directory to
`frozen_once.pt`, beside a fingerprint that guards against resuming on a
different base snapshot or config.  The dropout streams need no saved
state: each micro-batch's generator is keyed on (train.seed + 1,
host_step, micro index) (train/loop.py), and the deterministic loader
fast-forwards host_step * grad_accum batches on restore.

Files are written to a temporary name and renamed, so a crash never leaves
a torn checkpoint; `max_to_keep` bounds the payloads kept.  Loading uses
`torch.load(weights_only=True)`, which unpickles tensors and plain
containers only.  `restore` resumes a Trainer; `restore_model` loads the
weights and BatchNorm statistics into a bare model for eval and serving,
with no optimizer.  A directory the JAX trainer wrote (orbax) is refused
with `check_not_orbax`, whose message names the converter: orbax stores
its arrays through tensorstore, which only orbax reads, so
tools/orbax_to_torch.py runs where the JAX package runs and writes this
layout, bit for bit.

A Trainer on a mesh (parallel/mesh.py) saves the one-process layout: every
rank takes part in gathering the model shards of the parameters and of
the AdamW state, rank 0 writes, and every rank waits for the write; each
rank restores its own shards from it, so a checkpoint restores on any
mesh, one process included.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_PAYLOAD = re.compile(r"^ckpt_(\d+)\.pt$")


def check_not_orbax(directory: str) -> None:
    """Raise ValueError naming the converter if `directory` holds the JAX
    trainer's orbax checkpoints (step subdirectories, `frozen_once/`)."""
    if not os.path.isdir(directory):
        return
    entries = [e for e in os.listdir(directory)
               if os.path.isdir(os.path.join(directory, e))]
    if any(e.isdigit() or e == "frozen_once" for e in entries):
        raise ValueError(
            f"{directory!r} holds orbax checkpoints of the JAX trainer; the "
            "port reads its own torch checkpoints.  Convert them where the "
            "JAX package is installed: python tools/orbax_to_torch.py "
            f"--checkpoint={directory} --output=<new dir> plus the run's "
            "--key=value model flags, then pass the new directory.")


def frozen_fingerprint(frozen: Dict[str, torch.Tensor]) -> str:
    """Content fingerprint of the frozen weights: every tensor's (name,
    shape, dtype) plus the bytes of its first 64 elements, fetched in one
    device-to-host copy."""
    keys = sorted(frozen)
    if not keys:
        return hashlib.sha256().hexdigest()
    samples = torch.cat([frozen[k].detach().reshape(-1)[:64].float()
                         for k in keys]).cpu()
    h = hashlib.sha256()
    offset = 0
    for key in keys:
        leaf = frozen[key]
        n = min(leaf.numel(), 64)
        h.update(key.encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(str(leaf.dtype).encode())
        h.update(samples[offset:offset + n].numpy().tobytes())
        offset += n
    return h.hexdigest()


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._frozen_path = os.path.join(self.directory, "frozen_once.pt")
        self._fp_path = os.path.join(self.directory,
                                     "frozen_once.fingerprint.json")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_PAYLOAD.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write_fingerprint(self, fp: str) -> None:
        with open(self._fp_path, "w") as f:
            json.dump({"sha256": fp}, f)

    def _check_frozen_fingerprint(self, frozen) -> None:
        """The frozen weights in memory must be the ones already on disk.
        A run directory with frozen_once.pt but no fingerprint file gets
        its fingerprint from the tensors ON DISK, after they are compared
        with the ones in memory."""
        fp = frozen_fingerprint(frozen)
        if os.path.exists(self._fp_path):
            with open(self._fp_path) as f:
                saved = json.load(f)["sha256"]
        else:
            saved = frozen_fingerprint(_load(self._frozen_path))
        if saved != fp:
            raise ValueError(
                f"frozen base weights do not match the frozen_once "
                f"checkpoint already in {self.directory!r} (saved "
                f"fingerprint {saved[:12]}..., current {fp[:12]}...): the "
                f"base snapshot or config changed. Use a fresh "
                f"checkpoint_dir.")
        if not os.path.exists(self._fp_path):
            self._write_fingerprint(saved)

    def save(self, step: int, trainer, extra: Optional[Dict] = None) -> None:
        """Write `trainer`'s state as checkpoint `step` (synchronously)."""
        frozen = trainer.frozen_state()
        payload = trainer.state_dict()
        if trainer.is_chief:
            self._write(step, frozen, payload, extra)
        if trainer.mesh is not None and dist.is_initialized():
            dist.barrier()

    def _write(self, step: int, frozen, payload, extra) -> None:
        if frozen:
            if not os.path.exists(self._frozen_path):
                _atomic_save(frozen, self._frozen_path)
                self._write_fingerprint(frozen_fingerprint(frozen))
            else:
                self._check_frozen_fingerprint(frozen)
        payload["extra"] = dict(extra or {})
        _atomic_save(payload, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, trainer, step: Optional[int] = None) -> Optional[Dict]:
        """Load checkpoint `step` (default: the latest) into `trainer`;
        returns its `extra`, or None when the directory holds none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = _load(self._path(step))
        frozen = (_load(self._frozen_path)
                  if os.path.exists(self._frozen_path) else None)
        trainer.load_state_dict(payload, frozen)
        return payload.get("extra", {})

    def restore_model(self, model: torch.nn.Module,
                      step: Optional[int] = None) -> Optional[int]:
        """Load checkpoint `step` (default: the latest) into a bare model:
        the trainable parameters, the buffers (HoME's BatchNorm statistics)
        and frozen_once.pt; no optimizer.  Strict: every parameter and
        buffer of the model must be there with its shape, and nothing else.
        Returns the optimizer steps the checkpoint had taken, or None when
        the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = _load(self._path(step))
        state = {**payload["trainable"], **payload.get("batch_stats", {})}
        if os.path.exists(self._frozen_path):
            state.update(_load(self._frozen_path))
        own = model.state_dict()
        missing = sorted(set(own) - set(state))
        unused = sorted(set(state) - set(own))
        if missing or unused:
            raise KeyError(f"checkpoint {self._path(step)!r} does not match "
                           f"the model: missing {missing}, unused {unused}")
        model.load_state_dict(state, strict=True)
        return int(payload["scheduler"]["last_epoch"])
