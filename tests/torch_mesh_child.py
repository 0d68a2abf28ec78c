"""One rank of the gloo process groups that tests/test_torch_mesh.py starts.

It imports the port only (no JAX): its inputs come from the test through a
JSON spec and an .npz of numpy arrays, and it writes what it saw to
<out>/rank<r>.npz.  Run as

  python tests/torch_mesh_child.py <rank> <world> <init file> <spec.json>

with the spec's `jobs`, each one Trainer on the mesh of its config:
- `config`: the port Config as a dict (train.mesh sets dp x mp);
- `params` / `batch_stats`: a key prefix in the .npz (JAX-layout flat
  params), or null to initialise from train.seed;
- `restore`: a checkpoint directory to restore before the steps;
- `batches`: .npz key prefixes of stacked GLOBAL batches, one per step;
- `save`: a checkpoint directory to write after the steps.
Per job it records the step metrics, every dropout keep mask the forward
drew (in call order, the rank's shard) and, on rank 0, the Trainer's
gathered state (`state_dict`).
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from mmoe_multimodal_rec_tpu_torch.config import Config
from mmoe_multimodal_rec_tpu_torch.models import layers
from mmoe_multimodal_rec_tpu_torch.parallel.mesh import make_mesh
from mmoe_multimodal_rec_tpu_torch.train.checkpoint import CheckpointManager
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer


class MaskLog:
    """Records every keep mask of models/layers' dropout sites (the hash
    dropout and the short attentions' counter mask), in call order."""

    def __init__(self):
        self.masks = []
        self._hash, self._attn = layers.hash_keep_mask, layers.dropout_keep_mask

        def hash_keep_mask(*a, **k):
            m = self._hash(*a, **k)
            self.masks.append(m.detach().clone())
            return m

        def dropout_keep_mask(*a, **k):
            m = self._attn(*a, **k)
            self.masks.append(m.detach().clone())
            return m

        layers.hash_keep_mask = hash_keep_mask
        layers.dropout_keep_mask = dropout_keep_mask

    def close(self):
        layers.hash_keep_mask, layers.dropout_keep_mask = self._hash, self._attn


def flat_state(state):
    """A Trainer.state_dict() as flat numpy arrays, copied (on the CPU
    its tensors are the live parameters)."""
    out = {}
    for group in ("trainable", "batch_stats"):
        for k, v in state[group].items():
            out[f"{group}/{k}"] = v.numpy().copy()
    for i, st in state["optimizer"]["state"].items():
        for k, v in st.items():
            out[f"optimizer/{i}/{k}"] = v.numpy().copy()
    return out


def prefixed(arrays, prefix):
    if not prefix:
        return None
    n = len(prefix) + 1
    return {k[n:]: arrays[k] for k in arrays.files
            if k.startswith(prefix + "/")}


def main(rank: int, world: int, init_file: str, spec_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    with open(spec_path) as f:
        spec = json.load(f)
    arrays = np.load(spec["npz"])
    out = {}
    for j, job in enumerate(spec["jobs"]):
        cfg = Config.from_dict(job["config"])
        trainer = Trainer(cfg, device="cpu",
                          params=prefixed(arrays, job.get("params")),
                          batch_stats=prefixed(arrays,
                                               job.get("batch_stats")),
                          mesh=make_mesh(cfg.train.mesh))
        if job.get("restore"):
            extra = CheckpointManager(job["restore"]).restore(trainer)
            trainer.host_step = int(extra.get("host_step", 0))
            if rank == 0:
                out.update({f"{j}/restored/{k}": v for k, v in
                            flat_state(trainer.state_dict()).items()})
            else:
                trainer.state_dict()
        log = MaskLog()
        metrics = []
        try:
            for b in job["batches"]:
                metrics.append(trainer.run_step(prefixed(arrays, b)))
        finally:
            log.close()
        for i, m in enumerate(log.masks):
            out[f"{j}/mask/{i}"] = m.numpy()
        out[f"{j}/metrics"] = np.array(json.dumps(metrics))
        state = trainer.state_dict()
        if rank == 0:
            out.update({f"{j}/state/{k}": v
                        for k, v in flat_state(state).items()})
        if job.get("save"):
            CheckpointManager(job["save"]).save(trainer.host_step, trainer,
                                                extra={"host_step":
                                                       trainer.host_step})
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
