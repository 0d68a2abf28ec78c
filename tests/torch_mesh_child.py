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
- `save`: a checkpoint directory to write after the steps;
- `saves`: true to record every quantised remat save the steps make
  (`SaveLog`, the rank's shard).
Per job it records the step metrics, every dropout keep mask the forward
drew (in call order, the rank's shard) and, on rank 0, the Trainer's
gathered state (`state_dict`).  Two jobs build no Trainer:
- `quantize`: an .npz key; the rank quantises its model shard of that
  [rows, n] array's columns at 8 and 4 bits over the model axis;
- `vit_layer`: an .npz key prefix holding a ViTLayer's state_dict and
  its `x` and `g`, with the ImageEncoderConfig in `image` and the
  remat policy in `policy`: the rank shards the layer, runs it forward in
  training mode and backward from g, and records its quantised saves, the
  output and the gradients of x and of the parameters (gathered).
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from mmoe_multimodal_rec_tpu_torch.config import Config, ImageEncoderConfig
from mmoe_multimodal_rec_tpu_torch.models import layers
from mmoe_multimodal_rec_tpu_torch.models.vit import ViTLayer
from mmoe_multimodal_rec_tpu_torch.parallel.mesh import (gather_shards,
                                                         make_mesh,
                                                         shard_model,
                                                         take_shard)
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


class SaveLog:
    """Records every quantised remat save (models/layers.quantize): the
    integers, the scale and x / scale, in call order."""

    def __init__(self):
        self.saves = []
        self._real = layers.quantize

        def quantize(x, bits=8, axis=None):
            q, sc = self._real(x, bits, axis)
            self.saves.append({"q": q.clone(), "sc": sc.clone(),
                               "r": (x.detach().float() / sc).clone(),
                               "bits": bits})
            return q, sc

        layers.quantize = quantize

    def close(self):
        layers.quantize = self._real


def unpack_int4(q):
    """The signed integers of an int4 save, its column halves side by
    side (models/layers.dequantize's order)."""
    return torch.cat([(q << 4) >> 4, q >> 4], dim=-1)


def vit_layer(image: dict, policy: str, params, x, g, mesh=None):
    """A float32 ViTLayer (use_flash, so the packed qkv path where the
    shape admits it) under remat `policy` with the state_dict `params`,
    sharded over `mesh`'s model axis when given: its training-mode output
    for x and the gradients of x and of the parameters (whole) from g."""
    layer = ViTLayer(ImageEncoderConfig(**image), torch.float32,
                     use_flash=True, remat_policy=policy)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    shardings = shard_model(layer, mesh) if mesh is not None else {}
    xi = torch.from_numpy(x).requires_grad_(True)
    out = layer(xi, deterministic=False, rng=torch.Generator().manual_seed(0))
    out.backward(torch.from_numpy(g))
    grads = {k: p.grad for k, p in layer.named_parameters()}
    if mesh is not None:
        grads = gather_shards(grads, shardings, mesh.model)
    return (out.detach().numpy(), xi.grad.numpy(),
            {k: v.numpy() for k, v in grads.items()})


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
        if job.get("quantize"):
            mesh = make_mesh(Config.from_dict(job["config"]).train.mesh)
            x = take_shard(torch.from_numpy(arrays[job["quantize"]]), 1,
                           mesh.model)
            for bits in (8, 4):
                q, sc = layers.quantize(x, bits, mesh.model)
                out[f"{j}/q{bits}"], out[f"{j}/sc{bits}"] = q.numpy(), \
                    sc.numpy()
            continue
        if job.get("vit_layer"):
            mesh = make_mesh(Config.from_dict(job["config"]).train.mesh)
            parts = prefixed(arrays, job["vit_layer"])
            x, g = parts.pop("x"), parts.pop("g")
            saves = SaveLog()
            try:
                y, gx, grads = vit_layer(job["image"], job["policy"], parts,
                                         x, g, mesh)
            finally:
                saves.close()
            out[f"{j}/out"], out[f"{j}/gx"] = y, gx
            out.update({f"{j}/grad/{k}": v for k, v in grads.items()})
            for i, rec in enumerate(saves.saves):
                out.update({f"{j}/save/{i}/{k}": np.asarray(v)
                            for k, v in rec.items()})
            continue
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
        saves = SaveLog() if job.get("saves") else None
        metrics = []
        try:
            for b in job["batches"]:
                metrics.append(trainer.run_step(prefixed(arrays, b)))
        finally:
            log.close()
            if saves is not None:
                saves.close()
        for i, rec in enumerate(saves.saves if saves is not None else ()):
            out.update({f"{j}/save/{i}/{k}": np.asarray(v)
                        for k, v in rec.items()})
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
