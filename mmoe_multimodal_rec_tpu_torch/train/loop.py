"""Trainer: builds the model and optimizer, runs optimizer steps, and
drives the epoch loop with logging, checkpointing and resume.

Port of mmoe_multimodal_rec_tpu/train/loop.py:
- `Trainer` initialises the model, baseline or HoME, from train.seed (or
  loads JAX params and batch_stats), freezes what `label_param` freezes,
  and runs `train/step.py`'s step;
- the dropout stream of micro-batch i of a step is a torch.Generator keyed
  on (train.seed + 1, host_step, i): a pure function of the step index, so
  resume needs no RNG state, only the counter.  `host_step` counts
  NaN-skipped steps too, so a resumed run's streams line up across skips;
- `fit` stacks `grad_accum` micro-batches per step and stages them on the
  device ahead of the step (data/loader.device_prefetch), logs to
  output_dir/metrics.jsonl every `log_every` steps, writes checkpoints per
  epoch and every `checkpoint_every` steps with the exact resume position,
  and on SIGTERM saves and returns (train/preemption.py);
- `train.eval_every` evaluates the model on data.valid_pattern every that
  many optimizer steps (at most `train.eval_max_batches` batches) and logs
  eval_auc_good, eval_auc_best and eval_n;
- `train.profile` traces optimizer steps [profile_start, profile_start +
  profile_steps) of the `fit` call under torch.profiler (CPU activity, and
  CUDA on a card), each step in a `train_step` span, and writes a Chrome
  trace to train.profile_dir (`train_trace.json`, on a mesh
  `train_trace.rank<r>.json` per rank);
- the end of `fit` draws the loss curves into output_dir
  (utils/plotting: train_loss_curves.png, train_epoch_losses.png).
On a mesh (`Trainer(..., mesh=parallel.mesh.make_mesh(cfg.train.mesh))`
in every process of a torch.distributed group; `train --multihost`) each
rank holds its model shards (parallel/mesh.shard_model) and their AdamW
state, and computes the one-process step on the same global batch:
`run_step` takes the rank's share of a global batch, `fit` the rank's
own loader (`train_from_config` gives data rank r of dp the loader of
host r of dp at batch_size / dp samples), whose sentence arrays it makes
global first.  train.batch_size stays the GLOBAL micro-batch.  Rank 0
logs and writes checkpoints in the one-process layout (gathered), and a
checkpoint restores on any mesh.  `train.eval_every` evaluates the whole
validation pass on every rank (model-parallel where the model is), which
gives the one-process AUCs of the same weights.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.loader import device_prefetch, make_train_loader
from ..data.packer import packer_from_config
from ..models.layers import init_weights
from ..models.mmoe import DTYPES, MMoERecModel
from ..parallel.mesh import (DataShard, Mesh, all_gather_rows,
                             check_divisible, gather_shards, make_mesh,
                             shard_batch, shard_model, take_shard)
from ..utils.convert import load_jax_params
from ..utils.metrics import MetricsLogger, Throughput
from ..utils.plotting import plot_epoch_losses, plot_loss_curves
from .checkpoint import CheckpointManager, check_not_orbax
from .optimizer import make_optimizer, split_trainable
from .preemption import PreemptionGuard
from .step import make_train_step


def dummy_batch(cfg: Config, batch_size: Optional[int] = None,
                accum: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Zero batch with the training shapes."""
    b = batch_size or cfg.train.batch_size
    pk = cfg.model.packer
    n = pk.chunk_budget or b * pk.max_chunks_per_sample
    s = pk.fixed_sent_count
    img = cfg.model.image
    batch = {
        "user_tokens": np.zeros((n, pk.max_tok), np.int32),
        "user_sent_chunk": np.full((b, s), -1, np.int32),
        "user_sent_tok": np.full((b, s), -1, np.int32),
        "item_tokens": np.zeros((n, pk.max_tok), np.int32),
        "item_sent_chunk": np.full((b, s), -1, np.int32),
        "item_sent_tok": np.full((b, s), -1, np.int32),
        "patches": np.zeros((b, img.num_patches, img.patch_dim), np.uint8),
        "has_image": np.zeros((b,), np.int32),
        "label_good": np.zeros((b,), np.float32),
        "label_best": np.zeros((b,), np.float32),
    }
    if accum:
        batch = {k: np.broadcast_to(v, (accum,) + v.shape).copy()
                 for k, v in batch.items()}
    return batch


def stack_micro_batches(batches) -> Dict[str, np.ndarray]:
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]
            if k != "valid"}


def dropout_generator(seed: int, host_step: int, micro: int
                      ) -> torch.Generator:
    """The dropout stream of one micro-batch: a CPU generator seeded from
    (seed, host_step, micro) through numpy's SeedSequence."""
    state = np.random.SeedSequence([seed, host_step, micro]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


class Trainer:
    def __init__(self, cfg: Config, device="cuda",
                 params: Optional[Mapping[str, np.ndarray]] = None,
                 batch_stats: Optional[Mapping[str, np.ndarray]] = None,
                 mesh: Optional[Mesh] = None):
        """params: the JAX param tree flattened with '/'-joined keys (numpy,
        LoRA unmerged), and batch_stats its HoME BatchNorm statistics
        flattened the same way; None initialises from train.seed.  mesh:
        this rank's parallel.mesh.Mesh (every rank builds the whole model
        from the same seed or params, then keeps its shards)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train "
                               "on the plain PyTorch path")
        self.cfg = cfg
        variant = cfg.model.variant
        self.model = MMoERecModel(cfg.model)
        if params is None:
            init_weights(self.model,
                         torch.Generator().manual_seed(cfg.train.seed))
        else:
            load_jax_params(self.model, params, cfg.model, merge_lora=False,
                            batch_stats=batch_stats)
        self.mesh = mesh
        self.shardings: Dict[str, Optional[int]] = {}
        if mesh is not None:
            check_divisible(cfg.train.batch_size, cfg.model.packer.chunk_budget,
                            mesh)
            self.shardings = shard_model(self.model, mesh)
        self.model.to(device=self.device,
                      dtype=DTYPES[cfg.model.param_dtype])
        self.trainable, self.frozen = split_trainable(self.model, variant)
        self.optimizer, self.scheduler = make_optimizer(
            cfg.train.optim, variant, self.trainable)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          self.scheduler, mesh,
                                          self.shardings)
        # optimizer steps are counted by the schedule; host_step also
        # counts skipped steps and keys the dropout and data streams
        self.host_step = 0

    @property
    def step(self) -> int:
        """Optimizer steps taken (skipped steps excluded)."""
        return self.scheduler.last_epoch

    @property
    def is_chief(self) -> bool:
        """Whether this process logs and writes checkpoints (rank 0)."""
        return not (self.mesh is not None and dist.is_initialized()
                    and dist.get_rank() != 0)

    def to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.ascontiguousarray(v)
                                   if isinstance(v, np.ndarray) else v
                                   ).to(self.device)
                for k, v in batch.items() if k != "valid"}

    def run_step(self, stacked_batch, local: bool = False
                 ) -> Dict[str, float]:
        """One optimizer step over stacked micro-batches [accum, ...]
        (numpy arrays or tensors; tensors already on the device stay put).
        On a mesh the batch is the GLOBAL one, of which the rank takes its
        share, unless `local`: then it is the rank's own loader's share,
        whose sentence arrays index its own chunk rows."""
        if self.mesh is not None and not local:
            stacked_batch = shard_batch(stacked_batch, self.mesh,
                                        accum_dim=True)
        stacked_batch = self.to_device(stacked_batch)
        if self.mesh is not None and local:
            stacked_batch = self._global_sentences(stacked_batch)
        accum = self.cfg.train.optim.grad_accum
        rngs = [dropout_generator(self.cfg.train.seed + 1, self.host_step, i)
                for i in range(accum)]
        if self.mesh is not None:
            rngs = [DataShard(g, self.mesh.data) for g in rngs]
        self.host_step += 1
        return self.train_step(stacked_batch, rngs)

    def _global_sentences(self, batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """A rank's loader batch with the global micro-batch's sentence
        arrays: its chunk indices moved to its rows of the global chunk
        axis, then every rank's gathered in rank order."""
        data = self.mesh.data
        out = dict(batch)
        for side in ("user", "item"):
            chunk = batch[f"{side}_sent_chunk"]
            n = batch[f"{side}_tokens"].shape[1]
            chunk = torch.where(chunk >= 0, chunk + data.rank * n, chunk)
            for key, x in ((f"{side}_sent_chunk", chunk),
                           (f"{side}_sent_tok", batch[f"{side}_sent_tok"])):
                out[key] = all_gather_rows(x.transpose(0, 1),
                                           data).transpose(0, 1).contiguous()
        return out

    # -- checkpoint state ----------------------------------------------------
    def _opt_dims(self) -> List[Optional[int]]:
        """The model-shard dimension of each optimizer state slot, in the
        optimizer's parameter order."""
        names = {id(p): k for k, p in self.trainable.items()}
        return [self.shardings.get(names[id(p)])
                for g in self.optimizer.param_groups for p in g["params"]]

    def _model_axis(self):
        return self.mesh.model if self.mesh is not None else None

    def state_dict(self) -> Dict[str, Any]:
        """The checkpoint payload in the one-process layout: on a mesh
        every model shard gathered (each rank of the model group takes
        part)."""
        opt = self.optimizer.state_dict()
        axis = self._model_axis()
        if axis is not None and axis.size > 1:
            dims = self._opt_dims()
            opt["state"] = {i: gather_shards(
                st, {k: dims[i] for k, v in st.items() if v.dim()}, axis)
                for i, st in sorted(opt["state"].items())}
            trainable = gather_shards(self.trainable, self.shardings, axis)
        else:
            trainable = {k: p.detach().cpu()
                         for k, p in self.trainable.items()}
        return {"trainable": trainable,
                "batch_stats": {k: b.detach().cpu()
                                for k, b in self.model.named_buffers()},
                "optimizer": opt,
                "scheduler": self.scheduler.state_dict()}

    def frozen_state(self) -> Dict[str, torch.Tensor]:
        """The frozen parameters, whole, on the CPU (gathered on a mesh)."""
        axis = self._model_axis()
        if axis is not None and axis.size > 1:
            return gather_shards(self.frozen, self.shardings, axis)
        return {k: v.detach().cpu() for k, v in self.frozen.items()}

    def load_state_dict(self, payload: Mapping[str, Any],
                        frozen: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> None:
        """Strict: every trainable tensor and BatchNorm statistic (and,
        when given, frozen tensor) must be in the checkpoint with its
        shape.  The payload is in the one-process layout; on a mesh each
        rank keeps its shards."""
        buffers = dict(self.model.named_buffers())
        with torch.no_grad():
            for group, saved in ((self.trainable, payload["trainable"]),
                                 (buffers, payload.get("batch_stats", {})),
                                 (self.frozen, frozen)):
                if saved is None:
                    continue
                missing = sorted(set(group) - set(saved))
                if missing:
                    raise KeyError(f"checkpoint lacks {missing}")
                for k, p in group.items():
                    p.copy_(take_shard(saved[k], self.shardings.get(k),
                                       self._model_axis()))
        opt = payload["optimizer"]
        axis = self._model_axis()
        if axis is not None and axis.size > 1:
            dims = self._opt_dims()
            opt = dict(opt, state={
                i: {k: take_shard(v, dims[i] if v.dim() else None, axis)
                    for k, v in st.items()}
                for i, st in opt["state"].items()})
        self.optimizer.load_state_dict(opt)
        self.scheduler.load_state_dict(payload["scheduler"])

    # -- epoch loop ----------------------------------------------------------
    def fit(self, loader_iter: Iterator[Dict[str, np.ndarray]],
            epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None,
            logger: Optional[MetricsLogger] = None,
            ckpt: Optional[CheckpointManager] = None,
            start_epoch: int = 0, start_opt_step: int = 0,
            preempt: Optional[PreemptionGuard] = None,
            eval_fn: Optional[Callable[["Trainer"], Dict]] = None
            ) -> Dict[str, Any]:
        """eval_fn(trainer) -> {'good', 'best', 'n'}: run every
        train.eval_every optimizer steps when given."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.train.epochs
        accum = cfg.train.optim.grad_accum
        micro_steps = steps_per_epoch if steps_per_epoch is not None else (
            cfg.train.home_steps_per_epoch if cfg.model.variant == "home"
            else cfg.train.steps_per_epoch)
        opt_steps = micro_steps // accum
        if logger is None:
            logger = (MetricsLogger(os.path.join(cfg.train.output_dir,
                                                 "metrics.jsonl"))
                      if self.is_chief else MetricsLogger(echo=False))
        meter = Throughput()
        history: Dict[str, List] = {"step": [], "loss": [], "main_loss": [],
                                    "contrastive_loss": []}
        epoch_losses: Dict[str, List[float]] = {"total": [], "main": [],
                                                "contrastive": []}
        global_examples = accum * cfg.train.batch_size
        it = iter(loader_iter)

        def stacked_iter():
            while True:
                micro = []
                try:
                    for _ in range(accum):
                        micro.append(next(it))
                except StopIteration:
                    return
                yield stack_micro_batches(micro)

        staged = device_prefetch(stacked_iter(), n=cfg.data.num_prefetch,
                                 device=self.device)
        exhausted = preempted = False
        profiler = None
        total_opt_steps = 0
        for epoch in range(start_epoch, epochs):
            ep_main = ep_cl = 0.0
            ep_n = 0
            first = start_opt_step if epoch == start_epoch else 0
            for opt_step in range(first, opt_steps):
                requested = preempt is not None and preempt.requested
                batch = None
                if not requested:
                    batch = next(staged, None)
                if self.mesh is not None:
                    # every rank stops where any one must
                    requested, missing = self._agree(requested,
                                                     batch is None)
                else:
                    missing = batch is None
                if requested:
                    # SIGTERM: save at the exact resume position (unless a
                    # periodic save already sits at this host_step) and stop
                    if ckpt is not None and \
                            ckpt.latest_step() != self.host_step:
                        ckpt.save(self.host_step, self,
                                  extra=self._resume_extra(epoch, opt_step))
                    preempted = True
                    break
                if missing:
                    exhausted = True
                    break
                if cfg.train.profile:
                    if total_opt_steps == cfg.train.profile_start:
                        profiler = self._start_profile()
                    elif profiler is not None and total_opt_steps == (
                            cfg.train.profile_start
                            + cfg.train.profile_steps):
                        self._stop_profile(profiler)
                        profiler = None
                total_opt_steps += 1
                span = (torch.profiler.record_function("train_step")
                        if profiler is not None
                        else contextlib.nullcontext())
                with span:
                    m = self.run_step(batch, local=self.mesh is not None)
                meter.update(global_examples)
                history["step"].append(self.host_step)
                for k in ("loss", "main_loss", "contrastive_loss"):
                    history[k].append(m[k])
                ep_main += m["main_loss"]
                ep_cl += m["contrastive_loss"]
                ep_n += 1
                if self.host_step % cfg.train.log_every == 0:
                    logger.log({"epoch": epoch, "step": self.host_step,
                                "examples_per_sec": meter.rate(), **m})
                if cfg.train.checkpoint_every and ckpt is not None and \
                        (opt_step + 1) % cfg.train.checkpoint_every == 0:
                    ckpt.save(self.host_step, self,
                              extra=self._resume_extra(epoch, opt_step + 1))
                if cfg.train.eval_every and eval_fn is not None and \
                        (opt_step + 1) % cfg.train.eval_every == 0:
                    r = eval_fn(self)
                    logger.log({"epoch": epoch, "step": self.host_step,
                                "eval_auc_good": r["good"],
                                "eval_auc_best": r["best"],
                                "eval_n": r["n"]})
            if preempted:
                break
            if ep_n:
                epoch_losses["main"].append(ep_main / ep_n)
                epoch_losses["contrastive"].append(ep_cl / ep_n)
                epoch_losses["total"].append((ep_main + ep_cl) / ep_n)
                logger.log({"epoch": epoch,
                            "epoch_loss": epoch_losses["total"][-1]})
                if ckpt is not None:
                    ckpt.save(self.host_step, self,
                              extra=self._resume_extra(epoch + 1, 0))
            if exhausted:
                break
        if profiler is not None:
            self._stop_profile(profiler)
        if self.is_chief:
            out_dir = cfg.train.output_dir
            os.makedirs(out_dir, exist_ok=True)
            plot_loss_curves(history["step"],
                             {"total": history["loss"],
                              "main": history["main_loss"],
                              "contrastive": history["contrastive_loss"]},
                             out_dir)
            plot_epoch_losses(epoch_losses, out_dir)
        return {"history": history, "epoch_losses": epoch_losses,
                "examples_per_sec": meter.rate(), "preempted": preempted}

    def _start_profile(self) -> "torch.profiler.profile":
        """A running torch.profiler over the CPU and, on a card, CUDA."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> str:
        """Stop `profiler` once the device has finished the traced steps
        and write its Chrome trace into train.profile_dir; returns the
        path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        directory = self.cfg.train.profile_dir
        os.makedirs(directory, exist_ok=True)
        rank = (f".rank{dist.get_rank()}"
                if self.mesh is not None and dist.is_initialized() else "")
        path = os.path.join(directory, f"train_trace{rank}.json")
        profiler.export_chrome_trace(path)
        return path

    def _agree(self, *flags: bool) -> List[bool]:
        """Each flag, true on every rank where it is true on any."""
        t = torch.tensor([int(f) for f in flags], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return [bool(v) for v in t.tolist()]

    def _resume_extra(self, epoch: int, opt_step_in_epoch: int) -> Dict:
        return {"epoch": epoch, "opt_step_in_epoch": opt_step_in_epoch,
                "host_step": self.host_step}


def train_from_config(cfg: Config, device="cuda") -> Dict[str, Any]:
    """CLI entry: shards -> loader -> Trainer.fit with resume.  In a
    torch.distributed process group the Trainer trains on the mesh of
    cfg.train.mesh, and data rank r of dp reads the loader of host r of dp
    at train.batch_size / dp samples (and chunk_budget / dp rows)."""
    from ..data.io import fs_glob
    shards = fs_glob(cfg.data.train_pattern)
    if not shards:
        raise FileNotFoundError(
            f"no shards match {cfg.data.train_pattern!r}")
    eval_shards = None
    if cfg.train.eval_every and cfg.data.valid_pattern:
        eval_shards = fs_glob(cfg.data.valid_pattern)
        if not eval_shards:
            # fail at startup, not eval_every optimizer steps into the run
            raise FileNotFoundError(
                f"train.eval_every is set but no shards match "
                f"data.valid_pattern={cfg.data.valid_pattern!r}")
    check_not_orbax(cfg.train.checkpoint_dir)
    packer = packer_from_config(cfg)
    mesh = make_mesh(cfg.train.mesh) if dist.is_initialized() else None
    trainer = Trainer(cfg, device=device, mesh=mesh)
    dp, data_rank = (mesh.data.size, mesh.data.rank) if mesh else (1, 0)
    budget = cfg.model.packer.chunk_budget
    eval_fn = None
    if eval_shards:
        from ..eval.evaluate import evaluate
        from .step import make_eval_step
        eval_step = make_eval_step(cfg, trainer.model)

        def eval_fn(t: Trainer) -> Dict:
            return evaluate(cfg, t.model, eval_shards, packer=packer,
                            eval_step=eval_step,
                            max_batches=cfg.train.eval_max_batches or None)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir)
    start_epoch, start_opt_step = 0, 0
    if cfg.train.resume:
        extra = ckpt.restore(trainer)
        if extra is not None:
            start_epoch = int(extra.get("epoch", 0))
            start_opt_step = int(extra.get("opt_step_in_epoch", 0))
            trainer.host_step = int(extra.get("host_step", 0))
            if trainer.is_chief:
                print(f"[resume] restored step={trainer.step} "
                      f"epoch={start_epoch} opt_step={start_opt_step} "
                      f"host_step={trainer.host_step}", flush=True)
    loader = make_train_loader(
        shards, cfg.train.batch_size // dp, packer,
        host_index=data_rank, host_count=dp,
        shuffle_buffer=cfg.data.shuffle_buffer, seed=cfg.train.seed,
        chunk_budget=budget // dp if budget else budget,
        num_prefetch=cfg.data.num_prefetch,
        num_threads=cfg.data.num_tokenizer_threads,
        shard_shuffle=cfg.data.shard_shuffle,
        on_shard_error=cfg.data.on_shard_error,
        skip_batches=trainer.host_step * cfg.train.optim.grad_accum)
    try:
        with PreemptionGuard() as guard:
            result = trainer.fit(iter(loader), ckpt=ckpt,
                                 start_epoch=start_epoch,
                                 start_opt_step=start_opt_step,
                                 preempt=guard, eval_fn=eval_fn)
        if result["preempted"] and trainer.is_chief:
            print(f"[preempt] SIGTERM: checkpointed at host_step="
                  f"{trainer.host_step}; rerun with --train.resume=true "
                  f"to continue bit-identically", flush=True)
        return result
    finally:
        loader.close()
