"""Trainer: builds the model and optimizer, runs optimizer steps, and
drives the epoch loop with logging, checkpointing and resume.

Port of mmoe_multimodal_rec_tpu/train/loop.py, on one device:
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
  eval_auc_good, eval_auc_best and eval_n.
Not ported yet: the loss-curve PNGs (utils/plotting.py), train.profile,
multi-GPU.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from ..config import Config
from ..data.loader import device_prefetch, make_train_loader
from ..data.packer import packer_from_config
from ..models.layers import init_weights
from ..models.mmoe import DTYPES, MMoERecModel
from ..utils.convert import load_jax_params
from ..utils.metrics import MetricsLogger, Throughput
from .checkpoint import CheckpointManager
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
                 batch_stats: Optional[Mapping[str, np.ndarray]] = None):
        """params: the JAX param tree flattened with '/'-joined keys (numpy,
        LoRA unmerged), and batch_stats its HoME BatchNorm statistics
        flattened the same way; None initialises from train.seed."""
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
        self.model.to(device=self.device,
                      dtype=DTYPES[cfg.model.param_dtype])
        self.trainable, self.frozen = split_trainable(self.model, variant)
        self.optimizer, self.scheduler = make_optimizer(
            cfg.train.optim, variant, self.trainable)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          self.scheduler)
        # optimizer steps are counted by the schedule; host_step also
        # counts skipped steps and keys the dropout and data streams
        self.host_step = 0

    @property
    def step(self) -> int:
        """Optimizer steps taken (skipped steps excluded)."""
        return self.scheduler.last_epoch

    def to_device(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.ascontiguousarray(v)
                                   if isinstance(v, np.ndarray) else v
                                   ).to(self.device)
                for k, v in batch.items() if k != "valid"}

    def run_step(self, stacked_batch) -> Dict[str, float]:
        """One optimizer step over stacked micro-batches [accum, ...]
        (numpy arrays or tensors; tensors already on the device stay put)."""
        stacked_batch = self.to_device(stacked_batch)
        accum = self.cfg.train.optim.grad_accum
        rngs = [dropout_generator(self.cfg.train.seed + 1, self.host_step, i)
                for i in range(accum)]
        self.host_step += 1
        return self.train_step(stacked_batch, rngs)

    # -- checkpoint state ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"trainable": {k: p.detach().cpu()
                              for k, p in self.trainable.items()},
                "batch_stats": {k: b.detach().cpu()
                                for k, b in self.model.named_buffers()},
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, payload: Mapping[str, Any],
                        frozen: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> None:
        """Strict: every trainable tensor and BatchNorm statistic (and,
        when given, frozen tensor) must be in the checkpoint with its
        shape."""
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
                    p.copy_(saved[k])
        self.optimizer.load_state_dict(payload["optimizer"])
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
        if cfg.train.profile:
            raise NotImplementedError("train.profile is not yet ported")
        epochs = epochs if epochs is not None else cfg.train.epochs
        accum = cfg.train.optim.grad_accum
        micro_steps = steps_per_epoch if steps_per_epoch is not None else (
            cfg.train.home_steps_per_epoch if cfg.model.variant == "home"
            else cfg.train.steps_per_epoch)
        opt_steps = micro_steps // accum
        logger = logger or MetricsLogger(
            os.path.join(cfg.train.output_dir, "metrics.jsonl"))
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
        for epoch in range(start_epoch, epochs):
            ep_main = ep_cl = 0.0
            ep_n = 0
            first = start_opt_step if epoch == start_epoch else 0
            for opt_step in range(first, opt_steps):
                if preempt is not None and preempt.requested:
                    # SIGTERM: save at the exact resume position (unless a
                    # periodic save already sits at this host_step) and stop
                    if ckpt is not None and \
                            ckpt.latest_step() != self.host_step:
                        ckpt.save(self.host_step, self,
                                  extra=self._resume_extra(epoch, opt_step))
                    preempted = True
                    break
                try:
                    batch = next(staged)
                except StopIteration:
                    exhausted = True
                    break
                m = self.run_step(batch)
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
        return {"history": history, "epoch_losses": epoch_losses,
                "examples_per_sec": meter.rate(), "preempted": preempted}

    def _resume_extra(self, epoch: int, opt_step_in_epoch: int) -> Dict:
        return {"epoch": epoch, "opt_step_in_epoch": opt_step_in_epoch,
                "host_step": self.host_step}


def train_from_config(cfg: Config, device="cuda") -> Dict[str, Any]:
    """CLI entry: shards -> loader -> Trainer.fit with resume."""
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
    packer = packer_from_config(cfg)
    trainer = Trainer(cfg, device=device)
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
            print(f"[resume] restored step={trainer.step} "
                  f"epoch={start_epoch} opt_step={start_opt_step} "
                  f"host_step={trainer.host_step}", flush=True)
    loader = make_train_loader(
        shards, cfg.train.batch_size, packer,
        shuffle_buffer=cfg.data.shuffle_buffer, seed=cfg.train.seed,
        chunk_budget=cfg.model.packer.chunk_budget,
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
        if result["preempted"]:
            print(f"[preempt] SIGTERM: checkpointed at host_step="
                  f"{trainer.host_step}; rerun with --train.resume=true "
                  f"to continue bit-identically", flush=True)
        return result
    finally:
        loader.close()
