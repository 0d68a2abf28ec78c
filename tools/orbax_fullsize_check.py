"""Full-width run of tools/orbax_to_torch.py, with its cost.

    python tools/orbax_fullsize_check.py --variant=baseline|home

Builds a JAX-trainer checkpoint at bench.py --mode train's model (BERT-base
x2 with LoRA r=8 on query/value, ViT-base, the cross and fuse experts,
fp32 params; baseline or HoME) without tracing the model: the port's seeded
init weights in the JAX param layout (the inverse of
utils/convert.params_from_jax, whose key set is first checked against the
JAX model's own tree at the tiny widths), the JAX package's optimizer
(train/optimizer.make_optimizer) initialised on the trainable tree, its
AdamW moments then filled with seeded values so that the check covers
them, saved as step 0 by the JAX package's CheckpointManager.  Then it
converts the directory and checks that the port's
CheckpointManager.restore_model and a Trainer's restore give every
parameter, BatchNorm statistic and AdamW moment back bit for bit.

Prints one JSON line: the seconds of each stage, the process's peak RSS
(one variant a process, so the peak is that variant's) and the sizes of
the orbax directory and of the port's files.  Not a test: it takes
minutes and a few GB of host memory.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def jax_layout(model):
    """{JAX '/'-joined key: numpy array in JAX's layout} of the port
    model's parameters, and its buffers as the JAX batch_stats keys."""
    from mmoe_multimodal_rec_tpu_torch.models.layers import (
        BatchNorm1D, Dense, Embed, LayerNorm)
    params = {}
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        value = p.detach().numpy()
        if leaf == "weight" and isinstance(mod, Dense):
            leaf, value = "kernel", value.T
        elif leaf == "weight" and isinstance(mod, (LayerNorm, BatchNorm1D)):
            leaf = "scale"
        elif leaf == "weight" and isinstance(mod, Embed):
            leaf = "embedding"
        params["/".join(owner.split(".") + [leaf])] = value
    stats = {k.replace(".", "/"): b.numpy() for k, b in model.named_buffers()}
    return params, stats


def check_keys_at_tiny_widths(variant: str) -> None:
    """jax_layout's keys are the JAX model's own, at the tiny widths."""
    import jax
    from flax import traverse_util

    from mmoe_multimodal_rec_tpu.config import tiny_config
    from mmoe_multimodal_rec_tpu.models.mmoe import MMoERecModel as JModel
    from mmoe_multimodal_rec_tpu.train.loop import dummy_batch
    from mmoe_multimodal_rec_tpu_torch.config import Config
    from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel
    cfg = tiny_config(variant)
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            dummy_batch(cfg))
    want = {"/".join(k): v.shape for k, v in
            traverse_util.flatten_dict(shapes["params"]).items()}
    want_stats = {"/".join(k) for k in
                  traverse_util.flatten_dict(shapes.get("batch_stats",
                                                        {}))}
    params, stats = jax_layout(MMoERecModel(
        Config.from_dict(cfg.to_dict()).model))
    got = {k: v.shape for k, v in params.items()}
    if got != want or set(stats) != want_stats:
        raise AssertionError(f"jax_layout differs from the JAX tree: "
                             f"{sorted(set(got) ^ set(want))[:8]}")


def build_orbax(cfg, directory: str):
    """The port's seeded init weights saved as step 0 of a JAX checkpoint
    directory; returns the source model and the JAX-layout moments."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from flax import traverse_util

    from mmoe_multimodal_rec_tpu.train.checkpoint import CheckpointManager
    from mmoe_multimodal_rec_tpu.train.optimizer import (label_param,
                                                         make_optimizer,
                                                         split_trainable)
    from mmoe_multimodal_rec_tpu.train.step import TrainState
    from mmoe_multimodal_rec_tpu_torch.models.layers import init_weights
    from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel

    variant = cfg.model.variant
    model = MMoERecModel(cfg.model)
    init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
    params, stats = jax_layout(model)
    nested = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in params.items()})
    trainable, frozen = split_trainable(nested, variant)
    trainable = {k: jnp.asarray(v) for k, v in trainable.items()}
    labels = {k: label_param(k, variant) for k in trainable}
    opt_state = make_optimizer(cfg.train.optim, variant,
                               labels).init(trainable)
    rng = np.random.default_rng(0)

    def fill(tree, positive):
        return {k: v if not hasattr(v, "shape") else jnp.asarray(
            (np.abs if positive else np.asarray)(rng.normal(
                size=v.shape)).astype(np.float32))
                for k, v in tree.items()}
    adam = opt_state[1].inner_states
    inner = {label: s._replace(inner_state=(
        s.inner_state[0]._replace(mu=fill(s.inner_state[0].mu, False),
                                  nu=fill(s.inner_state[0].nu, True)),)
        + tuple(s.inner_state[1:])) for label, s in adam.items()}
    opt_state = (opt_state[0], opt_state[1]._replace(inner_states=inner))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), trainable=trainable, frozen=frozen,
        batch_stats=traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in stats.items()}),
        opt_state=opt_state)
    mngr = CheckpointManager(directory)
    mngr.save(0, state, extra={"epoch": 0, "opt_step_in_epoch": 0,
                               "host_step": 0}, wait=True)
    mngr.close()
    moments = {}
    for label, s in inner.items():
        for m, tree in (("exp_avg", s.inner_state[0].mu),
                        ("exp_avg_sq", s.inner_state[0].nu)):
            for k, v in tree.items():
                if hasattr(v, "shape"):
                    moments[m, "/".join(k)] = np.asarray(v)
    return model, moments


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=("baseline", "home"),
                    default="baseline")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    import orbax_to_torch
    from mmoe_multimodal_rec_tpu_torch.config import Config
    from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel
    from mmoe_multimodal_rec_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
    from mmoe_multimodal_rec_tpu_torch.utils.convert import params_from_jax

    check_keys_at_tiny_widths(args.variant)
    cfg = Config()                       # bench.py --mode train's model
    cfg.model.variant = args.variant
    cfg.train.batch_size, cfg.train.optim.grad_accum = 64, 2
    cfg.model.packer.chunk_budget = 128
    seconds = {}
    root = tempfile.mkdtemp(prefix="orbax_fullsize_")
    try:
        t0 = time.perf_counter()
        source, moments = build_orbax(cfg, os.path.join(root, "jax"))
        seconds["build_and_save_orbax"] = time.perf_counter() - t0
        want = {k: v.detach().clone() for k, v in
                source.state_dict().items()}
        del source
        t0 = time.perf_counter()
        out = orbax_to_torch.convert(os.path.join(root, "jax"),
                                     os.path.join(root, "port"), cfg)
        seconds["convert"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = MMoERecModel(cfg.model)
        step = CheckpointManager(os.path.join(root, "port")).restore_model(
            model)
        seconds["restore_model"] = time.perf_counter() - t0
        got = model.state_dict()
        assert step == 0 and got.keys() == want.keys()
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        assert not differ, differ[:5]
        del model, got
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device="cpu")
        extra = CheckpointManager(os.path.join(root, "port")).restore(
            trainer)
        seconds["trainer_restore"] = time.perf_counter() - t0
        assert extra == {"epoch": 0, "opt_step_in_epoch": 0, "host_step": 0}
        for group in (trainer.trainable, trainer.frozen,
                      dict(trainer.model.named_buffers())):
            for k, t in group.items():
                assert torch.equal(t.detach(), want[k]), k
        n_moments = 0
        for (m, key), value in moments.items():
            (name, t), = params_from_jax({key: value}, None,
                                         merge_lora=False).items()
            state = trainer.optimizer.state[trainer.trainable[name]]
            assert torch.equal(state[m], t) and float(state["step"]) == 0, \
                (m, name)
            n_moments += 1
        assert n_moments == 2 * len(trainer.trainable)
        port_files = {f: os.path.getsize(os.path.join(root, "port", f))
                      for f in sorted(os.listdir(os.path.join(root,
                                                              "port")))}
        print(json.dumps({
            "variant": args.variant, "bit_for_bit": True,
            "tensors": len(want), "moments": n_moments,
            "trainable": len(trainer.trainable),
            "frozen": len(trainer.frozen), "seconds": seconds,
            "convert_read_s": out["read_s"],
            "peak_rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2**20,
            "orbax_bytes": dir_bytes(os.path.join(root, "jax")),
            "port_bytes": port_files}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
