"""The port's data and tensor parallelism (mmoe_multimodal_rec_tpu_torch/
parallel/mesh.py) on the CPU, in gloo process groups.

The mesh path must compute the one-process step on the same global batch.
Groups of 4 processes (tests/torch_mesh_child.py, which imports the port
only; inputs reach it through an .npz) run dp=4 and dp=2 x mp=2 steps of
the baseline and HoME at dropout 0.1, and this process runs the same steps
on one process.  Tolerances: losses and grad norm within 1e-5 relative
(the same sums split over ranks), parameters, AdamW state and BatchNorm
statistics within 1e-6 (AdamW at eps 1 and lr 0.1, as in
tests/test_torch_train.py: its first update is then nearly linear in the
gradient, where the default eps would blow the rounding noise of a
gradient that is zero in exact arithmetic up to lr), and every dropout
keep mask, reassembled from the ranks' shards, bit for bit.  Against JAX:
the parameter placement of `param_shardings`, and a 2 x 2 step at every
rate 0 against JAX's Trainer on a 2 x 2 mesh with the tolerances of
tests/test_mesh.py."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from mmoe_multimodal_rec_tpu.config import tiny_config as jtiny_config
from mmoe_multimodal_rec_tpu.models.mmoe import MMoERecModel as JModel
from mmoe_multimodal_rec_tpu.parallel import mesh as jmesh
from mmoe_multimodal_rec_tpu_torch.config import Config, MeshConfig, tiny_config
from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel
from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as tfa
from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as tld
from mmoe_multimodal_rec_tpu_torch.parallel.mesh import (make_mesh,
                                                         param_shardings)
from mmoe_multimodal_rec_tpu_torch.train.checkpoint import CheckpointManager
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
from mmoe_multimodal_rec_tpu_torch.utils.convert import params_from_jax
from util import stacked_batch, tiny_cli_flags

import torch_mesh_child as child

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CHILD = Path(__file__).resolve().parent / "torch_mesh_child.py"


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# (a) the mesh, (b) parameter placement against JAX
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_errors():
    """As tests/test_mesh.py::test_make_mesh_shapes: model innermost, all
    ranks on data by default, dp*mp above the ranks refused; and a model
    axis that does not split the heads or widths is refused too."""
    mesh = make_mesh(MeshConfig(data_parallel=4, model_parallel=2),
                     world_size=8)
    assert mesh.shape == (4, 2)
    assert mesh.axis_names == ("data", "model")
    assert make_mesh(MeshConfig(), world_size=8).shape == (8, 1)
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data_parallel=5, model_parallel=2), world_size=8)
    model = MMoERecModel(tiny_config().model)
    with pytest.raises(ValueError, match="model_parallel=3"):
        param_shardings(model, make_mesh(MeshConfig(
            data_parallel=1, model_parallel=3), world_size=3))
    assert set(param_shardings(model, make_mesh(MeshConfig(
        data_parallel=8), world_size=8)).values()) == {None}


def _jax_shapes(cfg):
    micro = {k: v[0] for k, v in stacked_batch(cfg, seed=0).items()}
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            micro)["params"]
    return traverse_util.flatten_dict(shapes)


@pytest.mark.parametrize("variant,shared", [("baseline", False),
                                             ("home", False),
                                             ("baseline", True)])
def test_param_shardings_match_jax(variant, shared):
    """Every parameter of the tiny tree (shared base: side-stacked LoRA
    factors) is split on the dimension JAX's param_shardings puts `model`
    on, on a 4 x 2 mesh, or on none."""
    cfg = jtiny_config(variant, data_parallel=4, model_parallel=2)
    cfg.model.shared_text_base = shared
    shapes = _jax_shapes(cfg)
    jax_tree = traverse_util.unflatten_dict(
        {k: np.zeros(v.shape, np.float32) for k, v in shapes.items()})
    specs = traverse_util.flatten_dict(jmesh.param_shardings(
        jax_tree, jmesh.make_mesh(cfg.train.mesh)))
    port_cfg = Config.from_dict(cfg.to_dict())
    got = param_shardings(MMoERecModel(port_cfg.model),
                          make_mesh(port_cfg.train.mesh, world_size=8))
    assert len(got) == len(specs)
    split = 0
    for key, sharding in specs.items():
        spec = tuple(sharding.spec)
        want = spec.index("model") if "model" in spec else None
        (name, _), = params_from_jax({"/".join(key): np.zeros(
            shapes[key].shape, np.float32)}, None, merge_lora=False).items()
        dim = got[name]
        if dim is not None and key[-1] == "kernel":
            dim = len(shapes[key].shape) - 1 - dim
        assert dim == want, (key, dim, want)
        split += want is not None
    assert split > 0


# ---------------------------------------------------------------------------
# (c) a shard's hash equals a slice of the whole one
# ---------------------------------------------------------------------------

SEED = 2**31 - 7   # its folds pass 2^31


def test_row_shard_hash_and_lora_dropout_are_slices():
    """Rows r*R/dp.. of a [R, D] array: the keep mask on the seed folded by
    the shard's flat offset, and the LoRA dropout's plain forward and dh,
    equal those rows of the whole call."""
    rng = np.random.default_rng(0)
    r_all, d, r = 64, 48, 4
    h = torch.tensor(rng.normal(size=(r_all, d)), dtype=torch.float32)
    a = torch.tensor(rng.normal(size=(d, r)), dtype=torch.float32)
    dt = torch.tensor(rng.normal(size=(r_all, r)), dtype=torch.float32)
    full = tld.hash_keep_mask((r_all, d), SEED, 0.1, "cpu")
    fwd = tld.lora_dropout_fwd_reference(h, a, SEED, 0.1)
    dh = tld.lora_dropout_dh_reference(dt, a, SEED, 0.1)
    for dp in (2, 4):
        n = r_all // dp
        for k in range(dp):
            rows = slice(k * n, (k + 1) * n)
            seed = tld.fold_seed(SEED, k * n * d)
            assert torch.equal(tld.hash_keep_mask((n, d), seed, 0.1, "cpu"),
                               full[rows])
            assert torch.equal(tld.lora_dropout_fwd_reference(
                h[rows], a, seed, 0.1), fwd[rows])
            assert torch.equal(tld.lora_dropout_dh_reference(
                dt[rows], a, seed, 0.1), dh[rows])


def test_column_shard_hash_is_a_slice():
    """Columns c0.. of rows `width` wide, on a data shard's rows too: the
    strided hash equals that block of the whole mask."""
    rows, width = 12, 40
    full = tld.hash_keep_mask((rows, width), SEED, 0.3, "cpu")
    for dp, mp in ((1, 2), (2, 2), (3, 4)):
        n, w = rows // dp, width // mp
        for k in range(dp):
            for m in range(mp):
                got = tld.hash_keep_mask(
                    (n, w), tld.fold_seed(SEED, k * n * width), 0.3, "cpu",
                    width=width, col0=m * w)
                assert torch.equal(got, full[k * n:(k + 1) * n,
                                             m * w:(m + 1) * w])


def test_head_shard_attention_is_a_slice():
    """Heads h0.. of h_total on a data shard's batch rows: #8's plain mask,
    and #2/#3's plain forward and backward (the seed folded by the batch
    offset), equal those heads and rows of the whole call."""
    rng = np.random.default_rng(1)
    b, l, heads, dh, rate = 4, 128, 4, 8, 0.2
    x = [torch.tensor(rng.normal(size=(b, l, heads * dh)),
                      dtype=torch.float32) for _ in range(4)]
    q, k, v, g = x
    pad = torch.zeros(b, l, dtype=torch.bool)
    pad[1, -9:] = True
    out = tfa.flash_attention_reference(q, k, v, pad, SEED, heads, rate)
    grads = tfa.flash_attention_bwd_reference(q, k, v, pad, SEED, g, heads,
                                              rate)
    mask = tfa.dropout_keep_mask_reference(SEED, b, 8, 64, 64, rate,
                                           device="cpu")
    for dp, mp in ((2, 2), (1, 4)):
        nb, nh = b // dp, heads // mp
        for r in range(dp):
            for m in range(mp):
                rows = slice(r * nb, (r + 1) * nb)
                cols = slice(m * nh * dh, (m + 1) * nh * dh)
                seed = tld.fold_seed(SEED, r * nb * heads * l * l)
                sl = [t[rows, :, cols] for t in x]
                got = tfa.flash_attention_reference(
                    *sl[:3], pad[rows], seed, nh, rate, heads, m * nh)
                np.testing.assert_allclose(got, out[rows, :, cols],
                                           atol=1e-6)
                got = tfa.flash_attention_bwd_reference(
                    *sl[:3], pad[rows], seed, sl[3], nh, rate, heads, m * nh)
                for gg, want in zip(got, grads):
                    np.testing.assert_allclose(gg, want[rows, :, cols],
                                               atol=1e-5)
        for r in range(dp):
            nb8, nh8 = 4 // dp * 1, 8 // mp
            for m in range(mp):
                got = tfa.dropout_keep_mask(
                    tld.fold_seed(SEED, r * nb8 * 8 * 64 * 128), nb8, nh8,
                    64, 64, rate, device="cpu", h_total=8, h0=m * nh8)
                assert torch.equal(got, mask[r * nb8:(r + 1) * nb8,
                                             m * nh8:(m + 1) * nh8])


# ---------------------------------------------------------------------------
# (d)-(f) gloo process groups against one process and JAX
# ---------------------------------------------------------------------------

# the training options each mesh also runs, beside the default baseline
# and HoME: the top-k gate and remat attn on dp=4; the shared text base and
# remat full on 2 x 2.  (The quantised saves round each row's values to
# int8, which turns the last-bit differences of a shard's products into a
# step of the int8 grid now and then: 1e-5 apart in grad norm at dp=4.)
OPTIONS = {4: ("home", dict(gate_type="topk", remat=True,
                            remat_policy="attn")),
           2: ("baseline", dict(shared_text_base=True, remat=True,
                                remat_policy="full"))}


def _train_cfg(variant, dp, mp, rate=0.1):
    options = {}
    if variant == "options":
        variant, options = OPTIONS[dp]
    cfg = tiny_config(variant, batch_size=8, accum=2, data_parallel=dp,
                      model_parallel=mp)
    for k, v in options.items():
        setattr(cfg.model, k, v)
    m, t = cfg.model, cfg.model.text
    m.dropout = m.tower_dropout = rate
    m.home_expert_dropout = m.home_tower_dropout = rate
    t.hidden_dropout = t.attention_dropout = t.lora_dropout = rate
    o = cfg.train.optim
    # LoRA and HoME's img_ft group at the full lr from the first update;
    # eps 1 keeps the parameters linear in the gradients (module docstring)
    o.freeze_steps, o.unfreeze_steps, o.lr, o.eps = -1, 1, 0.1, 1.0
    o.home_freeze_steps, o.home_unfreeze_steps = -1, 1
    return cfg


BATCHES = ("b0", "b1")


def _cross_rank_sentences(batch, dp):
    """How many sentences sit in chunk rows of another data rank than
    their sample's."""
    n = batch["user_tokens"].shape[1]
    b = batch["user_sent_chunk"].shape[1]
    count = 0
    for side in ("user", "item"):
        chunk = batch[f"{side}_sent_chunk"]
        owner = (np.arange(b) // (b // dp))[None, :, None]
        count += int(((chunk >= 0) & (chunk // (n // dp) != owner)).sum())
    return count


def _start(tmp, world, jobs, arrays):
    """Start `jobs` in a gloo group of `world` child processes."""
    np.savez(tmp / "in.npz", **arrays)
    spec = {"npz": str(tmp / "in.npz"), "out": str(tmp), "jobs": jobs}
    (tmp / "spec.json").write_text(json.dumps(spec))
    return tmp, [subprocess.Popen(
        [sys.executable, str(CHILD), str(r), str(world), str(tmp / "init"),
         str(tmp / "spec.json")], env=_env(), stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def _finish(started):
    """Wait for a group; its outputs by rank."""
    tmp, procs = started
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=240)[1])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    return [np.load(tmp / f"rank{r}.npz") for r in range(len(procs))]


def _one_process(cfg, batches, params=None, stats=None):
    """The port's one-process Trainer over `batches`: (metrics, masks,
    flat state)."""
    log = child.MaskLog()
    try:
        trainer = Trainer(Config.from_dict(cfg.to_dict()), device="cpu",
                          params=params, batch_stats=stats)
        metrics = [trainer.run_step(b) for b in batches]
    finally:
        log.close()
    return metrics, log.masks, child.flat_state(trainer.state_dict())


def _assemble(full: np.ndarray, shards, mp: int) -> bool:
    """Whether the ranks' masks tile `full`: a dimension the shard has
    shorter is split over data (dim 0) or model (any other); ranks that
    hold one block must hold the same bits."""
    got = np.zeros_like(full)
    seen = np.zeros(full.shape, bool)
    for r, shard in enumerate(shards):
        d, m = divmod(r, mp)
        idx = tuple(slice(None) if f == s else
                    slice(k * s, (k + 1) * s)
                    for f, s, k in zip(full.shape, shard.shape,
                                       [d] + [m] * (full.ndim - 1)))
        if seen[idx].any() and not np.array_equal(got[idx], shard):
            return False
        got[idx], seen[idx] = shard, True
    return bool(seen.all() and np.array_equal(got, full))


def _group(tmp, dp, mp, extra_jobs=(), extra=None):
    """Start the baseline, HoME and OPTIONS steps (and `extra_jobs`) on
    dp x mp; (started group, {variant: (job index, cfg, batches)})."""
    arrays, jobs, cases = dict(extra or {}), [], {}
    for variant in ("baseline", "home", "options"):
        cfg = _train_cfg(variant, dp, mp)
        batches = [stacked_batch(cfg, seed=s) for s in range(len(BATCHES))]
        for name, b in zip(BATCHES, batches):
            arrays.update({f"{variant}{name}/{k}": v for k, v in b.items()})
        cases[variant] = (len(jobs), cfg, batches)
        jobs.append({"config": cfg.to_dict(),
                     "batches": [variant + b for b in BATCHES]})
    return _start(tmp, dp * mp, jobs + list(extra_jobs), arrays), cases


def _jax_params(cfg, seed):
    """Flat '/'-keyed numpy params for the JAX tree of `cfg`."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in _jax_shapes(cfg).items():
        std = leaf.shape[-2] ** -0.5 if key[-1] == "kernel" else 0.1
        v = rng.normal(0, std, leaf.shape)
        out["/".join(key)] = (1.0 + v if key[-1] == "scale" else v).astype(
            np.float32)
    return out


def _jax_trainer_step(cfg, flat, batch):
    """One step of JAX's Trainer on the mesh of `cfg` from `flat`."""
    from mmoe_multimodal_rec_tpu.train.loop import Trainer as JTrainer
    trainer = JTrainer(cfg)
    st = trainer.state

    def put(part):
        nested = part and not isinstance(next(iter(part)), tuple)
        leaves = traverse_util.flatten_dict(part) if nested else part
        leaves = {k: jax.device_put(flat["/".join(k)], v.sharding)
                  for k, v in leaves.items()}
        return traverse_util.unflatten_dict(leaves) if nested else leaves
    trainer.state = st.replace(trainable=put(st.trainable),
                               frozen=put(st.frozen))
    return {k: float(v) for k, v in trainer.run_step(batch).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo groups, started together: dp=4 and dp=2 x mp=2, each with
    the baseline and HoME steps; the 2 x 2 one also steps from given
    params at every rate 0 (held to JAX's Trainer, run here meanwhile) and
    restores a one-process checkpoint, steps and saves again."""
    ck = tmp_path_factory.mktemp("ckpt")
    jcfg = jtiny_config("baseline", batch_size=4, data_parallel=2,
                        model_parallel=2)
    m, t = jcfg.model, jcfg.model.text
    m.dropout = m.tower_dropout = 0.0
    t.hidden_dropout = t.attention_dropout = t.lora_dropout = 0.0
    jflat, jbatch = _jax_params(jcfg, 11), stacked_batch(jcfg, seed=3)
    arrays = {f"jaxp/{k}": v for k, v in jflat.items()}
    arrays.update({f"jaxb/{k}": v for k, v in jbatch.items()})
    ck_cfg = _train_cfg("baseline", 2, 2)
    ck_batches = [stacked_batch(ck_cfg, seed=s) for s in (5, 6)]
    arrays.update({f"ck/{k}": v for k, v in ck_batches[1].items()})
    one = Trainer(Config.from_dict(ck_cfg.to_dict()), device="cpu")
    one.run_step(ck_batches[0])
    CheckpointManager(str(ck / "one")).save(
        one.host_step, one, extra={"host_step": one.host_step})
    extra_jobs = [{"config": Config.from_dict(jcfg.to_dict()).to_dict(),
                   "params": "jaxp", "batches": ["jaxb"]},
                  {"config": ck_cfg.to_dict(), "restore": str(ck / "one"),
                   "batches": ["ck"], "save": str(ck / "mesh")}]
    dp4, dp4_cases = _group(tmp_path_factory.mktemp("dp4"), 4, 1)
    tp, tp_cases = _group(tmp_path_factory.mktemp("tp"), 2, 2, extra_jobs,
                          arrays)
    jwant = _jax_trainer_step(jcfg, jflat, jbatch)
    return {"dp4": (_finish(dp4), dp4_cases),
            "tp": (_finish(tp), tp_cases,
                   {"first": len(tp_cases), "jax": jwant,
                    "one_state": child.flat_state(one.state_dict()),
                    "ckpt_cfg": ck_cfg, "mesh_dir": ck / "mesh"})}


@pytest.mark.parametrize("mesh", ["dp4", "tp"])
@pytest.mark.parametrize("variant", ["baseline", "home", "options"])
def test_mesh_step_matches_one_process(runs, mesh, variant):
    """Two steps (accum 2, dropout 0.1) on dp=4 or dp=2 x mp=2 against the
    port's one-process Trainer on the same global batches, some of whose
    sentences sit in another rank's chunk rows; "options" adds OPTIONS."""
    outs, cases = runs[mesh][:2]
    mp = 2 if mesh == "tp" else 1
    j, cfg, batches = cases[variant]
    assert _cross_rank_sentences(batches[0], 4 // mp) > 0
    metrics, masks, state = _one_process(cfg, batches)
    got = json.loads(str(outs[0][f"{j}/metrics"]))
    for r in range(1, len(outs)):
        assert json.loads(str(outs[r][f"{j}/metrics"])) == got
    for want, have in zip(metrics, got):
        assert have["skipped_micro"] == want["skipped_micro"] == 0
        for k in ("loss", "main_loss", "contrastive_loss", "grad_norm"):
            np.testing.assert_allclose(have[k], want[k], rtol=1e-5, err_msg=k)
    assert (got[0]["contrastive_loss"] > 0) == (cfg.model.variant == "home")
    assert {k for k in state if k.startswith("batch_stats/")} == \
        {k[len(f"{j}/state/"):] for k in outs[0].files
         if k.startswith(f"{j}/state/batch_stats/")}
    for k, v in state.items():
        np.testing.assert_allclose(outs[0][f"{j}/state/{k}"], v, atol=1e-6,
                                   err_msg=k)
    assert len(masks) > 100
    for i, full in enumerate(masks):
        shards = [o[f"{j}/mask/{i}"] for o in outs]
        assert _assemble(full.numpy(), shards, mp), (i, full.shape)


def test_tp_step_matches_jax_trainer(runs):
    """The port's 2 x 2 step against JAX's Trainer on a 2 x 2 mesh from the
    same params, every rate 0 (tests/test_mesh.py's tolerances)."""
    outs, _, info = runs["tp"]
    got = json.loads(str(outs[0][f"{info['first']}/metrics"]))[0]
    want = info["jax"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-4)


def test_checkpoint_moves_between_mesh_and_one_process(runs):
    """A one-process checkpoint restored on 2 x 2 gathers back to the same
    state, and the 2 x 2 checkpoint written after a step restores in one
    process to the mesh's gathered state, bit for bit (parameters, AdamW
    moments and counts)."""
    outs, _, info = runs["tp"]
    j = info["first"] + 1
    restored = {k[len(f"{j}/restored/"):]: outs[0][k] for k in outs[0].files
                if k.startswith(f"{j}/restored/")}
    assert restored.keys() == info["one_state"].keys()
    for k, v in info["one_state"].items():
        assert np.array_equal(restored[k], v), k
    one = Trainer(Config.from_dict(info["ckpt_cfg"].to_dict()), device="cpu")
    extra = CheckpointManager(str(info["mesh_dir"])).restore(one)
    assert extra == {"host_step": 2} and one.step == 2
    mesh_state = {k[len(f"{j}/state/"):]: outs[0][k] for k in outs[0].files
                  if k.startswith(f"{j}/state/")}
    state = child.flat_state(one.state_dict())
    assert state.keys() == mesh_state.keys()
    for k, v in state.items():
        assert np.array_equal(mesh_state[k], v), k


# ---------------------------------------------------------------------------
# (g) the CLI under torchrun
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_multihost_cli_under_torchrun(tmp_path, capsys):
    """`train --multihost --device=cpu` in two processes of
    torch.distributed.run on synth shards: two optimizer steps, one result
    line (rank 0), metrics from rank 0 only, a checkpoint; its
    `train.eval_every` AUCs after the last step are the one-process `eval`
    of that checkpoint."""
    env = _env()
    synth = subprocess.run(
        [sys.executable, "-m", "mmoe_multimodal_rec_tpu_torch", "synth",
         f"--output={tmp_path / 'shards'}", "--samples=48",
         "--samples-per-shard=16"], env=env, capture_output=True, text=True,
        timeout=120)
    assert synth.returncode == 0, synth.stderr
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
           "--nproc_per_node=2", "--master_addr=127.0.0.1",
           f"--master_port={_free_port()}", "-m",
           "mmoe_multimodal_rec_tpu_torch", "train", "--multihost",
           "--device=cpu", *tiny_cli_flags(),
           "--train.mesh.data_parallel=2",
           f"--data.train_pattern={tmp_path / 'shards'}/*.tar.gz",
           f"--train.checkpoint_dir={tmp_path / 'ckpt'}",
           f"--train.output_dir={tmp_path / 'out'}", "--train.epochs=1",
           "--train.steps_per_epoch=4", "--train.optim.grad_accum=2",
           "--train.log_every=1", "--train.eval_every=1",
           f"--data.valid_pattern={tmp_path / 'shards'}/*.tar.gz"]
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=180)
    assert run.returncode == 0, run.stderr[-4000:]
    results = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"examples_per_sec"')]
    assert len(results) == 1
    assert all(np.isfinite(results[0]["epoch_losses"]))
    logged = [json.loads(line) for line in
              (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in logged if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["skipped_micro"] == 0 and 1.0 < r["loss"] < 2.0
               for r in steps)
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    evals = [r for r in logged if "eval_auc_good" in r]
    assert [r["step"] for r in evals] == [1, 2]
    capsys.readouterr()
    from mmoe_multimodal_rec_tpu_torch import cli
    assert cli.main(["eval", "--device=cpu", *tiny_cli_flags(),
                     f"--checkpoint={tmp_path / 'ckpt'}",
                     f"--data.valid_pattern={tmp_path / 'shards'}/*.tar.gz",
                     f"--train.output_dir={tmp_path / 'eval'}"]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["n"] == evals[-1]["eval_n"] == 48
    np.testing.assert_allclose([evals[-1]["eval_auc_good"],
                                evals[-1]["eval_auc_best"]],
                               [one["auc_good"], one["auc_best"]],
                               atol=1e-6)
