"""The quantised remat saves (models/layers.quantize under remat_policy
quant, quant4 and quant_fc1) under tensor parallelism, on the CPU in one
gloo group of 4 processes (dp=2 x mp=2, tests/torch_mesh_child.py).

q/k/v (qkv on the packed path) and the fc1 pre-activation are column
shards there, so `quantize` takes each row's max |x| over the model axis:
every shard divides by the whole row's scale, as JAX's max over a sharded
last axis does.  Held here:

- `quantize` of a rank's columns over a 2-rank model axis equals one
  process's `quantize` of the whole row: the int8 integers and every scale
  bit for bit, the int4 integers once unpacked (the packed bytes pair the
  halves of the rank's own columns, so their layout differs);
- two steps (accum 2, dropout 0.1) on 2 x 2 under each policy against the
  port's one-process step under the same policy.  A shard's products
  differ from one process's in their last bits (the row-parallel sums run
  in another order), which moves a value that sits at a tie of the int8
  (int4) grid by one step now and then, and a later layer's inputs then
  differ by more than rounding.  So the one-process run goes on with the
  mesh's saves, as tests/test_torch_remat.py::QuantTwin runs the port on
  JAX's (`MeshSaves`): at each save the two are held to each other, the
  scales within 1e-5 relative (each model rank's bit for bit the other's)
  and the integers equal or one step apart at a near tie
  (|x/scale - k - 1/2| < 1e-3 on either side).  The steps are then held
  with tests/test_torch_mesh.py's tolerances: 1e-5 relative on the losses
  and grad norm, 1e-6 on every parameter, AdamW moment and BatchNorm
  statistic (AdamW at eps 1 and lr 0.1: an update is nearly linear in the
  gradient);
- a 2 x 2 step under quant at every rate 0 against JAX's Trainer on a
  2 x 2 mesh, within tests/test_torch_mesh.py's tolerances for that
  comparison (loss 2e-5, grad norm 2e-4 relative);
- a ViTLayer at head dim 64 and 128 tokens, whose attention takes the
  packed qkv path (one [D, 3D] projection in pack_qkv_weights' column
  order, the rank's heads only), under quant: its output and gradients on
  2 x 2 against one process on the mesh's saves (the rank's qkv columns
  placed by that order): the output and the input's gradient within 1e-5
  of their largest value, the parameters' gradients within 1e-5 of the
  largest of them (the key bias's is zero in exact arithmetic)."""
import json

import numpy as np
import pytest
import torch

from mmoe_multimodal_rec_tpu_torch.config import Config, ImageEncoderConfig
from mmoe_multimodal_rec_tpu_torch.models import layers
from mmoe_multimodal_rec_tpu_torch.models.vit import ViTLayer
from util import stacked_batch

import torch_mesh_child as child
from test_torch_mesh import (_finish, _jax_params, _jax_trainer_step,
                             _one_process, _start, _train_cfg)
from mmoe_multimodal_rec_tpu.config import tiny_config as jtiny_config

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

STEPS = {"quant": ("baseline", "home"), "quant4": ("baseline",),
         "quant_fc1": ("baseline",)}
VIT = dict(hidden_size=128, num_layers=1, num_heads=2, intermediate_size=256,
           hidden_dropout=0.0, attention_dropout=0.0)
TIE = 1e-3


def _quant_cfg(variant, policy):
    cfg = _train_cfg(variant, 2, 2)
    cfg.model.remat, cfg.model.remat_policy = True, policy
    return cfg


def _vit_case():
    """A ViTLayer's state_dict, input [2, 128, 128] and output gradient."""
    rng = np.random.default_rng(5)
    layer = ViTLayer(ImageEncoderConfig(**VIT), torch.float32)
    params = {}
    for k, v in layer.state_dict().items():
        std = v.shape[-1] ** -0.5 if v.dim() == 2 else 0.1
        params[k] = (rng.normal(0, std, tuple(v.shape))
                     + (1.0 if k.endswith("norm1.weight")
                        or k.endswith("norm2.weight") else 0.0)
                     ).astype(np.float32)
    x = rng.normal(size=(2, 128, 128)).astype(np.float32)
    g = rng.normal(size=(2, 128, 128)).astype(np.float32)
    return params, x, g


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2 x 2 gloo group: the quantize job, the steps of STEPS (saves
    recorded), the rate-0 quant step from JAX-layout params, and the ViT
    layer; JAX's 2 x 2 Trainer runs here meanwhile."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 16)).astype(np.float32)
    # rows whose largest |x| sits in the other rank's columns
    x[:6, :8] *= 0.25
    x[6:, 8:] *= 0.25
    arrays = {"x": x}
    layout = _train_cfg("baseline", 2, 2).to_dict()
    jobs = [{"config": layout, "quantize": "x"}]
    cases = {}
    for policy, variants in STEPS.items():
        for variant in variants:
            cfg = _quant_cfg(variant, policy)
            batches = [stacked_batch(cfg, seed=s) for s in range(2)]
            for s, b in enumerate(batches):
                arrays.update({f"{policy}{variant}{s}/{k}": v
                               for k, v in b.items()})
            cases[policy, variant] = (len(jobs), cfg, batches)
            jobs.append({"config": cfg.to_dict(), "saves": True,
                         "batches": [f"{policy}{variant}{s}"
                                     for s in range(2)]})
    jcfg = jtiny_config("baseline", batch_size=4, data_parallel=2,
                        model_parallel=2)
    m, t = jcfg.model, jcfg.model.text
    m.dropout = m.tower_dropout = 0.0
    t.hidden_dropout = t.attention_dropout = t.lora_dropout = 0.0
    m.remat, m.remat_policy = True, "quant"
    jflat, jbatch = _jax_params(jcfg, 11), stacked_batch(jcfg, seed=3)
    arrays.update({f"jaxp/{k}": v for k, v in jflat.items()})
    arrays.update({f"jaxb/{k}": v for k, v in jbatch.items()})
    jax_job = len(jobs)
    jobs.append({"config": Config.from_dict(jcfg.to_dict()).to_dict(),
                 "params": "jaxp", "batches": ["jaxb"]})
    params, vx, vg = _vit_case()
    arrays.update({f"vit/{k}": v for k, v in params.items()})
    arrays.update({"vit/x": vx, "vit/g": vg})
    vit_job = len(jobs)
    jobs.append({"config": layout, "vit_layer": "vit", "image": VIT,
                 "policy": "quant"})
    started = _start(tmp_path_factory.mktemp("tp_quant"), 4, jobs, arrays)
    jwant = _jax_trainer_step(jcfg, jflat, jbatch)
    return {"outs": _finish(started), "x": x, "cases": cases,
            "jax": (jax_job, jwant), "vit": (vit_job, params, vx, vg)}


def test_quantize_over_the_model_axis_is_the_whole_rows(runs):
    """Each rank's int8 integers and scales are one process's quantize of
    the whole rows, sliced, bit for bit; its int4 integers, unpacked, too,
    while its packed bytes pair the halves of its own columns."""
    x = torch.from_numpy(runs["x"])
    local_max = x[:, :8].abs().amax(-1) < x.abs().amax(-1)
    assert local_max.any() and not local_max.all()
    for bits in (8, 4):
        q, sc = layers.quantize(x, bits)
        ints = child.unpack_int4(q) if bits == 4 else q
        for r, out in enumerate(runs["outs"]):
            cols = slice(r % 2 * 8, r % 2 * 8 + 8)
            assert np.array_equal(out[f"0/sc{bits}"], sc.numpy())
            got = torch.from_numpy(out[f"0/q{bits}"])
            if bits == 4:
                assert got.shape == (12, 4)
                assert not torch.equal(got, q[:, r % 2 * 4:r % 2 * 4 + 4])
                got = child.unpack_int4(got)
            assert torch.equal(got, ints[:, cols]), (bits, r)


def _pack_int4(ints: torch.Tensor) -> torch.Tensor:
    """One process's int4 layout: the column halves of the whole row."""
    n = ints.shape[-1]
    return (ints[..., :n // 2] & 0x0F) | (ints[..., n // 2:] << 4)


def _qkv_columns(d: int, heads: int, mp: int, m: int) -> np.ndarray:
    """Where the columns of model rank m's packed qkv save sit in one
    process's: pack_qkv_weights' group-interleaved order over the rank's
    heads, against that order over every head."""
    from mmoe_multimodal_rec_tpu_torch.ops.flash_attention import (
        _head_group, pack_qkv_weights)
    tags = [torch.arange(d) + i * d for i in range(3)]
    dh = d // heads
    full = pack_qkv_weights(*tags, heads, _head_group(dh, heads, 6))
    w = d // mp
    local = pack_qkv_weights(*(t[m * w:(m + 1) * w] for t in tags),
                             heads // mp, _head_group(dh, heads // mp, 6))
    where = {int(t): i for i, t in enumerate(full)}
    return np.array([where[int(t)] for t in local])


class MeshSaves:
    """Runs one process on the mesh's quantised saves, as tests/
    test_torch_remat.py::QuantTwin runs the port on JAX's: at save i it
    quantises its own input, assembles the ranks' save i (rows over data
    where a rank holds a share of them, columns over model:
    `columns(width, m)` places rank m's, default its block), holds the two to each other (module docstring) and goes on
    with the mesh's, so that a step at a tie cannot spread."""

    def __init__(self, outs, j, columns=None):
        self.outs, self.j, self.columns = outs, j, columns
        self.n_saves = self.flips = 0
        self.real = layers.quantize
        layers.quantize = self.replay

    def close(self):
        layers.quantize = self.real

    def _shard(self, r, i, k):
        return self.outs[r][f"{self.j}/save/{i}/{k}"]

    def replay(self, x, bits=8, axis=None):
        assert axis is None
        q, sc = self.real(x, bits)
        i = self.n_saves
        self.n_saves += 1
        unpack = child.unpack_int4 if bits == 4 else (lambda t: t)
        ints = unpack(q).numpy().astype(np.int32)
        mesh_ints = np.zeros_like(ints)
        mesh_sc = np.zeros(tuple(sc.shape), np.float32)
        ratio = np.zeros(tuple(ints.shape), np.float32)
        seen = np.zeros(ints.shape, bool)
        width = ints.shape[-1]
        for r in range(len(self.outs)):
            d, m = divmod(r, 2)
            assert int(self._shard(r, i, "bits")) == bits
            got = unpack(torch.from_numpy(self._shard(r, i, "q"))).numpy()
            n, w = got.shape[0], got.shape[-1]
            # a bare layer's input is whole on every data rank
            rows = (slice(None) if n == ints.shape[0]
                    else slice(d * n, (d + 1) * n))
            cols = (self.columns(width, m) if self.columns is not None
                    else np.arange(m * w, (m + 1) * w))
            if seen[rows][..., cols].all():
                assert np.array_equal(mesh_ints[rows][..., cols], got)
            mesh_ints[rows][..., cols] = got
            ratio[rows][..., cols] = self._shard(r, i, "r")
            seen[rows][..., cols] = True
            if m:   # the model ranks reduced to one scale a row
                assert np.array_equal(self._shard(r, i, "sc"),
                                      mesh_sc[rows]), (i, r)
            mesh_sc[rows] = self._shard(r, i, "sc")
        assert seen.all()
        np.testing.assert_allclose(mesh_sc, sc.numpy(), rtol=1e-5)
        diff = mesh_ints - ints
        tie = np.zeros(diff.shape, bool)
        for v in (ratio, (x.detach().float() / sc).numpy()):
            tie |= np.abs(v - np.floor(v) - 0.5) < TIE
        assert np.all(np.abs(diff) <= 1) and np.all(tie[diff != 0]), i
        self.flips += int((diff != 0).sum())
        q = torch.from_numpy(mesh_ints.astype(np.int8))
        return (_pack_int4(q) if bits == 4 else q), torch.from_numpy(mesh_sc)


@pytest.mark.parametrize("policy,variant", [(p, v) for p, vs in STEPS.items()
                                            for v in vs])
def test_tp_quant_step_matches_one_process(runs, policy, variant):
    """Two 2 x 2 steps under `policy` against the one-process steps on the
    mesh's saves (MeshSaves): the losses, grad norm, parameters, AdamW
    state and BatchNorm statistics."""
    outs = runs["outs"]
    j, cfg, batches = runs["cases"][policy, variant]
    saves = MeshSaves(outs, j)
    try:
        metrics, _, state = _one_process(cfg, batches)
    finally:
        saves.close()
    per_layer = {"quant": 4, "quant4": 4, "quant_fc1": 1}[policy]
    assert saves.n_saves >= 2 * per_layer * 2
    assert sum(k.startswith(f"{j}/save/") for k in outs[0].files) == \
        4 * saves.n_saves
    print(f"{policy} {variant}: {saves.n_saves} saves, {saves.flips} "
          f"integers one step apart")
    got = json.loads(str(outs[0][f"{j}/metrics"]))
    for r in range(1, len(outs)):
        assert json.loads(str(outs[r][f"{j}/metrics"])) == got
    for want, have in zip(metrics, got):
        assert have["skipped_micro"] == want["skipped_micro"] == 0
        for k in ("loss", "main_loss", "contrastive_loss", "grad_norm"):
            np.testing.assert_allclose(have[k], want[k], rtol=1e-5, err_msg=k)
    for k, v in state.items():
        np.testing.assert_allclose(outs[0][f"{j}/state/{k}"], v, atol=1e-6,
                                   err_msg=k)


def test_tp_quant_step_matches_jax_trainer(runs):
    """The port's 2 x 2 step under quant against JAX's Trainer on a 2 x 2
    mesh from the same params, every rate 0."""
    j, want = runs["jax"]
    got = json.loads(str(runs["outs"][0][f"{j}/metrics"]))[0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=2e-4)


def test_vit_layer_packed_qkv_under_tp(runs):
    """The packed qkv save of a head-dim-64 ViTLayer over the model axis:
    output and gradients on 2 x 2 against one process."""
    j, params, x, g = runs["vit"]
    d, heads = VIT["hidden_size"], VIT["num_heads"]
    saves = MeshSaves(runs["outs"], j, lambda width, m: (
        _qkv_columns(d, heads, 2, m) if width == 3 * d
        else np.arange(m * width // 2, (m + 1) * width // 2)))
    try:
        y, gx, grads = child.vit_layer(VIT, "quant", params, x, g)
    finally:
        saves.close()
    assert saves.n_saves == 2   # qkv [2, 128, 384] and fc1 [2, 128, 256]
    # the parameters' gradients against the largest of them: the key
    # bias's is zero in exact arithmetic, rounding noise here
    scale = max(np.abs(v).max() for v in grads.values())
    for out in runs["outs"]:
        np.testing.assert_allclose(out[f"{j}/out"], y,
                                   atol=1e-5 * np.abs(y).max())
        np.testing.assert_allclose(out[f"{j}/gx"], gx,
                                   atol=1e-5 * np.abs(gx).max())
        for k, v in grads.items():
            np.testing.assert_allclose(out[f"{j}/grad/{k}"], v,
                                       atol=1e-5 * scale, err_msg=k)
