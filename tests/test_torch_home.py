"""The port's HoME modules (mmoe_multimodal_rec_tpu_torch/models/home.py,
layers.BatchNorm1D, image_expert.ImageExpertWithProjection and the HoME
wiring of models/mmoe.py) against the JAX package's flax modules, fp32 on
the CPU.  Params and BatchNorm statistics are laid out by the flax init
(`jax.eval_shape`) and drawn with numpy; they go to the port through
utils/convert.load_jax_params.

Dropout: JAX derives every site's seed from flax RNGs that torch cannot
reproduce, so the module tests pin every site's seed to one value on both
sides (JAX's `jax.random.randint` draw and the port's `draw_seed`); the
same seed gives the same HashDropout mask.  The whole model runs in eval
mode, and in train mode at rate 0 (batch statistics), as the baseline's
parity does.

Tolerances: modules within 2e-5 (tests/test_torch_model.py's PART_ATOL),
the whole model within 1e-4 (MODEL_ATOL), BatchNorm statistics within
1e-5 (fp32 means and variances summed in another order)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

from mmoe_multimodal_rec_tpu.models import home as jhome
from mmoe_multimodal_rec_tpu.models import image_expert as jimg
from mmoe_multimodal_rec_tpu.models import layers as jlayers
from mmoe_multimodal_rec_tpu.models import mmoe as jmmoe
from mmoe_multimodal_rec_tpu.train import optimizer as jopt
from mmoe_multimodal_rec_tpu_torch.config import Config as TConfig
from mmoe_multimodal_rec_tpu_torch.models import home as thome
from mmoe_multimodal_rec_tpu_torch.models import image_expert as timg
from mmoe_multimodal_rec_tpu_torch.models import layers as tlayers
from mmoe_multimodal_rec_tpu_torch.models import mmoe as tmmoe
from mmoe_multimodal_rec_tpu_torch.train import optimizer as topt
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
from mmoe_multimodal_rec_tpu_torch.utils.convert import (load_jax_params,
                                                          params_from_jax)
from util import packed_batch, stacked_batch, tiny_config

PART_ATOL = 2e-5
MODEL_ATOL = 1e-4
STATS_ATOL = 1e-5
SEED = 424242
MODEL_KEYS = ("user_tokens", "user_sent_chunk", "user_sent_tok",
              "item_tokens", "item_sent_chunk", "item_sent_tok", "patches",
              "has_image")


def _flat(tree):
    return {"/".join(k): v for k, v in
            traverse_util.flatten_dict(tree).items()}


def _tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _variables(module, seed, *args, **kwargs):
    """(params, batch_stats) of `module` at these inputs, flat '/'-keyed
    numpy: kernels N(0, 1/fan_in), scales near 1, other params N(0, 0.1^2),
    running means N(0, 0.1^2) and running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    params = {}
    for key, leaf in _flat(shapes["params"]).items():
        name = key.rsplit("/", 1)[-1]
        if name == "kernel":
            v = rng.normal(0, leaf.shape[-2] ** -0.5, leaf.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            v = 0.1 * rng.normal(size=leaf.shape)
        params[key] = v.astype(np.float32)
    stats = {}
    for key, leaf in _flat(shapes.get("batch_stats", {})).items():
        v = (0.5 + rng.random(leaf.shape) if key.endswith("var")
             else 0.1 * rng.normal(size=leaf.shape))
        stats[key] = v.astype(np.float32)
    return params, stats


def _jax_vars(params, stats):
    out = {"params": _tree(params)}
    if stats:
        out["batch_stats"] = _tree(stats)
    return out


def _load(module, params, stats=None, cfg=None):
    load_jax_params(module, params, (cfg or tiny_config()).model,
                    merge_lora=False, batch_stats=stats)
    return module


def _torch(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def pinned_seeds(monkeypatch):
    """Every dropout site of both packages draws the seed SEED."""
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(SEED, jnp.int32))
    monkeypatch.setattr(tlayers, "draw_seed", lambda rng: SEED)


@pytest.mark.parametrize("use_running_average", [True, False])
def test_batch_norm_matches_jax(use_running_average):
    """Output and running statistics after one call: the running ones
    normalise, or the batch's (biased variance) do and the running ones
    move towards the batch mean and the unbiased variance."""
    rng = np.random.default_rng(0)
    x = (2.0 * rng.normal(size=(6, 3, 16)) + 0.5).astype(np.float32)
    module = jlayers.BatchNorm1D()
    params, stats = _variables(module, 1, jnp.asarray(x),
                               use_running_average=False)
    want, upd = module.apply(_jax_vars(params, stats), jnp.asarray(x),
                             use_running_average=use_running_average,
                             mutable=["batch_stats"])
    port = _load(tlayers.BatchNorm1D(16), params, stats)
    with torch.no_grad():
        got = port(_torch(x), use_running_average)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PART_ATOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(upd["batch_stats"][name]),
                                   atol=STATS_ATOL, err_msg=name)
    moved = not np.allclose(port.mean.numpy(), stats["mean"])
    assert moved == (not use_running_average)


def test_feature_and_self_gates_match_jax():
    rng = np.random.default_rng(2)
    x, y = (rng.normal(size=(5, 32)).astype(np.float32) for _ in range(2))
    fg = jhome.FeatureGate(3)
    params, _ = _variables(fg, 2, jnp.asarray(x))
    want = fg.apply({"params": _tree(params)}, jnp.asarray(x))
    port = _load(thome.FeatureGate(32, 3), params)
    with torch.no_grad():
        got = port(_torch(x))
    assert got.shape == (5, 3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PART_ATOL)
    sg = jhome.SelfGate()
    params, _ = _variables(sg, 3, jnp.asarray(x), jnp.asarray(y))
    want = sg.apply({"params": _tree(params)}, jnp.asarray(x), jnp.asarray(y))
    port = _load(thome.SelfGate(32), params)
    with torch.no_grad():
        got = port(_torch(x), _torch(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PART_ATOL)


def _train_apply(module, variables, *args, **kwargs):
    return module.apply(variables, *args, deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)}, **kwargs)


@pytest.mark.parametrize("deterministic", [True, False])
def test_home_tower_and_head_match_jax(pinned_seeds, deterministic):
    """HomeTower and HomeMMoEHead (dropout 0.1 in the expert MLPs and the
    towers) in eval mode and in train mode with pinned seeds."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 6, 32)).astype(np.float32)
    tower = jhome.HomeTower(hidden=16)
    head = jhome.HomeMMoEHead(expert_hidden=24, tower_hidden=16)
    for jmod, tmod, inp in (
            (tower, thome.HomeTower(32, 16), x[:, 0]),
            (head, thome.HomeMMoEHead(32, expert_hidden=24, tower_hidden=16),
             x)):
        params, _ = _variables(jmod, 5, jnp.asarray(inp))
        variables = {"params": _tree(params)}
        if deterministic:
            want = jmod.apply(variables, jnp.asarray(inp))
        else:
            want = _train_apply(jmod, variables, jnp.asarray(inp))
        port = _load(tmod, params)
        with torch.no_grad():
            got = port(_torch(inp), deterministic=deterministic,
                       rng=torch.Generator())
        got, want = ((got,), (want,)) if jmod is tower else (got, want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=PART_ATOL)


def test_home_expert_wrapper_matches_jax(pinned_seeds):
    """BatchNorm on the batch's statistics, SiLU, dropout 0.1 with a pinned
    seed, on [B, D] and [B, L, D]; the running statistics move alike."""
    rng = np.random.default_rng(6)
    for shape in ((8, 32), (4, 5, 32)):
        x = (rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
        module = jhome.HomeExpertWrapper()
        params, stats = _variables(module, 7, jnp.asarray(x),
                                   use_running_average=False)
        want, upd = _train_apply(module, _jax_vars(params, stats),
                                 jnp.asarray(x), use_running_average=False,
                                 mutable=["batch_stats"])
        port = _load(thome.HomeExpertWrapper(32), params, stats)
        with torch.no_grad():
            got = port(_torch(x), deterministic=False,
                       use_running_average=False, rng=torch.Generator())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=PART_ATOL)
        assert (got.numpy() == 0).mean() > 0.05
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(port.norm, name).numpy(),
                np.asarray(upd["batch_stats"]["norm"][name]),
                atol=STATS_ATOL)


def test_image_expert_with_projection_matches_jax():
    cfg = tiny_config("home")
    rng = np.random.default_rng(8)
    patches = rng.normal(size=(2, 196, 768)).astype(np.float32)
    module = jimg.ImageExpertWithProjection(cfg.model.image)
    params, _ = _variables(module, 8, jnp.asarray(patches))
    want = module.apply({"params": _tree(params)}, jnp.asarray(patches))
    port = _load(timg.ImageExpertWithProjection(
        TConfig.from_dict(cfg.to_dict()).model.image), params, cfg=cfg)
    with torch.no_grad():
        got = port(_torch(patches))
    for g, w in zip(got, want):
        assert g.shape == (2, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PART_ATOL)


def _no_model_dropout(cfg):
    m = cfg.model
    m.dropout = m.tower_dropout = 0.0
    m.home_expert_dropout = m.home_tower_dropout = 0.0
    t = m.text
    t.hidden_dropout = t.attention_dropout = t.lora_dropout = 0.0
    return cfg


@pytest.fixture(scope="module")
def home_model():
    """The tiny HoME model at rate 0, its variables and a batch with one
    user who has no sentences (the cross expert's all-masked pool row)."""
    cfg = _no_model_dropout(tiny_config("home"))
    batch = {k: v for k, v in packed_batch(cfg, seed=2).items()
             if k in MODEL_KEYS}
    batch["user_sent_chunk"][1] = -1
    batch["user_sent_tok"][1] = -1
    model = jmmoe.MMoERecModel(cfg.model)
    params, stats = _variables(model, 11, batch)
    return cfg, batch, model, params, stats


@pytest.mark.parametrize("train", [False, True])
def test_full_home_model_matches_jax(home_model, train):
    """The whole HoME model: eval mode (running BatchNorm statistics) and
    train mode at rate 0 (the batch's statistics, which then move): logits,
    the raw expert vectors and the projected image, and the statistics."""
    cfg, batch, model, params, stats = home_model
    apply = functools.partial(model.apply, deterministic=not train,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
    want, upd = jax.jit(apply)(_jax_vars(params, stats), batch)
    port = tmmoe.MMoERecModel(TConfig.from_dict(cfg.to_dict()).model)
    _load(port, params, stats, cfg)
    with torch.no_grad():
        got = port({k: _torch(v) for k, v in batch.items()},
                   deterministic=not train, rng=torch.Generator())
    for name in ("logit_good", "logit_best"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=MODEL_ATOL, err_msg=name)
    for key in ("u_doc", "i_doc", "img_vec", "ui_vec", "xui", "xti",
                "projected_img"):
        np.testing.assert_allclose(got.aux[key].numpy(),
                                   np.asarray(want.aux[key]),
                                   atol=MODEL_ATOL, err_msg=key)
    assert np.all(got.aux["ui_vec"].numpy()[1] == 0.0)   # nan_guard
    new_stats = _flat(upd["batch_stats"])
    buffers = dict(port.named_buffers())
    assert sorted(buffers) == sorted(k.replace("/", ".") for k in stats)
    for key, value in new_stats.items():
        np.testing.assert_allclose(buffers[key.replace("/", ".")].numpy(),
                                   np.asarray(value), atol=STATS_ATOL,
                                   err_msg=key)
        assert np.array_equal(value, stats[key]) == (not train)


def test_label_param_over_the_full_home_tree(home_model):
    """Every HoME parameter gets its JAX label; the wrappers and head are
    `other`, the projection head `img_ft`, the rest of the ViT frozen."""
    cfg, _, _, params, _ = home_model
    model = tmmoe.MMoERecModel(TConfig.from_dict(cfg.to_dict()).model)
    names = {name: p for name, p in model.named_parameters()}
    state = params_from_jax(params, None, merge_lora=False)
    assert sorted(names) == sorted(state)
    for key, value in params.items():
        (name, _), = params_from_jax({key: value}, None,
                                     merge_lora=False).items()
        want = jopt.label_param(tuple(key.split("/")), "home")
        assert topt.label_param(tuple(name.split(".")), "home") == want, key
    trainable, _ = topt.split_trainable(model, "home")
    assert any(k.startswith("u_doc_wrapper") for k in trainable)
    assert any("projection_head" in k for k in trainable)
    assert not any(k.startswith("img_expert.backbone") for k in trainable)


def test_non_finite_home_micro_batch_keeps_the_batch_norm_statistics():
    """As JAX keeps `batch_stats` through a NaN micro-batch: a step whose
    micro-batches all have a NaN loss leaves every BatchNorm buffer as it
    was; with one good micro-batch of two, they move and stay finite.  The
    trainer's checkpoint payload restores them and misses none."""
    cfg = TConfig.from_dict(tiny_config("home").to_dict())
    trainer = Trainer(cfg, device="cpu")
    good = stacked_batch(tiny_config("home"), seed=0)
    trainer.run_step(good)
    before = {k: b.clone() for k, b in trainer.model.named_buffers()}
    assert len(before) == 12
    bad = dict(good, label_good=np.full_like(good["label_good"], np.nan))
    m = trainer.run_step(bad)
    assert m["skipped_micro"] == cfg.train.optim.grad_accum
    for k, b in trainer.model.named_buffers():
        assert torch.equal(b, before[k]), k
    half = dict(good, label_good=good["label_good"].copy())
    half["label_good"][0] = np.nan
    m = trainer.run_step(half)
    assert m["skipped_micro"] == 1
    moved = [not torch.equal(b, before[k])
             for k, b in trainer.model.named_buffers()]
    assert all(moved)
    assert all(torch.isfinite(b).all() for b in trainer.model.buffers())
    # the checkpoint payload carries the statistics, strictly
    payload = trainer.state_dict()
    assert set(payload["batch_stats"]) == set(before)
    restored = Trainer(cfg, device="cpu")
    restored.load_state_dict(payload)
    for k, b in restored.model.named_buffers():
        assert torch.equal(b, dict(trainer.model.named_buffers())[k]), k
    del payload["batch_stats"]["xui_wrapper.norm.var"]
    with pytest.raises(KeyError, match="xui_wrapper.norm.var"):
        restored.load_state_dict(payload)


def test_load_jax_params_is_strict_over_batch_stats(home_model):
    """load_jax_params maps `<wrapper>/norm/{mean,var}` onto the BatchNorm
    buffers and raises, naming the buffer, when a statistic is missing or
    one more is given."""
    cfg, _, _, params, stats = home_model
    mcfg = TConfig.from_dict(cfg.to_dict()).model
    port = tmmoe.MMoERecModel(mcfg)
    load_jax_params(port, params, mcfg, merge_lora=False, batch_stats=stats)
    np.testing.assert_array_equal(port.xti_wrapper.norm.var.numpy(),
                                  stats["xti_wrapper/norm/var"])
    dropped = dict(stats)
    del dropped["u_doc_wrapper/norm/mean"]
    with pytest.raises(KeyError, match="u_doc_wrapper.norm.mean"):
        load_jax_params(port, params, mcfg, merge_lora=False,
                        batch_stats=dropped)
    with pytest.raises(KeyError, match="img_vec_wrapper.norm.var"):
        load_jax_params(port, params, mcfg, merge_lora=False)
    extra = dict(stats, **{"head/norm/mean": np.zeros(32, np.float32)})
    with pytest.raises(KeyError, match="head.norm.mean"):
        load_jax_params(port, params, mcfg, merge_lora=False,
                        batch_stats=extra)
