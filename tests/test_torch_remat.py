"""The port's per-layer recompute (`model.remat` under the six policies of
models/layers.resolve_remat_policy) and its quantised saves, against the
JAX package on the CPU, fp32.

Params come from the flax init's shapes (`jax.eval_shape`) with values
drawn by numpy; they reach the port through utils/convert.load_jax_params,
and every parameter trains (requires_grad) so that the quantised saves'
straight-through gradient reaches the base weights too.

Dropout: JAX derives its seeds from flax RNGs that torch cannot reproduce,
so the comparisons with JAX pin every site's seed to one value on both
sides, with hidden and LoRA dropout at 0.1.  Attention dropout stays 0
there: JAX on the CPU takes the einsum attention, whose bernoulli bits the
port does not draw.  The port against itself (remat against no remat)
runs every rate at 0.1 with a real generator, so each site has its own
seed and a recompute that drew new ones would show.

Tolerances: quantised bytes and scales bit for bit on the same input; the
layer outputs and gradients within 2e-5 of JAX's (tests/test_torch_model.py's
PART_ATOL, the two frameworks summing products in another order), scaled
by the largest gradient.  Under "quant"/"quant4"/"quant_fc1" the forward
consumes the dequantised values, and a value whose fp32 input lies within
that last-bits noise of a rounding tie may round to the next integer in one
package only: a one-step flip.  So there the test takes JAX's saved
integers and scales (`QuantTwin`), holds the port's own to them (equal,
or one step apart at a near tie, |x/scale - k - 1/2| < 1e-3), and then
holds the port run on JAX's integers to JAX within the limits above.
Remat against no remat: bit for bit under "full", "attn" and "dots"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch.utils._python_dispatch import TorchDispatchMode

from mmoe_multimodal_rec_tpu.models import bert as jbert
from mmoe_multimodal_rec_tpu.models import layers as jlayers
from mmoe_multimodal_rec_tpu.models import vit as jvit
from mmoe_multimodal_rec_tpu.models.mmoe import MMoERecModel as JModel
from mmoe_multimodal_rec_tpu.train import optimizer as jopt
from mmoe_multimodal_rec_tpu.train.step import TrainState, make_train_step
from mmoe_multimodal_rec_tpu_torch.config import Config as TConfig
from mmoe_multimodal_rec_tpu_torch.models import bert as tbert
from mmoe_multimodal_rec_tpu_torch.models import layers as tlayers
from mmoe_multimodal_rec_tpu_torch.models import vit as tvit
from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
from mmoe_multimodal_rec_tpu_torch.utils.convert import (load_jax_params,
                                                          params_from_jax)
from util import stacked_batch, tiny_config

torch.set_num_threads(2)

ATOL = 2e-5
SEED = 424242
POLICIES = ("full", "dots", "attn", "quant", "quant4", "quant_fc1")
EXACT = ("full", "dots", "attn")


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in traverse_util.flatten_dict(shapes).items():
        if key[-1] == "kernel":
            v = rng.normal(0, leaf.shape[-2] ** -0.5, leaf.shape)
        elif key[-1] == "scale":
            v = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            v = 0.1 * rng.normal(size=leaf.shape)
        out["/".join(key)] = v.astype(np.float32)
    return out


def _tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _port_cfg(cfg):
    return TConfig.from_dict(cfg.to_dict())


@pytest.fixture
def pinned_seeds(monkeypatch):
    """Every dropout site of both packages draws the seed SEED."""
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(SEED, jnp.int32))
    monkeypatch.setattr(tlayers, "draw_seed", lambda rng: SEED)


# ---------------------------------------------------------------------------
# quant_save
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_quant_save_matches_jax_bit_for_bit(monkeypatch, bits):
    """The saved integers (int4: the packed bytes) and scales equal JAX's
    bit for bit, the dequantised value too, and the gradient passes
    straight through to x in both packages.  Rows span six decades, one
    is all zeros (scale 1e-12), and one holds exact .5 ties (x/sc = k +
    1/2, which both round to the even integer)."""
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(7, 24)) * np.logspace(-3, 3, 7)[:, None]
    x[3] = 0.0
    x[5] = (np.arange(24) - 11.5) / 11.5 * (127.0 if bits == 8 else 7.0)
    x = x.astype(np.float32)
    saved = {}

    def record(value, name):
        saved[name] = np.asarray(value)
        return value

    import jax.ad_checkpoint
    monkeypatch.setattr(jax.ad_checkpoint, "checkpoint_name", record)
    want = np.asarray(jlayers.quant_save(jnp.asarray(x), "t", bits=bits))
    (q, sc) = tlayers.quantize(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(q.numpy(), saved[f"t_q{bits}"])
    assert q.dtype == torch.int8 and q.shape[-1] == 24 // (8 // bits)
    np.testing.assert_array_equal(sc.numpy(), saved["t_sc"])
    xt = torch.from_numpy(x).requires_grad_()
    got, _ = tlayers.quant_save(xt, bits)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * 3.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.full_like(x, 3.0))
    jgrad = jax.grad(lambda v: jnp.sum(
        jlayers.quant_save(v, "t", bits=bits) * 3.0))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jgrad), xt.grad.numpy())


def test_int4_nibbles_wrap_and_shift_as_jax():
    """Every int4 pair of values in [-7, 7]: `hi << 4` wraps in int8 and
    `>> 4` is arithmetic, in torch as in jnp."""
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8))
    q = np.concatenate([lo.reshape(1, -1), hi.reshape(1, -1)], 1).astype(
        np.int8)
    n = q.shape[1] // 2
    jq = jnp.asarray(q)
    want = np.asarray((jq[:, :n] & jnp.int8(0x0F)) | (jq[:, n:] << 4))
    tq = torch.from_numpy(q)
    got = ((tq[:, :n] & 0x0F) | (tq[:, n:] << 4)).numpy()
    np.testing.assert_array_equal(got, want)
    back = tlayers.dequantize(torch.from_numpy(got), torch.ones(1, 1), 4,
                              torch.float32)
    np.testing.assert_array_equal(back.numpy(), q.astype(np.float32))


class QuantTwin:
    """Runs the port on JAX's quantised saves, holding its own to them.

    JAX's `checkpoint_name` is wrapped to copy each named save out through
    a debug callback (the forward's and, where the backward recomputes
    them, the recompute's: the same values).  Then `replay` wraps the
    port's `quantize`: at each save it quantises its own input, takes the
    JAX save of that shape with the fewest differing integers (another
    layer's or micro-batch's differ almost everywhere), checks that the
    two differ only by one-step flips at near ties and that the scales
    agree within ATOL, and goes on with JAX's.  Each layer's input then
    follows JAX's values, so a flip upstream cannot spread."""

    def __init__(self, monkeypatch):
        import jax.ad_checkpoint as adc
        self.mp, self.jax, self.flips, self.n_saves = monkeypatch, [], 0, 0
        real = adc.checkpoint_name

        def named(value, name):
            jax.debug.callback(
                lambda v, n=name: self.jax.append((n, np.asarray(v))), value)
            return real(value, name)

        monkeypatch.setattr(adc, "checkpoint_name", named)

    @staticmethod
    def _ints(q, bits):
        return tlayers.dequantize(torch.as_tensor(q), torch.ones(()), bits,
                                  torch.float32).numpy()

    def replay(self):
        real = tlayers.quantize

        def on_jax_saves(x, bits=8, axis=None):
            q, sc = real(x, bits, axis)
            jq = min((a for n, a in self.jax if n.endswith(f"_q{bits}")
                      and a.shape == tuple(q.shape)),
                     key=lambda a: int((a != q.numpy()).sum()))
            jsc = min((a for n, a in self.jax if n.endswith("_sc")
                       and a.shape == tuple(sc.shape)),
                      key=lambda a: float(np.abs(a - sc.numpy()).max()))
            np.testing.assert_allclose(sc.numpy(), jsc, rtol=ATOL)
            d = self._ints(q, bits) - self._ints(jq, bits)
            r = (x.detach().float() / sc).numpy()
            near_tie = np.abs(r - np.floor(r) - 0.5) < 1e-3
            assert np.all(np.abs(d) <= 1) and np.all(near_tie[d != 0])
            self.flips += int((d != 0).sum())
            self.n_saves += 1
            return torch.from_numpy(jq.copy()), torch.from_numpy(jsc.copy())

        self.mp.setattr(tlayers, "quantize", on_jax_saves)
        return real


# ---------------------------------------------------------------------------
# one encoder under each policy
# ---------------------------------------------------------------------------

def _encoder_case(kind, policy, attention_dropout=0.0):
    """(JAX module, port module, input, loss weights) for a 2-layer text or
    image encoder under `policy`, hidden (and LoRA) dropout 0.1."""
    cfg = tiny_config()
    m = cfg.model
    rng = np.random.default_rng(3)
    if kind == "bert":
        t = m.text
        t.hidden_dropout = t.lora_dropout = 0.1
        t.attention_dropout = attention_dropout
        x = rng.integers(1, t.vocab_size, (3, 24)).astype(np.int32)
        x[1, 10:] = t.pad_token_id
        jmod = jbert.BertEncoder(t, remat=True, remat_policy=policy)
        tmod = tbert.BertEncoder(_port_cfg(cfg).model.text, remat=True,
                                 remat_policy=policy)
        out_shape = (3, 24, t.hidden_size)
    else:
        i = m.image
        i.hidden_dropout = 0.1
        i.attention_dropout = attention_dropout
        x = rng.normal(size=(2, 196, 768)).astype(np.float32)
        jmod = jvit.ViTEncoder(i, remat=True, remat_policy=policy)
        tmod = tvit.ViTEncoder(_port_cfg(cfg).model.image, remat=True,
                               remat_policy=policy)
        out_shape = (2, 197, i.hidden_size)
    flat = _draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"], 5)
    load_jax_params(tmod, flat, cfg.model, merge_lora=False)
    w = rng.normal(size=out_shape).astype(np.float32)
    return cfg, jmod, tmod, flat, x, w


def _port_grads(tmod, x, w, rng=None):
    out = tmod(torch.from_numpy(x), deterministic=False,
               rng=rng or torch.Generator().manual_seed(0))
    (out * torch.from_numpy(w)).sum().backward()
    grads = {n: p.grad.clone() for n, p in tmod.named_parameters()}
    tmod.zero_grad(set_to_none=True)
    return out.detach(), grads


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["bert", "vit"])
def test_encoder_under_policy_matches_jax(monkeypatch, pinned_seeds, kind,
                                          policy):
    """The training forward and every parameter's gradient under `policy`
    against JAX's under the same policy (quantising policies: the port's
    saves held to JAX's, then the port run on JAX's, see QuantTwin); then
    against the port without remat: bit for bit under full/dots/attn, and
    under the quantising policies only the dequantisation's deviation
    (gradient cosine > 0.99, the limit of tests/test_quant_remat.py::
    test_quant_grads_match_exact)."""
    _, jmod, tmod, flat, x, w = _encoder_case(kind, policy)

    def loss(params):
        out = jmod.apply({"params": params}, jnp.asarray(x),
                         deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out * w), out

    twin = QuantTwin(monkeypatch) if policy not in EXACT else None
    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _tree(flat))
    out, grads = _port_grads(tmod, x, w)
    on_jax_ints = out, grads
    if twin is not None:
        real = twin.replay()
        on_jax_ints = _port_grads(tmod, x, w)
        monkeypatch.setattr(tlayers, "quantize", real)
        per_layer = {"quant": 4, "quant4": 4, "quant_fc1": 1}[policy]
        assert twin.n_saves == 2 * per_layer
        print("one-step flips against JAX:", twin.flips)
    np.testing.assert_allclose(on_jax_ints[0].numpy(), np.asarray(want),
                               atol=ATOL)
    jflat = {"/".join(k): np.asarray(v) for k, v in
             traverse_util.flatten_dict(jgrads).items()}
    want_g = params_from_jax(jflat, None, merge_lora=False)
    assert sorted(want_g) == sorted(grads)
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name, g in on_jax_ints[1].items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   atol=ATOL * scale, err_msg=name)

    plain = type(tmod)(tmod.cfg, remat=False)
    plain.load_state_dict(tmod.state_dict())
    out0, grads0 = _port_grads(plain, x, w)
    if policy in EXACT:
        assert torch.equal(out, out0)
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), name
    else:
        a = torch.cat([g.flatten() for g in grads.values()])
        b = torch.cat([grads0[n].flatten() for n in grads])
        assert float(a @ b / (a.norm() * b.norm())) > 0.99


@pytest.mark.parametrize("kind", ["bert", "vit"])
def test_remat_replays_every_seed_and_keeps_eval_exact(kind):
    """Every rate at 0.1 (attention weights too) and seeds drawn from a
    real generator: the recompute must replay each site's seed, so the
    remat gradients under full and attn equal the no-remat ones bit for
    bit, and every policy leaves the generator where no remat does (the
    sites after the layer draw the same seeds).  A deterministic forward
    under "quant" does not quantise (JAX quantises only in training): it
    equals the no-remat forward bit for bit, with autograd on (the
    recompute path) and off."""
    cfg, _, tmod, _, x, w = _encoder_case(kind, "full", 0.1)
    plain = type(tmod)(tmod.cfg, remat=False)
    plain.load_state_dict(tmod.state_dict())
    gen = torch.Generator().manual_seed(11)
    out0, grads0 = _port_grads(plain, x, w, gen)
    after0 = torch.randint(0, 2 ** 31 - 1, (4,), generator=gen)
    for policy in POLICIES:
        model = type(tmod)(tmod.cfg, remat=True, remat_policy=policy)
        model.load_state_dict(tmod.state_dict())
        gen = torch.Generator().manual_seed(11)
        out, grads = _port_grads(model, x, w, gen)
        assert torch.equal(torch.randint(0, 2 ** 31 - 1, (4,),
                                         generator=gen), after0), policy
        if policy in EXACT:
            assert torch.equal(out, out0), policy
            for name, g in grads.items():
                assert torch.equal(g, grads0[name]), (policy, name)
        if policy == "quant":
            xt = torch.from_numpy(x)
            want = plain(xt, deterministic=True)
            assert torch.equal(model(xt, deterministic=True), want)
            with torch.no_grad():
                assert torch.equal(model(xt, deterministic=True), want)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm,
                                   torch.ops.aten.bmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_quant_backward_drops_the_recomputed_products():
    """As tests/test_quant_remat.py::test_quant_policy_drops_recompute_
    matmuls checks of XLA: with the base frozen (LoRA training), the
    backward under "quant" runs at least 4 x n_layers fewer products
    (aten mm/addmm/bmm) than under "attn": q, k, v and fc1 come from the
    saves instead of being recomputed.  "full" recomputes as "attn" does;
    no remat recomputes nothing."""
    counts = {}
    for policy in ("full", "attn", "quant", "quant4", "quant_fc1", None):
        _, _, tmod, _, x, w = _encoder_case("bert", policy or "dots")
        if policy is None:
            tmod = type(tmod)(tmod.cfg, remat=False)
        for name, p in tmod.named_parameters():
            p.requires_grad_("lora_" in name)
        out = tmod(torch.from_numpy(x), deterministic=False,
                   rng=torch.Generator().manual_seed(0))
        with _CountProducts() as mode:
            (out * torch.from_numpy(w)).sum().backward()
        counts[policy] = mode.n
    n_layers = tiny_config().model.text.num_layers
    assert counts["attn"] - counts["quant"] >= 4 * n_layers, counts
    assert counts["quant"] == counts["quant4"], counts
    assert counts["attn"] - counts["quant_fc1"] >= n_layers, counts
    assert counts["full"] == counts["attn"] > counts[None], counts


# ---------------------------------------------------------------------------
# the whole training step
# ---------------------------------------------------------------------------

def _jax_variables(cfg, seed):
    micro = {k: v[0] for k, v in stacked_batch(cfg, seed=0).items()}
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            micro)
    flat = _draw(shapes["params"], seed)
    rng = np.random.default_rng(seed + 1)
    stats = {}
    for key, leaf in traverse_util.flatten_dict(
            shapes.get("batch_stats", {})).items():
        v = (0.5 + rng.random(leaf.shape) if key[-1] == "var"
             else 0.1 * rng.normal(size=leaf.shape))
        stats["/".join(key)] = v.astype(np.float32)
    return flat, stats


@pytest.mark.parametrize("variant,policy", [("home", "quant4")])
def test_train_step_under_remat_matches_jax(monkeypatch, pinned_seeds,
                                            variant, policy):
    """One optimizer step (accum 2) of the whole model under remat, hidden
    and LoRA dropout 0.1 on pinned seeds, against JAX make_train_step under
    the same policy: the loss, grad_norm and every updated parameter
    (AdamW at eps 1 and lr 0.1, so the update is nearly linear in the
    gradient, as tests/test_torch_train.py runs it).  The port runs on
    JAX's quantised saves (QuantTwin), its own held to them: the HoME
    ViT's frozen layers quantise in the training forward too, as JAX's
    do."""
    cfg = tiny_config(variant)
    m = cfg.model
    m.remat, m.remat_policy = True, policy
    m.dropout = m.tower_dropout = 0.0
    m.home_expert_dropout = m.home_tower_dropout = 0.0
    m.text.attention_dropout = 0.0
    o = cfg.train.optim
    o.freeze_steps, o.unfreeze_steps, o.lr, o.eps = -1, 1, 0.1, 1.0
    o.home_freeze_steps, o.home_unfreeze_steps = -1, 1
    flat, stats = _jax_variables(cfg, 7)
    batch = stacked_batch(cfg, seed=1)
    trainable, frozen = jopt.split_trainable(_tree(flat), variant)
    labels = {k: jopt.label_param(k, variant) for k in trainable}
    tx = jopt.make_optimizer(cfg.train.optim, variant, labels)
    state = TrainState(step=jnp.zeros((), jnp.int32), trainable=trainable,
                       frozen=frozen,
                       batch_stats=_tree(stats) if stats else {},
                       opt_state=tx.init(trainable))
    twin = QuantTwin(monkeypatch)
    step = jax.jit(make_train_step(cfg, JModel(cfg.model), tx))
    new_state, want = step(state, batch, jax.random.PRNGKey(0))
    jax.block_until_ready(new_state)

    trainer = Trainer(_port_cfg(cfg), device="cpu", params=flat,
                      batch_stats=stats)
    twin.replay()
    got = trainer.run_step(batch)
    per_micro = 4 * (2 * m.text.num_layers + m.image.num_layers)
    assert twin.n_saves == cfg.train.optim.grad_accum * per_micro
    np.testing.assert_allclose(got["loss"], float(want["loss"]), atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]),
                               rtol=1e-4)
    for key, value in new_state.trainable.items():
        (name, want_p), = params_from_jax(
            {"/".join(key): np.asarray(value)}, None,
            merge_lora=False).items()
        np.testing.assert_allclose(trainer.trainable[name].detach().numpy(),
                                   want_p.numpy(), atol=1e-6, err_msg=name)
