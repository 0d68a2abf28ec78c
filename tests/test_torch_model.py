"""The port's baseline model (mmoe_multimodal_rec_tpu_torch/models) against the
JAX package's flax modules, fp32.  The params are laid out by the flax
modules' own init (`jax.eval_shape`), their values drawn with numpy from a
seed so that every bias, norm and LoRA factor is non-trivial; they go to
JAX as they are and to the port through utils/convert.params_from_jax.
The same numpy inputs go through both.

Tolerances: encoder hidden states and head outputs within 2e-5, whole-model
logits within 1e-4.  The two frameworks sum matmuls in another order and
use their own erf, and the differences grow through a dozen LayerNorms and
residuals; nothing else differs."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from mmoe_multimodal_rec_tpu.models import bert as jbert
from mmoe_multimodal_rec_tpu.models import cross as jcross
from mmoe_multimodal_rec_tpu.models import heads as jheads
from mmoe_multimodal_rec_tpu.models import layers as jlayers
from mmoe_multimodal_rec_tpu.models import mmoe as jmmoe
from mmoe_multimodal_rec_tpu.models import text_expert as jtext
from mmoe_multimodal_rec_tpu.models import vit as jvit
from mmoe_multimodal_rec_tpu.utils import lora as jlora
from mmoe_multimodal_rec_tpu_torch.config import Config as TConfig
from mmoe_multimodal_rec_tpu_torch.models import bert as tbert
from mmoe_multimodal_rec_tpu_torch.models import cross as tcross
from mmoe_multimodal_rec_tpu_torch.models import heads as theads
from mmoe_multimodal_rec_tpu_torch.models import layers as tlayers
from mmoe_multimodal_rec_tpu_torch.models import mmoe as tmmoe
from mmoe_multimodal_rec_tpu_torch.models import text_expert as ttext
from mmoe_multimodal_rec_tpu_torch.models import vit as tvit
from mmoe_multimodal_rec_tpu_torch.utils import lora as tlora
from mmoe_multimodal_rec_tpu_torch.utils.convert import (load_jax_params,
                                                          params_from_jax)
from util import packed_batch, tiny_config

PART_ATOL = 2e-5
MODEL_ATOL = 1e-4
MODEL_KEYS = ("user_tokens", "user_sent_chunk", "user_sent_tok",
              "item_tokens", "item_sent_chunk", "item_sent_tok", "patches",
              "has_image")


def _tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _draw(shapes, seed):
    """Values for a flax param tree of `jax.ShapeDtypeStruct`s: kernels
    N(0, 1/fan_in), norm scales near 1, everything else (biases,
    embeddings, LoRA factors, cls/pos, gates) N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in traverse_util.flatten_dict(shapes).items():
        name = key[-1]
        if name == "kernel":
            v = rng.normal(0, leaf.shape[-2] ** -0.5, leaf.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            v = 0.1 * rng.normal(size=leaf.shape)
        out["/".join(key)] = v.astype(np.float32)
    return out


def _params(module, seed, *args, **kwargs):
    """Flat '/'-keyed numpy params of `module` at these inputs."""
    return _draw(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                                **kwargs)["params"], seed)


def _port_cfg(cfg):
    return TConfig.from_dict(cfg.to_dict())


def _torch(x):
    return torch.from_numpy(np.array(x))


def _apply(module, flat, *args, **kwargs):
    """module.apply under jit: one compile beats tracing op by op."""
    return jax.jit(functools.partial(module.apply, **kwargs))(
        {"params": _tree(flat)}, *args)


def _jax_apply(module, seed, *args):
    flat = _params(module, seed, *args)
    return flat, np.asarray(_apply(module, flat, *args))


def _load(module, flat, cfg):
    load_jax_params(module, flat, cfg.model, merge_lora=False)
    return module.eval()


def test_bert_encoder_matches_jax():
    cfg = tiny_config()
    tc = cfg.model.text
    rng = np.random.default_rng(0)
    ids = rng.integers(1, tc.vocab_size, (3, 24)).astype(np.int32)
    ids[1, 10:] = tc.pad_token_id
    ids[2, :] = tc.pad_token_id         # an all-pad chunk row
    flat, want = _jax_apply(jbert.BertEncoder(tc), 0, jnp.asarray(ids))
    port = _load(tbert.BertEncoder(_port_cfg(cfg).model.text), flat, cfg)
    with torch.no_grad():
        got = port(_torch(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=PART_ATOL)


def test_vit_encoder_matches_jax():
    cfg = tiny_config()
    rng = np.random.default_rng(1)
    patches = rng.normal(size=(2, 196, 768)).astype(np.float32)
    flat, want = _jax_apply(jvit.ViTEncoder(cfg.model.image), 1,
                            jnp.asarray(patches))
    port = _load(tvit.ViTEncoder(_port_cfg(cfg).model.image), flat, cfg)
    with torch.no_grad():
        got = port(_torch(patches)).numpy()
    assert got.shape == (2, 197, cfg.model.image.hidden_size)
    np.testing.assert_allclose(got, want, atol=PART_ATOL)


def test_gather_sentences_exact():
    rng = np.random.default_rng(2)
    h = rng.normal(size=(4, 8, 16)).astype(np.float32)
    h[3, 5] = 0.0                       # a real sentence whose vector is 0
    sent_chunk = np.array([[0, 0, 1, -1, -1], [2, 3, 3, 3, -1]], np.int32)
    sent_tok = np.array([[0, 4, 2, -1, -1], [7, 0, 5, 6, -1]], np.int32)
    want = jtext.gather_sentences(jnp.asarray(h), jnp.asarray(sent_chunk),
                                  jnp.asarray(sent_tok))
    got = ttext.gather_sentences(_torch(h), _torch(sent_chunk),
                                 _torch(sent_tok))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # padded sentences are exact zeros, and the zero vector counts as pad
    assert np.all(got[0].numpy()[0, 3:] == 0.0)
    assert got[1].numpy()[1].tolist() == [False, False, True, False, True]


def test_text_cross_expert_matches_jax():
    rng = np.random.default_rng(3)
    d, s = 32, 6
    u, i = (rng.normal(size=(3, s, d)).astype(np.float32) for _ in range(2))
    um = np.zeros((3, s), bool)
    um[0, 4:] = True
    um[2, :] = True                     # a user with no sentences
    im = np.zeros((3, s), bool)
    im[1, 1:] = True
    args = [jnp.asarray(x) for x in (u, um, i, im)]
    flat, want = _jax_apply(jcross.RobustTextCrossExpert(n_layers=2,
                                                         n_heads=4), 3, *args)
    port = _load(tcross.RobustTextCrossExpert(d, 2, 4), flat, tiny_config())
    with torch.no_grad():
        got = port(*(_torch(x) for x in (u, um, i, im))).numpy()
    np.testing.assert_allclose(got, want, atol=PART_ATOL)


def test_cross_fuse_matches_jax():
    rng = np.random.default_rng(4)
    v, t = (rng.normal(size=(3, 32)).astype(np.float32) for _ in range(2))
    flat, want = _jax_apply(jcross.EnhancedCrossFuse(depth=2, n_heads=4), 4,
                            jnp.asarray(v), jnp.asarray(t))
    port = _load(tcross.EnhancedCrossFuse(32, 2, 4), flat, tiny_config())
    with torch.no_grad():
        got = port(_torch(v), _torch(t)).numpy()
    np.testing.assert_allclose(got, want, atol=PART_ATOL)


def test_two_task_mmoe_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 6, 32)).astype(np.float32)
    module = jheads.TwoTaskMMoE(n_expert=6, tower_hidden=16)
    flat = _params(module, 5, jnp.asarray(x))
    want = _apply(module, flat, jnp.asarray(x))
    port = _load(theads.TwoTaskMMoE(32, 6, 16), flat, tiny_config())
    with torch.no_grad():
        got = port(_torch(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PART_ATOL)


def test_layer_norm_is_flax_layer_norm():
    """flax's default epsilon is 1e-6 (torch's is 1e-5), and the statistics
    are fp32 whatever the compute dtype: rows of variance ~1e-6 show both."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 64)) * 1e-3).astype(np.float32)
    for dtype, jdt, atol in ((torch.float32, jnp.float32, 1e-5),
                             (torch.bfloat16, jnp.bfloat16, 2e-2)):
        ln = fnn.LayerNorm(dtype=jdt)
        params = ln.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt))
        want = np.asarray(ln.apply(params, jnp.asarray(x, jdt)), np.float32)
        port = tlayers.LayerNorm(64, dtype=dtype)
        tlayers.init_weights(port, torch.Generator().manual_seed(0))
        with torch.no_grad():
            got = port(_torch(x).to(dtype)).float().numpy()
        np.testing.assert_allclose(got, want, atol=atol)
    assert tlayers.LayerNorm(8).eps == 1e-6


def test_gelu_exact_forms():
    x = np.linspace(-4, 4, 801).astype(np.float32)
    got = tlayers.gelu_exact(_torch(x)).numpy()
    want = np.asarray(jlayers.gelu_exact(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)   # erf form in fp32
    got16 = tlayers.gelu_exact(_torch(x).bfloat16()).float().numpy()
    want16 = np.asarray(jlayers.gelu_exact(jnp.asarray(x, jnp.bfloat16)),
                        np.float32)
    np.testing.assert_allclose(got16, want16, atol=3.2e-2)  # 2 bf16 ulp @ 4


def test_merge_lora_matches_jax():
    cfg = tiny_config()
    batch = packed_batch(cfg, seed=0)
    flat = _params(jmmoe.MMoERecModel(cfg.model), 3, batch)
    want = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(
        jlora.merge_lora(_tree(flat), cfg.model.text.lora_alpha)).items()}
    got = tlora.merge_lora(flat, cfg.model.text.lora_alpha)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    mcfg = tlora.merged_model_config(_port_cfg(cfg).model)
    assert mcfg.text.lora_rank == 0 and not mcfg.shared_text_base
    with pytest.raises(ValueError, match="no LoRA"):
        tlora.merge_lora(got, cfg.model.text.lora_alpha)


@pytest.fixture(scope="module")
def tiny_model():
    """The tiny baseline model with LoRA adapters, its params, batch and
    JAX outputs."""
    cfg = tiny_config()
    batch = {k: v for k, v in packed_batch(cfg, seed=0).items()
             if k in MODEL_KEYS}
    model = jmmoe.MMoERecModel(cfg.model)
    flat = _params(model, 9, batch)
    out = _apply(model, flat, batch, deterministic=True)
    return cfg, batch, flat, out


@pytest.mark.parametrize("merge", [True, False])
def test_full_model_matches_jax(tiny_model, merge):
    cfg, batch, flat, want = tiny_model
    mcfg = _port_cfg(cfg).model
    if merge:
        mcfg = tlora.merged_model_config(mcfg)
    port = tmmoe.MMoERecModel(mcfg)
    load_jax_params(port, flat, mcfg if not merge else _port_cfg(cfg).model,
                    merge_lora=merge)
    with torch.no_grad():
        got = port.eval()({k: _torch(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.logit_good.numpy(),
                               np.asarray(want.logit_good), atol=MODEL_ATOL)
    np.testing.assert_allclose(got.logit_best.numpy(),
                               np.asarray(want.logit_best), atol=MODEL_ATOL)
    for key in ("u_doc", "i_doc", "img_vec", "ui_vec", "xui", "xti"):
        np.testing.assert_allclose(got.aux[key].numpy(),
                                   np.asarray(want.aux[key]),
                                   atol=MODEL_ATOL, err_msg=key)


def test_full_model_packed_route_matches_jax(monkeypatch):
    """Hidden 128 with 2 heads (dh 64) and 128-token chunks: the port's gate
    sends every text and ViT self-attention through flash_attention_packed
    (its plain version on the CPU), while JAX on the CPU takes einsum."""
    cfg = tiny_config(batch_size=2)
    m = cfg.model
    m.use_flash_attention = True
    m.text.hidden_size = m.image.hidden_size = 128
    m.text.num_heads = m.image.num_heads = 2
    m.text.intermediate_size = m.image.intermediate_size = 256
    m.text.max_position_embeddings = 128
    m.packer.max_tok = 128
    batch = {k: v for k, v in packed_batch(cfg, seed=1).items()
             if k in MODEL_KEYS}
    model = jmmoe.MMoERecModel(cfg.model)
    flat = _params(model, 4, batch)
    want = _apply(model, flat, batch, deterministic=True)

    calls = []
    real = tlayers.flash_attention_packed

    def counting(qkv, *args):
        calls.append(tuple(qkv.shape))
        return real(qkv, *args)

    monkeypatch.setattr(tlayers, "flash_attention_packed", counting)
    pcfg = _port_cfg(cfg)
    port = tmmoe.MMoERecModel(tlora.merged_model_config(pcfg.model))
    load_jax_params(port, flat, pcfg.model, merge_lora=True)
    with torch.no_grad():
        got = port.eval()({k: _torch(v) for k, v in batch.items()})
    n_text = m.text.num_layers * 2
    assert len(calls) == n_text + m.image.num_layers
    assert calls[-1] == (2, 197, 3 * 128)
    np.testing.assert_allclose(got.logit_good.numpy(),
                               np.asarray(want.logit_good), atol=MODEL_ATOL)
    np.testing.assert_allclose(got.logit_best.numpy(),
                               np.asarray(want.logit_best), atol=MODEL_ATOL)


def test_load_jax_params_is_strict(tiny_model):
    cfg, _, flat, _ = tiny_model
    mcfg = _port_cfg(cfg).model
    port = tmmoe.MMoERecModel(mcfg)
    dropped = dict(flat)
    del dropped["head/tower_good/fc3/bias"]
    with pytest.raises(KeyError, match="head.tower_good.fc3.bias"):
        load_jax_params(port, dropped, mcfg, merge_lora=False)
    extra = dict(flat, **{"head/extra/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="head.extra.weight"):
        load_jax_params(port, extra, mcfg, merge_lora=False)
    state = params_from_jax(flat, mcfg, merge_lora=False)
    key = "user_expert.encoder.layer_0.attention.key.weight"
    np.testing.assert_array_equal(
        state[key].numpy(),
        flat["user_expert/encoder/layer_0/attention/key/kernel"].T)


def test_seeded_init_is_deterministic_and_complete():
    cfg = _port_cfg(tiny_config())
    a, b, c = (tlayers.init_weights(tmmoe.MMoERecModel(cfg.model),
                                    torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    key = "img_expert.backbone.layer_0.mlp.fc1.weight"
    assert torch.equal(sa[key], sb[key]) and not torch.equal(sa[key], sc[key])
    lora_b = [k for k in sa if k.endswith("lora_b")]
    assert lora_b and all(torch.count_nonzero(sa[k]) == 0 for k in lora_b)
    assert all(torch.isfinite(v).all() for v in sa.values())
    # lecun_normal: std sqrt(1/fan_in), truncated at 2 std of the raw normal
    w = sa["user_expert.encoder.layer_0.mlp.fc1.weight"]
    assert abs(w.std().item() - (1 / 32) ** 0.5) < 0.01
