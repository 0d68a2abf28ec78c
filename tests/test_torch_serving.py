"""The port's serving path (mmoe_multimodal_rec_tpu_torch/eval) on the CPU:
the LoRA-merged Predictor against the JAX Predictor on the same params and
texts, bucket padding, and the HTTP server (modelled on
tests/test_serving.py).  Per-sample outputs are independent of batch
composition, so a coalesced or padded score equals the instance scored
alone."""
import base64
import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from mmoe_multimodal_rec_tpu.config import Config as JConfig
from mmoe_multimodal_rec_tpu.data import packer as jpacker
from mmoe_multimodal_rec_tpu.data import wordpiece as jwordpiece
from mmoe_multimodal_rec_tpu.eval.predict import Predictor as JPredictor
from mmoe_multimodal_rec_tpu.models.mmoe import MMoERecModel as JModel
from mmoe_multimodal_rec_tpu.train import split_trainable
from mmoe_multimodal_rec_tpu.train.loop import dummy_batch
from mmoe_multimodal_rec_tpu_torch.config import Config as TConfig
from mmoe_multimodal_rec_tpu_torch.data import packer as tpacker
from mmoe_multimodal_rec_tpu_torch.data import wordpiece as twordpiece
from mmoe_multimodal_rec_tpu_torch.data.decode import PATCH_SHAPE
from mmoe_multimodal_rec_tpu_torch.data.wordpiece import HashTokenizer
from mmoe_multimodal_rec_tpu_torch.eval.predict import Predictor
from mmoe_multimodal_rec_tpu_torch.eval.server import PredictionServer
from mmoe_multimodal_rec_tpu_torch.models import layers as tlayers
from util import tiny_cli_flags, tiny_config, tiny_tokenizer

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

BATCH = 4
PROB_ATOL = 1e-5   # fp32 end to end; the logits agree to ~1e-7
USERS = ["Great bike, highly recommend. The frame is solid!",
         "Bad helmet.", "", "Arrived late. Works fine though. Meh."]
ITEMS = ["Mountain bike with solid frame.", "Cheap helmet.",
         "Tent for two. Waterproof.", "USB cable"]


def _port_cfg(cfg):
    return TConfig.from_dict(cfg.to_dict())


def _port_tokenizer(cfg):
    return HashTokenizer(vocab_size=cfg.model.text.vocab_size - 1)


def _params(cfg, seed=3):
    """Flat '/'-keyed numpy params in the JAX layout, with every LoRA
    factor (and bias) non-zero, as after training."""
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0),
                            dummy_batch(cfg, batch_size=BATCH))["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in traverse_util.flatten_dict(shapes).items():
        std = leaf.shape[-2] ** -0.5 if key[-1] == "kernel" else 0.05
        v = rng.normal(0, std, leaf.shape)
        flat["/".join(key)] = (1.0 + v if key[-1] == "scale" else v).astype(
            np.float32)
    return flat


def _patches(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, *PATCH_SHAPE), dtype=np.uint8)


def test_host_text_path_matches_jax(tmp_path):
    """The port's own copies of the config, the sentence splitter, both
    tokenizers and the packer give the JAX package's batches bit for bit."""
    flags = tiny_cli_flags()
    assert (TConfig.from_flags(flags).to_dict()
            == JConfig.from_flags(flags).to_dict())
    cfg = tiny_config()
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "tent", "##s",
         "great", "bike", ".", ",", "!", "un", "##able", "frame"]) + "\n")
    texts = USERS + ITEMS + ["Tents are great!!! The bike, unable. Dr. No.",
                             "word " * 40, "frame" * 30]
    for jtok, ttok in (
            (jwordpiece.HashTokenizer(200), twordpiece.HashTokenizer(200)),
            (jwordpiece.WordPieceTokenizer.from_vocab_file(str(vocab)),
             twordpiece.WordPieceTokenizer.from_vocab_file(str(vocab)))):
        for budget in (4, 12):
            want = jpacker.TextPacker(jtok, cfg.model.packer).pack(texts,
                                                                   budget)
            got = tpacker.TextPacker(ttok, _port_cfg(cfg).model.packer).pack(
                texts, budget)
            for field in ("tokens", "sent_chunk", "sent_tok", "n_chunks"):
                np.testing.assert_array_equal(getattr(got, field),
                                              getattr(want, field))


def test_merged_predictor_matches_jax_predictor():
    cfg = tiny_config("baseline", batch_size=BATCH)
    flat = _params(cfg)
    tree = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    trainable, frozen = split_trainable(tree, "baseline")
    jpred = JPredictor(cfg, trainable, frozen, batch_size=BATCH,
                       tokenizer=tiny_tokenizer(cfg))
    tpred = Predictor(_port_cfg(cfg), flat, batch_size=BATCH,
                      tokenizer=_port_tokenizer(cfg), device="cpu")
    assert tpred.model.cfg.text.lora_rank == 0      # LoRA folded in
    patches = _patches(BATCH)
    has_image = np.array([1, 0, 1, 1], np.int32)
    for args in ((USERS, ITEMS), (USERS[:3], ITEMS[:3]),
                 (USERS, ITEMS, patches, has_image)):
        want = jpred.predict(*args)
        got = tpred.predict(*args)
        for key in ("prob_good", "prob_best"):
            assert got[key].shape == (len(args[0]),)
            np.testing.assert_allclose(got[key], want[key], atol=PROB_ATOL)
    # the adapters kept apart score the same
    apart = Predictor(_port_cfg(cfg), flat, batch_size=BATCH,
                      tokenizer=_port_tokenizer(cfg), merge_lora=False,
                      device="cpu")
    assert apart.model.cfg.text.lora_rank == cfg.model.text.lora_rank
    want = tpred.predict(USERS, ITEMS)
    got = apart.predict(USERS, ITEMS)
    np.testing.assert_allclose(got["prob_good"], want["prob_good"],
                               atol=PROB_ATOL)


def test_unmerged_predictor_routes_through_flash_attention(monkeypatch):
    """With the adapters kept apart, every text self-attention of a model
    whose shapes the kernel takes (hidden 128, 2 heads of 64, 128-token
    chunks) goes through flash_attention (its plain version on the CPU), and
    the probabilities equal the merged model's, whose text attention takes
    flash_attention_packed."""
    cfg = tiny_config("baseline", batch_size=BATCH)
    m = cfg.model
    m.use_flash_attention = True
    m.text.hidden_size = m.image.hidden_size = 128
    m.text.num_heads = m.image.num_heads = 2
    m.text.intermediate_size = m.image.intermediate_size = 256
    m.text.max_position_embeddings = 128
    m.packer.max_tok = 128
    flat = _params(cfg)
    calls = []
    real = tlayers.flash_attention

    def counting(q, *args):
        calls.append(tuple(q.shape))
        return real(q, *args)

    monkeypatch.setattr(tlayers, "flash_attention", counting)
    kw = dict(batch_size=BATCH, tokenizer=_port_tokenizer(cfg), device="cpu")
    merged = Predictor(_port_cfg(cfg), flat, **kw).predict(USERS, ITEMS)
    assert calls == []
    apart = Predictor(_port_cfg(cfg), flat, merge_lora=False,
                      **kw).predict(USERS, ITEMS)
    assert len(calls) == 2 * m.text.num_layers
    assert all(c[1:] == (128, 128) for c in calls)
    for key in ("prob_good", "prob_best"):
        np.testing.assert_allclose(apart[key], merged[key], atol=PROB_ATOL)


@pytest.fixture(scope="module")
def predictor():
    cfg = _port_cfg(tiny_config("baseline"))
    return Predictor(cfg, batch_size=BATCH, tokenizer=_port_tokenizer(cfg),
                     device="cpu")


def test_bucket_padding_never_changes_scores():
    cfg = _port_cfg(tiny_config("baseline"))
    tok = _port_tokenizer(cfg)
    bucketed = Predictor(cfg, tokenizer=tok, buckets=[2, 4], device="cpu")
    single = Predictor(cfg, tokenizer=tok, batch_size=4, device="cpu")
    assert bucketed.batch_size == 4 and bucketed.buckets == [2, 4]
    a = bucketed.predict(["one review"], ["one item"])          # bucket 2
    b = single.predict(["one review"], ["one item"])            # bucket 4
    c = bucketed.predict(["one review"] * 3, ["one item"] * 3)  # bucket 4
    assert a["prob_good"].shape == (1,) and c["prob_good"].shape == (3,)
    np.testing.assert_allclose(a["prob_good"], b["prob_good"], atol=1e-6)
    np.testing.assert_allclose(c["prob_good"][0], a["prob_good"][0],
                               atol=1e-6)
    bucketed.warmup()
    # an explicit batch size joins the buckets
    wide = Predictor(cfg, tokenizer=tok, batch_size=6, buckets=[2, 4],
                     device="cpu")
    assert wide.buckets == [2, 4, 6] and wide.batch_size == 6
    assert len(wide.predict(["r"] * 5, ["i"] * 5)["prob_good"]) == 5
    with pytest.raises(ValueError, match="batch size"):
        wide.predict(["r"] * 7, ["i"] * 7)


def test_predictor_probabilities_and_seeded_init(predictor):
    out = predictor.predict(USERS, ITEMS, _patches(BATCH),
                            np.ones(BATCH, np.int32))
    for key in ("prob_good", "prob_best"):
        p = out[key]
        assert p.dtype == np.float32 and np.all((p > 0) & (p < 1))
    cfg = _port_cfg(tiny_config("baseline"))
    again = Predictor(cfg, batch_size=BATCH, tokenizer=_port_tokenizer(cfg),
                      device="cpu")
    np.testing.assert_array_equal(again.predict(USERS, ITEMS)["prob_good"],
                                  predictor.predict(USERS, ITEMS)["prob_good"])


def test_predictor_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(tiny_config("baseline"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, tokenizer=_port_tokenizer(cfg))


@pytest.fixture()
def server(predictor):
    srv = PredictionServer(predictor, host="127.0.0.1", port=0,
                           max_wait_ms=2.0,
                           model_info={"variant": "baseline", "step": 0})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_healthz_and_varz(server):
    code, out = _request(server, "GET", "/healthz")
    assert code == 200 and out["status"] == "ok"
    assert out["batch_size"] == BATCH and out["variant"] == "baseline"
    code, stats = _request(server, "GET", "/varz")
    assert code == 200 and stats["requests"] == 0


def test_predict_matches_direct_with_and_without_patches(server, predictor):
    """6 instances in one request (> batch 4: two device batches), half with
    a patch; each score equals the instance scored alone."""
    users = [f"great product review number {i}. works well" for i in range(6)]
    items = [f"item description text {i}" for i in range(6)]
    patches = _patches(6, seed=1)
    instances = []
    for j in range(6):
        inst = {"user_text": users[j], "item_text": items[j]}
        if j % 2:
            inst["patch_b64"] = base64.b64encode(patches[j].tobytes()).decode()
        instances.append(inst)
    code, out = _request(server, "POST", "/v1/predict",
                         {"instances": instances})
    assert code == 200 and len(out["predictions"]) == 6
    for j in range(6):
        solo = predictor.predict([users[j]], [items[j]], patches[j:j + 1],
                                 np.array([j % 2], np.int32))
        for key in ("prob_good", "prob_best"):
            np.testing.assert_allclose(out["predictions"][j][key],
                                       float(solo[key][0]), atol=1e-6)
    code, stats = _request(server, "GET", "/varz")
    assert stats["instances"] >= 6 and stats["device_batches"] >= 2


def test_concurrent_requests_coalesce(server, predictor):
    results = {}

    def post(k):
        results[k] = _request(server, "POST", "/v1/predict", {
            "instances": [{"user_text": f"user text {k}",
                           "item_text": "common item"}]})

    threads = [threading.Thread(target=post, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for k in range(4):
        code, out = results[k]
        assert code == 200
        solo = predictor.predict([f"user text {k}"], ["common item"])
        np.testing.assert_allclose(out["predictions"][0]["prob_good"],
                                   float(solo["prob_good"][0]), atol=1e-6)


def test_error_paths(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("POST", "/v1/predict", body="{not json",
                 headers={"Content-Type": "application/json"})
    assert conn.getresponse().status == 400
    conn.close()
    code, out = _request(server, "POST", "/v1/predict", {"rows": []})
    assert code == 400 and "instances" in out["error"]
    code, _ = _request(server, "POST", "/v1/predict",
                       {"instances": [{"user_text": 3}]})
    assert code == 400
    code, out = _request(server, "POST", "/v1/predict", {
        "instances": [{"user_text": "u", "item_text": "i",
                       "patch_b64": base64.b64encode(b"abc").decode()}]})
    assert code == 400 and "bytes" in out["error"]
    code, out = _request(server, "POST", "/v1/predict", {
        "instances": [{"user_text": "u", "item_text": "i",
                       "patch_b64": "not base64!"}]})
    assert code == 400 and "base64" in out["error"]
    assert _request(server, "GET", "/nope")[0] == 404
    assert _request(server, "POST", "/nope")[0] == 404
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("POST", "/v1/predict", body=b"x",
                 headers={"Content-Type": "application/json",
                          "Content-Length": str(1 << 31)})
    assert conn.getresponse().status == 413
    conn.close()
