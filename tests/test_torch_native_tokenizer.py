"""The port's native C++ WordPiece tokenizer (mmoe_multimodal_rec_tpu_torch/
native/ and data/native_tokenizer.py): where it builds, that a failed build
is reported, and its ids and packed batches against the JAX package's
native tokenizer and the port's pure-Python tokenizer and packer, exactly,
on a vocab the test writes.  No speed is asserted."""
import os
import shutil

import numpy as np
import pytest
import torch

from mmoe_multimodal_rec_tpu.config import PackerConfig as JPackerConfig
from mmoe_multimodal_rec_tpu.data.native_tokenizer import (
    NativeWordPieceTokenizer as JNative)
from mmoe_multimodal_rec_tpu.data.packer import TextPacker as JPacker
from mmoe_multimodal_rec_tpu_torch import native
from mmoe_multimodal_rec_tpu_torch.config import Config, PackerConfig
from mmoe_multimodal_rec_tpu_torch.data import native_tokenizer
from mmoe_multimodal_rec_tpu_torch.data.native_tokenizer import (
    NativeWordPieceTokenizer, load_best_tokenizer)
from mmoe_multimodal_rec_tpu_torch.data.packer import (TextPacker,
                                                       packer_from_config)
from mmoe_multimodal_rec_tpu_torch.data.sentence import split_sentences
from mmoe_multimodal_rec_tpu_torch.data.synthetic import random_text
from mmoe_multimodal_rec_tpu_torch.data.wordpiece import (HashTokenizer,
                                                          WordPieceTokenizer)

# each xdist worker runs beside five others on the box: two threads
# keep torch from taking every core from the JAX tests
torch.set_num_threads(2)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
TEXTS = [
    "The bike helmet was great.",
    "UNBREAKABLE straps; fits perfectly!",
    "Broke after 1999 uses... price was 19.99, meh",
    "works   with\ttabs\nand newlines",
    "accents: café CAFÉ naïve über señor",
    "quotes “fancy” and 'plain' - dashes –",
    "",
    "a" * 150,  # > max_chars_per_word -> [UNK]
]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    words = ("the bike helmet was great light fit strap broke good un works "
             "perfect cafe 19 price quality tent sleeping bag running shoes "
             "compact durable waterproof").split()
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] +
             list("abcdefghijklmnopqrstuvwxyz") +
             [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz"] + words +
             ["##s", "##ed", "##ing", "##er", "##ly", "##break", "##able",
              "##99", ",", ".", "!", "?", "'", "-", ";", ":", '"'])
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    return str(path)


def test_native_builds_into_the_package_build_dir(vocab):
    """The library lands in the package's build/, not beside its source,
    and the loader picks the native tokenizer when it builds."""
    path = native.build_native()
    assert path == os.path.join(PACKAGE, "build", "libwordpiece.so")
    assert os.path.isfile(path)
    assert not [f for f in os.listdir(os.path.dirname(native.SOURCE))
                if f.endswith(".so")]
    assert isinstance(load_best_tokenizer(vocab), NativeWordPieceTokenizer)


def test_failed_build_is_reported_once(tmp_path, monkeypatch, capsys,
                                       vocab):
    """A library older than its source is rebuilt; a build that fails
    returns None and prints the compiler's output to stderr once, and the
    loader says why before the pure-Python tokenizer takes its place."""
    built = native.build_native()
    src = tmp_path / "wordpiece.cpp"
    src.write_text("this is not C++\n")
    lib = tmp_path / "build" / "libwordpiece.so"
    lib.parent.mkdir()
    shutil.copy(built, lib)
    os.utime(lib, (1, 1))
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(lib.parent))
    monkeypatch.setattr(native, "LIBRARY", str(lib))
    monkeypatch.setattr(native, "_reported", False)
    assert native.build_native() is None
    err = capsys.readouterr().err
    assert err.count("[native] building") == 1 and "error" in err
    assert native.build_native() is None
    assert capsys.readouterr().err == ""
    tok = load_best_tokenizer(vocab)
    assert type(tok) is WordPieceTokenizer
    assert "native WordPiece unavailable" in capsys.readouterr().err
    assert os.listdir(lib.parent) == ["libwordpiece.so"]  # no torn file


def test_fresh_library_is_not_rebuilt(monkeypatch):
    built = native.build_native()

    def no_compiler(*args, **kw):
        raise AssertionError("rebuilt a fresh library")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.build_native() == built


def _tokenizers(vocab):
    return (NativeWordPieceTokenizer(vocab), JNative(vocab),
            WordPieceTokenizer.from_vocab_file(vocab))


@pytest.mark.parametrize("method", ["encode", "encode_batch", "pack_batch",
                                    "pack_encoded_batch"])
def test_native_matches_jax_native_and_python(vocab, method):
    """The port's native tokenizer against the JAX package's and against
    the port's pure-Python WordPiece: ids, and (through TextPacker's fast
    paths) packed batches, including chunk-cap drops, budget exhaustion
    and re-truncation of sentences stored at a larger max_tok."""
    nat, jnat, py = _tokenizers(vocab)
    assert (nat.vocab_size, nat.pad_id, nat.cls_id, nat.sep_id,
            nat.sent_id) == (py.vocab_size, py.pad_id, py.cls_id, py.sep_id,
                             py.sent_id)
    if method == "encode":
        for t in TEXTS:
            for n in (None, 7):
                assert nat.encode(t, max_length=n) == \
                    jnat.encode(t, max_length=n) == \
                    py.encode(t, max_length=n), t
        return
    if method == "encode_batch":
        for n in (None, 16):
            assert nat.encode_batch(TEXTS, max_length=n) == \
                jnat.encode_batch(TEXTS, max_length=n) == \
                [py.encode(t, max_length=n) for t in TEXTS]
        assert nat.encode_batch([]) == []
        return
    for cfg, jcfg in ((PackerConfig(), JPackerConfig()),
                      (PackerConfig(max_tok=16, max_chunks_per_sample=2,
                                    fixed_sent_count=4),
                       JPackerConfig(max_tok=16, max_chunks_per_sample=2,
                                     fixed_sent_count=4))):
        rng = np.random.default_rng(42)
        texts = [random_text(rng, 1, 12) for _ in range(24)] + TEXTS
        enc = [[py.encode(s, max_length=cfg.max_tok + 5)
                for s in split_sentences(t)] for t in texts]
        for budget in (None, 8):
            packed = []
            for packer in (TextPacker(nat, cfg, splitter=split_sentences),
                           JPacker(jnat, jcfg, splitter=split_sentences),
                           TextPacker(py, cfg, splitter=split_sentences)):
                packed.append(packer.pack(texts, budget)
                              if method == "pack_batch" else
                              packer.pack_encoded(enc, budget))
            if method == "pack_encoded_batch":
                # the same sentences through the text path
                packed.append(TextPacker(py, cfg, splitter=split_sentences)
                              .pack(texts, budget))
            first = packed[0]
            assert first.n_chunks > 0
            for other in packed[1:]:
                assert other.n_chunks == first.n_chunks
                np.testing.assert_array_equal(other.tokens, first.tokens)
                np.testing.assert_array_equal(other.sent_chunk,
                                              first.sent_chunk)
                np.testing.assert_array_equal(other.sent_tok, first.sent_tok)


def test_packer_from_config_takes_the_native_tokenizer(vocab, capsys):
    """A vocab gives the native tokenizer; no vocab gives the hash stand-in
    inside the embedding table only when allowed, and an error otherwise."""
    cfg = Config()
    cfg.data.vocab_path = vocab
    assert isinstance(packer_from_config(cfg).tok, NativeWordPieceTokenizer)
    cfg = Config()
    with pytest.raises(ValueError, match="vocab_path is unset"):
        packer_from_config(cfg)
    cfg.data.allow_hash_tokenizer = True
    tok = packer_from_config(cfg).tok
    assert type(tok) is HashTokenizer
    assert tok.vocab_size == cfg.model.text.vocab_size - 1
    assert "HashTokenizer stand-in" in capsys.readouterr().err
    assert native_tokenizer.load_best_tokenizer(None).vocab_size == 30522
