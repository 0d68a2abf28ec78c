"""The operation and byte counts on small shapes, worked out by hand."""
import numpy as np
import pytest

from portbench.work import (BF16_FLOPS_PER_S, HBM_BYTES_PER_S, bound,
                            bwd_work, fwd_work, in_path_bounds, model_flops)


def test_bound_takes_the_larger_side():
    assert bound(HBM_BYTES_PER_S, 0) == (1000.0, "bytes")
    assert bound(0, BF16_FLOPS_PER_S) == (1000.0, "operations")
    assert bound(HBM_BYTES_PER_S, 2 * BF16_FLOPS_PER_S)[0] == 2000.0


def test_forward_unmasked():
    nbytes, flops, walked, tiles = fwd_work(None, 1, 64, 1, 64, 2, False)
    assert nbytes == (2 * 64 + 2 * 64) * 64 * 2
    assert flops == 4 * 64 * 64 * 64
    assert (walked, tiles) == (1, 1)


PAD = np.array([[False, False, True, True], [True, True, True, True]])


def test_forward_counts_the_keys_the_mask_leaves():
    # row 0 has 2 real keys; row 1 none, so its weights are uniform: 4
    nbytes, flops, walked, tiles = fwd_work(PAD, 2, 4, 3, 8, 2, True)
    d = 24
    assert nbytes == (2 * 2 * 4 + 2 * 6) * d * 2 + 2 * 4 + 2 * 3 * 4 * 8
    assert flops == 4 * 4 * 6 * d
    assert (walked, tiles) == (3 * 2, 3 * 2)


def test_backward_counts_the_same_keys():
    nbytes, flops = bwd_work(PAD, 2, 4, 3, 8, 2)
    d = 24
    assert nbytes == (5 * 2 * 4 + 2 * 6) * d * 2 + 2 * 4 + 2 * 3 * 4 * 8
    assert flops == 10 * 4 * 6 * d
    full = bwd_work(None, 2, 4, 3, 8, 2)[1]
    assert full == 10 * 4 * 8 * d and flops < full


def test_in_path_bound_is_the_sum_of_the_calls():
    call = (2, 4, 3, 8, PAD, False, 2)
    one, _ = in_path_bounds([call])
    two, _ = in_path_bounds([call, call])
    assert two == pytest.approx(2 * one)
    assert in_path_bounds([call], backward=True)[0] > one


PORT = {"model.text.hidden_size": 8, "model.text.intermediate_size": 16,
        "model.text.num_layers": 3, "model.text.lora_rank": 2,
        "model.text.lora_targets": ["query", "value"], "model.variant": "baseline",
        "model.image.hidden_size": 8, "model.image.intermediate_size": 16,
        "model.image.num_layers": 2, "model.image.num_patches": 4,
        "model.image.patch_dim": 12, "model.cross_layers": 2,
        "model.fuse_depth": 2, "model.tower_hidden": 4, "model.n_experts": 6}


def batch(extra_user_row=None, image=0):
    tok = np.zeros((3, 6), np.int32)
    tok[0, :5] = [101, 5, 0, 7, 102]            # filled to its [SEP]: 5, keys 4
    item = tok.copy()
    if extra_user_row is not None:
        tok[1, :len(extra_user_row)] = extra_user_row
    sent = np.full((1, 2), -1, np.int32)
    return {"user_tokens": tok, "item_tokens": item,
            "user_sent_chunk": sent, "user_sent_tok": sent,
            "item_sent_chunk": sent, "item_sent_tok": sent,
            "has_image": np.array([image], np.int32)}


def test_padding_counts_nothing_and_a_filled_chunk_counts_its_work():
    d, f, layers = 8, 16, 3
    base = model_flops(PORT, batch(), train=False)
    more = model_flops(PORT, batch([101, 9, 102]), train=False)
    # one more user chunk: 3 positions, 3 keys, in every text layer
    assert more - base == layers * (2 * 3 * (4 * d * d + 2 * d * f) + 4 * 9 * d)


def test_an_image_counts_the_vit():
    d, f, l = 8, 16, 5
    diff = (model_flops(PORT, batch(image=1), train=False)
            - model_flops(PORT, batch(image=0), train=False))
    assert diff == 2 * 4 * 12 * d + 2 * (2 * l * (4 * d * d + 2 * d * f)
                                         + 4 * l * l * d)


def test_training_adds_the_backward():
    fwd = model_flops(PORT, batch(), train=False)
    assert model_flops(PORT, batch(), train=True) > 2 * fwd


def test_timeline_busy_share_and_named_gaps():
    from portbench.trace import summarize
    dev = [(0.0, 100.0, "a"), (50.0, 150.0, "b"), (400.0, 500.0, "a"),
           (1000.0, 1100.0, "c")]
    host = [(0.0, 2000.0, "pb.predict"), (140.0, 390.0, "pb.pack"),
            (450.0, 520.0, "pb.forward"), (520.0, 990.0, "pb.pack")]
    busy, op_s, gaps = summarize(dev, host)
    assert busy == pytest.approx(350e-6)          # [0,150] + [400,500] + [1000,1100]
    assert op_s == {"a": pytest.approx(200e-6), "b": pytest.approx(100e-6),
                    "c": pytest.approx(100e-6)}
    # the gaps after 500 (500 us) and after 150 (250 us), each named by the
    # innermost span open at its midpoint
    assert gaps == [("pb.pack", pytest.approx(500e-6)),
                    ("pb.pack", pytest.approx(250e-6))]
