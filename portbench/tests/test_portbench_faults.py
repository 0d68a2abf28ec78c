"""The comparison that decides `correct` comes out false: for the control
(the plain reference in the program's place, with fp8 operands) and for
each fault a cell can have, planted beneath a run that skips only the
look for a card."""
import numpy as np
import pytest
import torch

from tinycells import manifest, run

TRAIN = [w["name"] for w in manifest()["workloads"]
         if w["traffic"].startswith("train")]
RANK = [w["name"] for w in manifest()["workloads"]
        if w["traffic"].startswith("rank")]


def state_unchanged(trainer):
    trainer.optimizer.step = lambda *a, **k: None


def half_batch(trainer):
    from mmoe_multimodal_rec_tpu_torch.train import step
    real = step.total_loss

    def half(good, best, lg, lb, *a, **k):
        h = good.shape[0] // 2
        return real(good[:h], best[:h], lg[:h], lb[:h], *a, **k)
    step.total_loss = half
    trainer._restore = lambda: setattr(step, "total_loss", real)


def loss_altered(trainer):
    """The answer a training step produces, its loss, altered by 1%."""
    real = trainer.train_step

    def altered(batch, rngs):
        out = real(batch, rngs)
        return dict(out, loss=out["loss"] * 1.01)
    trainer.train_step = altered


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch, loss_altered],
                         ids=lambda f: f.__name__)
def test_training_faults_are_caught(name, fault):
    planted = []

    def plant(trainer):
        fault(trainer)
        planted.append(trainer)
    try:
        r = run(name, fault=plant)
    finally:
        for t in planted:
            getattr(t, "_restore", lambda: None)()
    assert not r.correct, r.checks


def answer_altered(predictor):
    real = predictor._forward

    def altered(batch):
        good, best = real(batch)
        good = good.copy()
        good[0] = 1.0 - good[0]
        return good, best
    predictor._forward = altered


def packed_token_altered(predictor):
    real = predictor.packer.pack

    def altered(*a, **k):
        out = real(*a, **k)
        out.tokens[0, 1] += 1
        return out
    predictor.packer.pack = altered


def half_pairs(predictor):
    real = predictor._forward

    def altered(batch):
        good, best = real(batch)
        h = len(good) // 2
        return (np.concatenate([good[:h], good[:h]]),
                np.concatenate([best[:h], best[:h]]))
    predictor._forward = altered


def item_pack_unseen(predictor):
    """The item side packed through the packer's class rather than the
    instance's `pack` that the benchmark wraps, so a batch shows one packer
    call; the scores stay right."""
    packer = predictor.packer
    cls_pack = type(packer).pack
    real = predictor.predict

    def predict(*a, **k):
        seen = packer.pack
        calls = []

        def pack(texts, budget):
            calls.append(budget)
            if len(calls) == 2:
                return cls_pack(packer, texts, budget)
            return seen(texts, budget)
        packer.pack = pack
        try:
            return real(*a, **k)
        finally:
            packer.pack = seen
    predictor.predict = predict


@pytest.mark.parametrize("name", RANK)
@pytest.mark.parametrize("fault", [answer_altered, packed_token_altered,
                                   half_pairs, item_pack_unseen],
                         ids=lambda f: f.__name__)
def test_ranking_faults_are_caught(name, fault):
    r = run(name, fault=fault)
    assert not r.correct, r.checks


@pytest.mark.parametrize("name", TRAIN + RANK)
def test_the_control_fails(name):
    """The reference with fp8 operands in the program's place: at this
    size the program on the CPU equals the fp32 reference, so judging the
    fp8 reference against the program reads what the control reads."""
    torch.manual_seed(0)
    r = run(name, precision="fp8")
    assert not r.correct, r.checks
