"""Readings of the control and of planted faults, at a cell's own size,
for setting the limits of `correct` (PERF.md gives them).

    python3 portbench/tools/control.py --workload <name> --seeds 1,2,3

Training cells: the plain reference in fp32 stands for a sound program and
is compared, by the driver's own comparison, with (a) the reference
computed with fp8 (e4m3) operands, the control; (b) the reference with
half of every micro-batch left out of its loss (the mean over the rest);
(c) the reference with one input token altered.  A state left unchanged
reads 1 on change_gap by construction and needs no run.
Ranking cells: on the first `check_batches` buckets of the drawn requests,
packed by the reference, the fp8 reference's probabilities against the
fp32 reference's (the largest gap).
One JSON line a seed and reading.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.batches import train_pool  # noqa: E402
from portbench.bench import Cell, Run, load_json  # noqa: E402
from portbench.drivers.train import compare  # noqa: E402
from portbench.reference.model import loss, weighted_bce  # noqa: E402
from portbench.reference.train import rank_probs, train_steps  # noqa: E402
from portbench.weights import make_weights  # noqa: E402


def half_batch(port):
    def hook(micro, good, best, aux):
        h = good.shape[0] // 2
        half = {k: v[:h] for k, v in micro.items()
                if k in ("label_good", "label_best")}
        return (weighted_bce(good[:h], half["label_good"],
                             float(port["train.loss.pos_weight_good"]))
                + weighted_bce(best[:h], half["label_best"],
                               float(port["train.loss.pos_weight_best"])))
    return hook


def training(cell, seed, device):
    port, mix = cell.port, cell.mix
    pool = train_pool(seed, mix, cell.traffic(mix["lengths_from"]), port)
    checks = int(mix["check_steps"])
    steps = pool[:checks]
    w = make_weights(port, seed, device)
    th0 = {k: v.detach().cpu() for k, v in w.items()}
    ts = int(port["train.seed"])
    t = time.perf_counter()
    ref = train_steps(port, w, steps, ts)
    out = {"reference_s": time.perf_counter() - t}
    altered = [{k: v.copy() for k, v in s.items()} for s in steps]
    tok = altered[0]["user_tokens"]
    tok[0, 0, 1] = (int(tok[0, 0, 1]) + 1) % (int(port["model.text.vocab_size"]) - 1)
    for name, kw, data in (("fp8", {"precision": "fp8"}, steps),
                           ("half_batch", {"loss_hook": half_batch(port)}, steps),
                           ("token_altered", {}, altered)):
        prog = train_steps(port, w, data, ts, **kw)
        r = Run(cell)
        g1 = {k: v.cpu() for k, v in prog["first_grads"].items()}
        th3 = {k: v.cpu() for k, v in prog["params"].items()}
        th3.update({k: v.cpu() for k, v in prog["stats"].items()})
        compare(r, prog["losses"], g1, th0, th3, ref)
        out[name] = {n: v for n, v, _ in r.checks}
    return out


def ranking(cell, seed, device):
    from portbench.drivers.rank import Traffic
    from portbench.reference.text import WordPiece, pack
    port, mix = cell.port, cell.mix
    tr = Traffic(seed, mix)
    tok = WordPiece(tr.vocab)
    bucket = int(mix["bucket"])
    k = int(mix["pairs_per_request"])
    w = make_weights(port, seed, device)
    gap = 0.0
    for j in range(int(mix["check_batches"])):
        reqs = range(j * bucket // k, (j + 1) * bucket // k)
        users = [int(tr.users[r]) for r in reqs for _ in range(k)]
        items = [int(i) for r in reqs for i in tr.items[r]]
        batch = {}
        for side, texts in (("user", [tr.user_text[u] for u in users]),
                            ("item", [tr.item_text[i] for i in items])):
            t, sc, st = pack(tok, texts, bucket * int(mix["chunks_per_sample"]),
                             int(port["model.packer.max_tok"]),
                             int(port["model.packer.max_chunks_per_sample"]),
                             int(port["model.packer.fixed_sent_count"]))
            batch[f"{side}_tokens"], batch[f"{side}_sent_chunk"], \
                batch[f"{side}_sent_tok"] = t, sc, st
        batch["has_image"] = np.asarray([tr.has_image[i] for i in items], np.int32)
        batch["patches"] = np.stack([tr.patch(i) if tr.has_image[i] else
                                     np.zeros((196, 768), np.uint8) for i in items])
        a = rank_probs(port, w, batch, device)
        b = rank_probs(port, w, batch, device, "fp8")
        gap = max(gap, float(np.abs(a - b).max()))
    return {"fp8": {"prob_gap": gap}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = Cell(manifest, args.workload, seed, 1.0, False, time.perf_counter(),
                    device=args.device)
        fn = training if cell.mix["driver"] == "train" else ranking
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **fn(cell, seed, args.device)}), flush=True)


if __name__ == "__main__":
    main()
