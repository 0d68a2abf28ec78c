#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training and offline data
paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits non-zero without the final result line:
  1. device: name, count, and name + power limit from nvidia-smi;
  2. build: every CUDA kernel of the paths from csrc/ (one nvcc per source,
     all started together; sm_90a), with ptxas's registers and spills per
     kernel; it fails if the main path's dh-64 bf16 attention kernels (the
     three forward instantiations, the four backward ones) or its bf16 LoRA
     forward, dA and dh kernels spill; the loops of the LoRA and keep mask
     kernels, whose integer issue bounds them, counted in their SASS
     (cuobjdump);
  3. kernels: each kernel against its plain PyTorch version at the main
     paths' shapes (bf16 in; the plain forward in fp32 on the same inputs,
     the plain backward on the same bf16 inputs), with the kernel's, the
     plain version's and the library call's times (CUDA events, warm)
     beside the bound computed from the inputs, per call and for one
     forward's (one training step's) worth of calls timed back to back; the
     training kernels' dropout masks read back through them.  Phases
     kernel_check / split_kernel_check for #1-#3 (#2 and #3 at the text
     shape timed at rates 0.1 and 0), lora_kernels for the fused LoRA
     dropout #4-#6 (M = 49152, D = 768, r = 8, rate 0.1; the mask read back
     through #6 in every entry, the dropped input through #4 in every entry
     and through #5 in 512 rows, bit for bit; besides the events, each
     kernel's device time from torch.profiler and the host's time to
     enqueue a call; torch.matmul(h, A)'s time logged as context) and
     packed_bwd_kernel for #7 (ViT B = 64,
     L = 197; and B = 128, L = 384 masked at rate 0.1).  Two calls on the
     same inputs must give the same results bit for bit (#3-#7),
     and each timed attention forward and backward also runs back to back
     for a second while nvidia-smi samples the SM clock and the power draw.
     The forward's bound counts the keys the call's pad mask leaves each row
     (its real keys; every key for a row with none), as the kernel walks
     only the key tiles that hold one;
  4. predictor: the full-width Predictor (batch 64, 2 chunks per sample,
     BERT-base x2 + ViT-base, bf16 compute, seeded init weights) scores a
     few batches on the host clock (and, apart, the host packing of their
     texts), then two more under torch.profiler: device time by kind, the
     kernel's device ms per forward and the device's busy share, and the
     bound of those forwards' attention inputs and the share of key tiles
     the kernel walked in them.  The
     kernel launch counts of that run are checked, the probabilities must
     be finite, in (0, 1), and agree with the same model on the plain
     attention path; a small fp32 model must agree with the same model on
     the CPU;
  5. server: PredictionServer on 127.0.0.1 answers concurrent POSTs (some
     with patch_b64) equal to direct predict();
  6. train: the full-width baseline Trainer at the default configuration
     (micro-batch 64, grad_accum 2, 2 chunks of 384 tokens per sample,
     BERT-base x2 with LoRA r=8 on query/value and the fused LoRA dropout,
     frozen ViT-base, bf16 compute, dropout 0.1, AdamW with the
     freeze->warmup LoRA group, no remat) on a seeded random batch staged
     on the card once: 1 warm-up step, 3 steps on the host clock, 1 step
     under torch.profiler (its attention inputs give #1's, #2's and #3's
     bound per step); launches per step of #1-#7 checked, losses finite,
     no micro-batch skipped, peak memory;
  7. train_check: the same at 2 text layers, one step on the kernel path
     and one on the plain attention path, same weights, batch and seeds:
     loss, grad_norm and LoRA gradient gaps against stated limits; then
     lora_check: fp32 at 2 text layers, the fused LoRA dropout against the
     unfused branch (the same masks), the same gaps;
  8. home_train: the full-width HoME Trainer at the same shape (ViT layers
     10-11 fine-tuned through #7): launches per step, losses, BatchNorm
     statistics moved and finite, ViT layer 10-11 gradients finite and
     non-zero and their weights unmoved (lr 0 while frozen), examples/s,
     peak memory, device time by kind;
  9. home_check: HoME at 2 text layers on the kernel path against the plain
     attention path: loss, grad_norm and ViT layer 10-11 gradient gaps;
 10. keep_mask_kernel: #8 (the short attentions' dropout keep mask) against
     its plain version bit for bit at the main path's shapes, the text mask
     read-back shape and a ragged lk, per call (events, device time from
     torch.profiler, host enqueue) and per training step's 18 calls; the
     train and home_train phases check its launches per step and that the
     plain version never runs on the card in their steps;
 11. eval: the checkpoint the train phase's Trainer wrote (CheckpointManager)
     restored and evaluated over synthetic shards of 200 samples (a padded
     trailing batch) at batch 64, on the host clock and under
     torch.profiler: n, finite AUCs, launches of #1 and #2 per forward;
     probabilities against the plain attention path and, for a small fp32
     model, against the CPU; then the CLI `eval --checkpoint` in a
     subprocess prints the same n and AUCs;
 12. home_eval: the HoME checkpoint recalibrated over 2 batches of 128 (the
     BatchNorm statistics move and stay finite) and evaluated; a small fp32
     HoME model's recalibrated statistics and probabilities, card against
     CPU;
 13. pipeline: the offline data path through the CLI on seeded raw records
     in the schema ingest writes (300 items, 200 users of 6-10 reviews of
     40-150 words), a WordPiece vocab.txt of the model's 30522 entries and
     numpy images as patch records for half the items: `features`,
     `build-dataset` (train, valid), `pretokenize`, `validate` (exit 0, no
     sample dropped, every sample pretokenized, about half with an image);
     then `train` at full width (the default configuration, 2 optimizer
     steps) on the pretokenized train shards: the native tokenizer packs
     every batch through pack_encoded, launches of #1-#8 per step as the
     train phase's, no skipped micro-batch; `eval` of its checkpoint over
     the valid shards (n = the split's samples); `ckpt-info` (latest step
     2, the trainer's own counts); and one 64-pair batch of these texts
     packed on the host by the pure-Python and the native WordPiece and by
     pack_encoded, the same arrays, with their times.
Then one JSON line of kernel records, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.  Needs one card; exits non-zero
without one.

    python3 chip_smoke.py --fwd-variants 'label=[checkout];...'

times the attention forwards of several checkouts of the repo beside each
other instead (empty: this one; say the parent's, unpacked by `git
archive` into the git-ignored _parent/, or a copy with another
csrc/flash_attention_fwd.cu): after the device phase, each checkout builds
its attention kernels in a process of its own, all started together, and
then, in the listed order and then reversed, runs kernel_check's text, ViT
and rate 0.1 cases and split_kernel_check's rates 0.1 and 0 in another,
through its own chip_smoke.py.

    python3 chip_smoke.py --lora-variants 'label=[checkout];...'

does the same for the fused LoRA dropout kernels: each checkout builds
csrc/lora_dropout.cu and runs its own phase_lora_kernels (#4-#6 at the main
path's shape, per call and per step's calls), in turns.

    python3 chip_smoke.py --keep-mask-variants 'label=[checkout];...'

does the same for #8: each checkout builds csrc/dropout_keep_mask.cu and
runs its own phase_keep_mask_kernel, then the main path's two shapes'
device time, events and host enqueue a call, in turns.  The variants'
build lines report the compiled loops of the LoRA and keep mask kernels.

It drives the checkout it sits in, or else the one it is run
from (python3 /elsewhere/chip_smoke.py from a checkout's root), and exits
non-zero, printing no result, when neither holds the port's package.
Checkpoints and shards go to the git-ignored _smoke_work/ of that
checkout, removed at the end.
"""
from __future__ import annotations

import base64
import concurrent.futures
import http.client
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
KERNEL_TOL = 2e-2               # bf16 output vs the fp32 plain version
BWD_TOL = 3e-2                  # bf16 gradients vs the plain backward on
                                # the same bf16 inputs, of the largest
                                # reference gradient (ds, p*keep round to
                                # bf16 from slightly different fp32 values)
FP32_KERNEL_TOL = 1e-4          # fp32 kernel: summation order, exp2f
PLAIN_PATH_TOL = 1e-2           # probabilities, kernel vs plain attention
SMALL_CPU_TOL = 1e-4            # probabilities, fp32 model, GPU vs CPU
SERVER_TOL = 2e-3               # probabilities, micro-batched vs direct
TEXT = dict(b=128, l=384, heads=12, dh=64, hb=6, calls=24)
STEP_MICRO_BATCHES = 2          # grad_accum of the training path
VIT = dict(b=64, l=197, heads=12, dh=64, hb=6, calls=12)
# train_check: kernel path vs plain attention path, bf16 end to end
CHECK_LOSS_TOL = 2e-2           # absolute, on a loss near 1.4
CHECK_NORM_TOL = 5e-2           # relative grad_norm gap
# LoRA gradients, over every LoRA tensor: max |dg| / max |g| and
# ||dg|| / ||g|| (grad_gaps).  The plain path rounds the scores to
# bf16 before the softmax (as the JAX einsum path does), so the two paths
# differ by bf16 rounding: 0.054 and 0.047 on an H100 at this phase's
# shape.  The limits are 2.2x and 2.1x those readings.  A backward that
# is wrong by a dropout scale on dq and dk alone exceeds them, on a small
# bf16 model on the CPU (tests/test_torch_train.py)
CHECK_GRAD_TOL = 0.12
CHECK_GRAD_L2_TOL = 0.10
TRAIN_LOSS_RANGE = (0.5, 3.0)   # two weighted BCEs near 2 * ln 2 at init
# HoME's contrastive part: three InfoNCE terms at weight 0.1 over the 64
# in-batch candidates at temperature 0.07.  Each lies in [0, 2/0.07 + ln 64]
# (cosine logits are within +-1/0.07); near init each is about ln 64 = 4.16,
# and on the CPU (tiny HoME, 4 candidates) the part is 0.52-0.60 against
# 0.3 ln 4 = 0.42.  So the part is checked in (0.3 ln 64 / 2, 0.3 (2/0.07 +
# ln 64)) and the main part in TRAIN_LOSS_RANGE.
HOME_CONTRASTIVE_RANGE = (0.15 * math.log(64), 0.3 * (2 / 0.07 + math.log(64)))
LORA = dict(m=49152, d=768, r=8, rate=0.1)  # 128 chunks x 384 tokens
LORA_TOL = 2.0 ** -7            # bf16 kernels vs plain versions on the same
                                # inputs, of the largest value: both round an
                                # fp32 sum taken in another order to bf16
# lora_check: fused LoRA dropout vs the unfused branch, fp32 (in bf16 the
# branches' own rounding of 1/(1-r), a product by 1.109375 against a
# quotient by 0.9, moves LoRA gradients by 3-7% on a small model, which
# would hide a dh lacking 1/(1-r) on the LoRA share of the input gradient;
# in fp32 the branches agree to ~2e-6 there and that dh moves them by
# ~1e-2, tests/test_torch_train.py).  Limits: 2.5x the readings on an H100
# (grad_norm 2.4e-7, gradients 9.95e-5 max and 8.6e-5 L2); the loss gap
# read 0, and its limit is 8 fp32 units in the last place of the loss.
LORA_CHECK_LOSS_TOL = 1e-6
LORA_CHECK_NORM_TOL = 6e-7
LORA_CHECK_GRAD_TOL = 2.5e-4
LORA_CHECK_GRAD_L2_TOL = 2.5e-4
# home_check: kernel path vs plain attention path, bf16, on the loss, the
# step's grad_norm and the ViT layer 10-11 gradients (the plain path rounds
# the scores to bf16 before the softmax; bias gradients sum 12,608 rows of
# those differences).  Limits: 2.5x the readings on an H100 (loss 8.0e-4,
# grad_norm 1.5e-3, gradients 0.129 max on layer 10's out bias and 0.090
# L2 on layer 11's norm1 bias)
HOME_CHECK_LOSS_TOL = 2e-3
HOME_CHECK_NORM_TOL = 4e-3
HOME_CHECK_GRAD_TOL = 0.32
HOME_CHECK_GRAD_L2_TOL = 0.22
# keep_mask_kernel: (b, h, lq, lk) of the sentence cross expert's 5
# attentions and the fuse experts' 4 per micro-batch forward, the text mask
# read-back shape, and an lk that is not a multiple of 16 (byte stores)
KEEP_MASK_SHAPES = {"cross": (64, 8, 64, 64), "fuse": (64, 8, 2, 2),
                    "text_read_back": (4, 12, 384, 384),
                    "ragged_lk": (64, 8, 64, 50)}
# eval: synthetic samples (3 full batches of 64 and a padded one of 8)
EVAL_SAMPLES = 200
HOME_RECAL_SAMPLES = 256        # 2 recalibration batches of 128
# the CLI eval in a subprocess against the same evaluation in this one:
# the same kernels on the same inputs; a flip of two near-equal
# probabilities by another cuBLAS choice moves an AUC by 1/(pos*neg) ~ 1e-4
CLI_AUC_TOL = 1e-3
# small fp32 HoME: recalibrated statistics, card against CPU, of each
# tensor's largest value (fp32 sums in another order through 2 layers)
SMALL_STATS_TOL = 1e-4
PACKAGE = "mmoe_multimodal_rec_tpu_torch"


def find_checkout():
    """The checkout this run drives: the script's own directory when it
    holds the port's package, else the working directory when that does (a
    copy of the script run from the root of a checkout); None otherwise."""
    for d in (os.path.dirname(os.path.abspath(__file__)), os.getcwd()):
        if os.path.isdir(os.path.join(d, PACKAGE)):
            return d
    return None


REPO = find_checkout()
WORK = os.path.join(REPO, "_smoke_work") if REPO else None


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sustained(fn, seconds: float = 1.0) -> dict:
    """fn() back to back for about `seconds` while nvidia-smi samples the SM
    clock (MHz) and the power draw (W) every 100 ms: ms per call over the
    window (CUDA events) and each sample's min, median and max, to read a
    kernel's time beside the clocks it ran at."""
    import torch
    per_call = cuda_ms(fn, iters=5, warmup=2)
    iters = max(5, int(1e3 * seconds / max(per_call, 1e-3)))
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        # a third of the window under load while nvidia-smi starts
        ms = cuda_ms(fn, iters=iters, warmup=iters // 3)
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    samples = []
    for line in out.splitlines():
        try:
            samples.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    rec = {"ms": ms, "calls": iters, "smi_samples": len(samples)}
    for i, key in enumerate(("sm_clock_mhz", "power_w")):
        vals = sorted(s[i] for s in samples if len(s) == 2)
        if vals:
            rec[key] = [vals[0], vals[len(vals) // 2], vals[-1]]
    torch.cuda.synchronize()
    return rec


def host_ms(fn, iters: int = 200) -> float:
    """Host-clock ms a call of fn() takes to enqueue, back to back with no
    synchronisation between calls: where it exceeds the device time, the
    host and not the kernel sets the pace of back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return ms


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

def bound(nbytes, flops):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the bf16 tensor-core peak."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def fwd_work(pad, b, l, heads, dh, el, stats):
    """What one attention forward call must move and do, from its pad mask:
    (bytes, products, key tiles walked, key tiles), tiles counted over
    (row, head).  Each row's q is read and its output written once; k, v
    and the products count only the keys a row needs, its real keys (a
    padded key weighs exactly 0 beside a real one) or every key for a row
    with none (uniform weights), as the kernel walks only the key tiles that
    hold a real key; then the pad mask read and the statistics written
    (`stats`)."""
    d, nt = heads * dh, -(-l // 64)
    if pad is None:
        keys, walked = b * l, b * nt
    else:
        real = ~pad.bool()
        n = real.sum(1)
        keys = int(n.masked_fill(n == 0, l).sum())
        live = real.new_zeros(b, nt * 64)
        live[:, :l] = real
        live = live.reshape(b, nt, 64).any(2).sum(1)
        walked = int(live.masked_fill(live == 0, nt).sum())
    nbytes = ((2 * b * l + 2 * keys) * d * el + (0 if pad is None else b * l)
              + (b * heads * l * 8 if stats else 0))
    return nbytes, 4 * l * keys * d, heads * walked, heads * b * nt


def bwd_work(b, l, heads, dh, el):
    """What one split backward call must move and do, walking every key:
    q, k, v and dO read and dq, dk, dv written once, the pad mask and the
    statistics read; (bytes, products)."""
    d = heads * dh
    return 7 * b * l * d * el + b * l + b * heads * l * 8, 10 * b * l * l * d


def attention_case(name, b, l, heads, dh, hb, masked, rate, gen,
                   dtype=None, tol=KERNEL_TOL, timed=True):
    import torch
    import torch.nn.functional as F
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    dtype = dtype or torch.bfloat16
    d = heads * dh
    qkv = torch.randn(b, l, 3 * d, generator=gen, device="cuda").to(dtype)
    pad = None
    if masked:
        # real lengths spread over [1, L], and one all-pad row
        lens = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
        pad = torch.arange(l, device="cuda")[None, :] >= lens[:, None]
        pad[b // 2] = True
    seed = 1234 if rate > 0 else None
    kernel = lambda: fa.flash_attention_packed(qkv, pad, seed, heads, hb,
                                               rate)
    out = kernel()
    torch.cuda.synchronize()
    ref = fa.flash_attention_packed_reference(qkv.float(), pad, seed, heads,
                                              hb, rate)
    err = (out.float() - ref).abs().max().item()
    check(math.isfinite(err) and err <= tol,
          f"{name}: kernel vs plain max abs err {err} > {tol}")
    rec = {"case": name, "b": b, "l": l, "heads": heads, "dh": dh,
           "dtype": str(dtype).replace("torch.", ""), "masked": masked,
           "rate": rate, "max_abs_err": err, "tol": tol}
    fns = None
    if timed:
        plain = lambda: fa.flash_attention_packed_reference(
            qkv, pad, seed, heads, hb, rate)
        # SDPA on the unpacked heads [B, H, L, dh] (layout change untimed)
        x = qkv.reshape(b, l, heads // hb, 3, hb, dh)
        q, k, v = (x[:, :, :, i].reshape(b, l, heads, dh).transpose(1, 2)
                   .contiguous() for i in range(3))
        attn_mask = None if pad is None else ~pad[:, None, None, :]
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=0.0)
        io_bytes, flops, walked, tiles = fwd_work(
            pad, b, l, heads, dh, qkv.element_size(), stats=False)
        bound_ms, bound_by = bound(io_bytes, flops)
        rec.update(
            ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, iters=3, warmup=1),
            library_ms=cuda_ms(library), bound_ms=bound_ms,
            bound_by=bound_by, io_bytes=io_bytes, flops=flops,
            key_tiles_walked_share=walked / tiles,
            sustained=sustained(kernel))
        fns = {"ms": kernel, "plain_ms": plain, "library_ms": library}
    log("kernel_check", **rec)
    return rec, fns


def phase_kernels():
    """Per-call checks and times, then one forward's worth of calls (24
    text + 12 ViT, back to back) timed as a whole for the kernel, the plain
    version and SDPA."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    text, text_fns = attention_case(
        "text", TEXT["b"], TEXT["l"], TEXT["heads"], TEXT["dh"], TEXT["hb"],
        True, 0.0, gen)
    vit, vit_fns = attention_case(
        "vit", VIT["b"], VIT["l"], VIT["heads"], VIT["dh"], VIT["hb"], False,
        0.0, gen)
    drop, _ = attention_case(
        "text_dropout_0.1", TEXT["b"], TEXT["l"], TEXT["heads"], TEXT["dh"],
        TEXT["hb"], True, 0.1, gen)
    attention_case("vit_fp32", 8, VIT["l"], VIT["heads"], VIT["dh"],
                   VIT["hb"], True, 0.0, gen, dtype=torch.float32,
                   tol=FP32_KERNEL_TOL, timed=False)
    attention_case("dh128_bf16", 4, 256, 6, 128, 3, True, 0.0, gen,
                   timed=False)

    def one_forward(key):
        def run():
            for _ in range(TEXT["calls"]):
                text_fns[key]()
            for _ in range(VIT["calls"]):
                vit_fns[key]()
        return run

    forward = {key: cuda_ms(one_forward(key), iters=iters, warmup=1)
               for key, iters in (("ms", 5), ("plain_ms", 2),
                                  ("library_ms", 5))}
    forward["bound_ms"] = (TEXT["calls"] * text["bound_ms"]
                           + VIT["calls"] * vit["bound_ms"])
    log("kernel_forward", calls=TEXT["calls"] + VIT["calls"], **forward)
    return (text, vit, drop), forward


def split_case(name, b, l, heads, dh, rate, gen, timed=True):
    """flash_attention forward and backward at one shape, bf16, masked
    (real lengths spread over [1, L] and one all-pad row)."""
    import torch
    import torch.nn.functional as F
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    d = heads * dh
    q, k, v, g = (torch.randn(b, l, d, generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    lens = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
    pad = torch.arange(l, device="cuda")[None, :] >= lens[:, None]
    pad[b // 2] = True
    seed = 1234 if rate > 0 else None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd = lambda: fa.flash_attention(*leaves, pad, seed, heads, rate)
    out = fwd()
    _, stats = fa._flash_fwd_cuda(q, k, v, pad, seed, heads, rate, True)
    bwd = lambda: fa.flash_attention_bwd(q, k, v, pad, seed, g, heads, rate,
                                         stats)
    grads = bwd()
    again = bwd()
    torch.cuda.synchronize()
    # the same inputs twice: the same gradients bit for bit
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{name}: two backward calls on the same inputs differ")
    del again
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), pad,
                                       seed, heads, rate)
    fwd_err = (out.float() - ref).abs().max().item()
    del ref
    want = fa.flash_attention_bwd_reference(q, k, v, pad, seed, g, heads,
                                            rate)
    bwd_abs = [(a.float() - w.float()).abs().max().item()
               for a, w in zip(grads, want)]
    bwd_err = max(e / w.float().abs().max().item()
                  for e, w in zip(bwd_abs, want))
    del want
    check(math.isfinite(fwd_err) and fwd_err <= KERNEL_TOL,
          f"{name}: forward vs plain max abs err {fwd_err} > {KERNEL_TOL}")
    check(math.isfinite(bwd_err) and bwd_err <= BWD_TOL,
          f"{name}: backward vs plain max rel err {bwd_err} > {BWD_TOL}")
    rec = {"case": name, "b": b, "l": l, "heads": heads, "dh": dh,
           "rate": rate, "fwd_max_abs_err": fwd_err,
           "bwd_max_abs_err": max(bwd_abs),
           "bwd_max_err_of_largest_grad": bwd_err,
           "bwd_bitwise_deterministic": True,
           "tol": [KERNEL_TOL, BWD_TOL]}
    fns = None
    if timed:
        el = q.element_size()
        fwd_bytes, fwd_flops, walked, tiles = fwd_work(pad, b, l, heads, dh,
                                                       el, stats=True)
        bwd_bytes, bwd_flops = bwd_work(b, l, heads, dh, el)
        plain_fwd = lambda: fa.flash_attention_reference(q, k, v, pad, seed,
                                                         heads, rate)
        plain_bwd = lambda: fa.flash_attention_bwd_reference(
            q, k, v, pad, seed, g, heads, rate)
        # SDPA on [B, H, L, dh] (layout change untimed) with the same
        # dropout rate; its mask stream differs, the work does not.  The
        # all-pad row keeps one key: SDPA gives NaN on a fully masked row.
        heads_first = lambda x: x.reshape(b, l, heads, dh).transpose(1, 2)
        sq, sk, sv = (heads_first(x).contiguous().requires_grad_()
                      for x in (q, k, v))
        sg = heads_first(g).contiguous()
        keep_keys = torch.arange(l, device="cuda")[None, :] < lens[:, None]
        attn_mask = keep_keys[:, None, None, :]
        lib_fwd = lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=attn_mask, dropout_p=rate)

        def lib_fwd_bwd():
            lib_fwd().backward(sg)

        fwd_bound, fwd_by = bound(fwd_bytes, fwd_flops)
        bwd_bound, bwd_by = bound(bwd_bytes, bwd_flops)
        lib_f = cuda_ms(lib_fwd)
        rec.update(
            fwd_ms=cuda_ms(fwd), fwd_plain_ms=cuda_ms(plain_fwd, 2, 1),
            fwd_library_ms=lib_f, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
            fwd_key_tiles_walked_share=walked / tiles,
            fwd_sustained=sustained(fwd),
            bwd_ms=cuda_ms(bwd), bwd_plain_ms=cuda_ms(plain_bwd, 2, 1),
            bwd_library_ms=cuda_ms(lib_fwd_bwd) - lib_f,
            bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by,
            bwd_sustained=sustained(bwd),
            fwd_io_bytes=fwd_bytes, bwd_io_bytes=bwd_bytes,
            fwd_flops=fwd_flops, bwd_flops=bwd_flops)
        fns = {"fwd": (fwd, plain_fwd, lib_fwd),
               "bwd": (bwd, plain_bwd, lib_fwd_bwd)}
    log("split_kernel_check", **rec)
    return rec, fns


def mask_read_back(b, l, heads, dh, rate, seed):
    """The keep mask read back through both training kernels at the text
    L and dh: with q = k = 0 every key weighs 1/L.  Forward, v one-hot over
    a chunk of dh keys: out[b, q, h*dh + j] = keep[b, h, q, c*dh + j] /
    (L (1 - r)).  Backward, dO one-hot over a chunk of dh query rows:
    dv[b, key, h*dh + j] = keep[b, h, c*dh + j, key] / (L (1 - r)).  Both
    must equal dropout_keep_mask_reference (the plain version, never the
    kernel #8), chunk by chunk."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    d = heads * dh
    z = torch.zeros(b, l, d, device="cuda", dtype=torch.bfloat16)
    want = fa.dropout_keep_mask_reference(seed, b, heads, l, l, rate,
                                          device="cuda")
    scale = l * (1.0 - rate)
    for c in range(l // dh):
        onehot = torch.zeros(b, l, heads, dh, device="cuda")
        onehot[:, c * dh:(c + 1) * dh] = torch.eye(dh, device="cuda")[
            :, None, :]
        onehot = onehot.reshape(b, l, d).bfloat16()
        vv = onehot.clone().requires_grad_()
        out = fa.flash_attention(z, z, vv, None, seed, heads, rate)
        got = out.float().reshape(b, l, heads, dh).permute(0, 2, 1, 3)
        check(torch.equal(got * scale > 0.5,
                          want[..., c * dh:(c + 1) * dh]),
              f"forward keep mask differs in key chunk {c}")
        out.backward(onehot)
        dv = vv.grad.float().reshape(b, l, heads, dh).permute(0, 2, 3, 1)
        check(torch.equal(dv * scale > 0.5,
                          want[:, :, c * dh:(c + 1) * dh, :]),
              f"backward keep mask differs in query chunk {c}")
    return int(want.numel())


def phase_split_kernels():
    """#2 and #3 at the text shape (rates 0.1 and 0), the mask read back
    through them, and one training step's calls of each (2 micro-batches x
    24) timed back to back for the kernel, the plain version and SDPA."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    main, fns = split_case("text_dropout_0.1", TEXT["b"], TEXT["l"],
                           TEXT["heads"], TEXT["dh"], 0.1, gen)
    rate0, _ = split_case("text_rate_0", TEXT["b"], TEXT["l"], TEXT["heads"],
                          TEXT["dh"], 0.0, gen)
    n_mask = mask_read_back(4, TEXT["l"], TEXT["heads"], TEXT["dh"], 0.1, 99)
    log("split_mask_read_back", elements=n_mask, equal=True)

    n_calls = STEP_MICRO_BATCHES * TEXT["calls"]

    def calls(fn):
        def run():
            for _ in range(n_calls):
                fn()
        return run

    per_step = {}
    for side in ("fwd", "bwd"):
        kernel, plain, library = fns[side]
        lib = cuda_ms(calls(library), iters=3, warmup=1)
        if side == "bwd":     # SDPA backward = forward + backward - forward
            lib -= per_step["fwd"]["library_ms"]
        per_step[side] = {"ms": cuda_ms(calls(kernel), iters=3, warmup=1),
                          "plain_ms": cuda_ms(calls(plain), iters=1,
                                              warmup=1),
                          "library_ms": lib,
                          "bound_ms": n_calls * main[f"{side}_bound_ms"]}
    log("split_kernel_step", calls=n_calls, **per_step)
    torch.cuda.empty_cache()
    return main, rate0, per_step


def phase_lora_kernels():
    """#4, #5 and #6 at the main path's shape (M = 49152 rows, D = 768,
    r = 8, bf16, rate 0.1) against their plain versions, per call and for
    one training step's calls back to back; two calls of each give the
    same bits; the keep mask read back through #6 with dt @ A^T = 1 in
    every entry, and the dropped input keep⊙h·inv bit for bit through #4
    (a one-hot A: 8 columns a call, all D) and #5 (one-hot dt rows: 8 rows
    a call, 512 rows); each kernel's device time (torch.profiler) and the
    host's time to enqueue a call beside the events' per-call time;
    torch.matmul(h, A)'s time on a line of its own, as context (not the
    same function: no mask, no scale)."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as ld
    m, d, r, rate = LORA["m"], LORA["d"], LORA["r"], LORA["rate"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
    a = (0.05 * torch.randn(d, r, generator=gen, device="cuda")).bfloat16()
    dt = torch.randn(m, r, generator=gen, device="cuda").bfloat16()
    seed = 1234567
    el = h.element_size()
    cases = {
        "lora_dropout_fwd": (lambda: ld.lora_dropout_fwd(h, a, seed, rate),
                             lambda: ld.lora_dropout_fwd_reference(
                                 h, a, seed, rate),
                             (m * d + d * r + m * r) * el),
        "lora_dropout_da": (lambda: ld.lora_dropout_da(h, dt, seed, rate),
                            lambda: ld.lora_dropout_da_reference(
                                h, dt, seed, rate),
                            (m * d + m * r + d * r) * el),
        "lora_dropout_dh": (lambda: ld.lora_dropout_dh(dt, a, seed, rate),
                            lambda: ld.lora_dropout_dh_reference(
                                dt, a, seed, rate),
                            (m * r + d * r + m * d) * el),
    }
    flops = 2 * m * d * r
    recs = {}
    for name, (kernel, plain, nbytes) in cases.items():
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name}: two calls differ")
        del again
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        check(math.isfinite(err) and err <= LORA_TOL * top,
              f"{name}: kernel vs plain max abs err {err} > {LORA_TOL} x "
              f"{top}")
        bound_ms, bound_by = bound(nbytes, flops)
        recs[name] = {"max_abs_err": err, "err_of_largest": err / top,
                      "ms": cuda_ms(kernel), "host_ms": host_ms(kernel),
                      "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "io_bytes": nbytes, "flops": flops,
                      "two_calls_equal": True}
        del got, want
    log("lora_kernels", m=m, d=d, r=r, rate=rate, tol=LORA_TOL,
        library_ms=None, library_reason="no single PyTorch call computes "
        "the masked thin product or its gradients", **recs)
    # device time a call of each kernel the wrappers launch (#5: the
    # partial sums and the reduction over them), from torch.profiler
    _, _, _, top = profiled(lambda: [fn() for fn, _, _ in cases.values()
                                     for _ in range(10)])
    log("lora_kernel_device_us", per_call={k: 1e3 * ms / 10
                                           for k, ms in top})
    for name in cases:
        recs[name]["device_ms"] = sum(ms for k, ms in top
                                      if kind_of(k) == name) / 10
    log("lora_matmul_context", ms=cuda_ms(lambda: torch.matmul(h, a)),
        what="torch.matmul(h, A) on the same h and A: no mask and no "
        "scale, so not the same function and not library_ms; context only")

    # the dropped input through #4 (t = x @ A, A one-hot: 8 columns of x
    # exactly) and #5 (dA = x^T @ dt, dt one-hot rows: 8 rows of x)
    x = ld._dropped(h, seed, rate)
    cols = torch.arange(r, device="cuda")
    for k in range(0, d, r):
        onehot = torch.zeros_like(a)
        onehot[k + cols, cols] = 1.0
        check(torch.equal(ld.lora_dropout_fwd(h, onehot, seed, rate),
                          x[:, k:k + r]),
              f"lora_dropout_fwd: columns {k}..{k + r} differ from the "
              "dropped input")
    rows = torch.cat([torch.tensor([0, 1, 15, 16, m - 2, m - 1]),
                      torch.randperm(m, generator=torch.Generator()
                                     .manual_seed(0))[:512 - 6]]).cuda()
    for k in range(0, len(rows), r):
        onehot = torch.zeros_like(dt)
        onehot[rows[k:k + r], cols] = 1.0
        check(torch.equal(ld.lora_dropout_da(h, onehot, seed, rate).t(),
                          x[rows[k:k + r]]),
              f"lora_dropout_da: rows {rows[k:k + r].tolist()} differ from "
              "the dropped input")
    torch.cuda.synchronize()
    log("lora_dropped_read_back", fwd_elements=int(x.numel()),
        da_rows=int(len(rows)), equal=True)
    del x

    # the keep mask through #6: dh = keep / (1 - rate) where dt @ A^T = 1
    dh = ld.lora_dropout_dh(torch.ones_like(dt),
                            torch.full_like(a, 1.0 / r), seed, rate)
    want = ld.hash_keep_mask((m, d), seed, rate, "cuda")
    check(torch.equal(dh.float() * (1.0 - rate) > 0.5, want),
          "lora_dropout_dh keep mask differs from hash_keep_mask")
    log("lora_mask_read_back", elements=int(want.numel()), equal=True)
    del dh, want

    per_step = {}
    launches = expected_launches(train_config())
    for name, (kernel, plain, _) in cases.items():
        n = launches[name]

        def calls(fn, n=n):
            def run():
                for _ in range(n):
                    fn()
            return run
        per_step[name] = {"calls": n,
                          "ms": cuda_ms(calls(kernel), iters=3, warmup=1),
                          "plain_ms": cuda_ms(calls(plain), iters=1,
                                              warmup=1),
                          "bound_ms": n * recs[name]["bound_ms"]}
    log("lora_kernel_step", **per_step)
    del h, a, dt
    torch.cuda.empty_cache()
    return recs, per_step


def packed_bwd_case(name, b, l, heads, dh, hb, masked, rate, gen,
                    timed=True):
    """#7 at one shape against flash_attention_packed_bwd_reference on the
    same bf16 inputs; the forward instantiation that stores the statistics
    gives the serving one's output bit for bit."""
    import torch
    import torch.nn.functional as F
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    d = heads * dh
    qkv = torch.randn(b, l, 3 * d, generator=gen, device="cuda").bfloat16()
    g = torch.randn(b, l, d, generator=gen, device="cuda").bfloat16()
    pad = None
    if masked:
        lens = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
        pad = torch.arange(l, device="cuda")[None, :] >= lens[:, None]
        pad[b // 2] = True
    seed = 4321 if rate > 0 else None
    out, stats = fa._packed_fwd_cuda(qkv, pad, seed, heads, hb, rate, True)
    serving = fa.flash_attention_packed(qkv, pad, seed, heads, hb, rate)
    check(torch.equal(out, serving),
          f"{name}: the statistics instantiation's output differs")
    kernel = lambda: fa.flash_attention_packed_bwd(qkv, pad, seed, g, heads,
                                                   hb, rate, stats)
    got = kernel()
    check(torch.equal(got, kernel()),
          f"{name}: two backward calls on the same inputs differ")
    torch.cuda.synchronize()
    want = fa.flash_attention_packed_bwd_reference(qkv, pad, seed, g, heads,
                                                   hb, rate)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    check(math.isfinite(rel) and rel <= BWD_TOL,
          f"{name}: packed backward vs plain max rel err {rel} > {BWD_TOL}")
    rec = {"case": name, "b": b, "l": l, "heads": heads, "dh": dh,
           "masked": masked, "rate": rate, "max_abs_err": err,
           "max_err_of_largest_grad": rel, "bitwise_deterministic": True,
           "tol": BWD_TOL}
    del got, want
    fns = None
    if timed:
        el = qkv.element_size()
        nbytes = (7 * b * l * d * el + b * heads * l * 8
                  + (b * l if masked else 0))
        flops = 10 * b * l * l * d
        plain = lambda: fa.flash_attention_packed_bwd_reference(
            qkv, pad, seed, g, heads, hb, rate)
        # SDPA on the unpacked heads [B, H, L, dh] (layout change untimed)
        x = qkv.reshape(b, l, heads // hb, 3, hb, dh)
        sq, sk, sv = (x[:, :, :, i].reshape(b, l, heads, dh).transpose(1, 2)
                      .contiguous().requires_grad_() for i in range(3))
        sg = g.reshape(b, l, heads, dh).transpose(1, 2).contiguous()
        lib_fwd = lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                         dropout_p=rate)

        def lib_fwd_bwd():
            lib_fwd().backward(sg)
        bound_ms, bound_by = bound(nbytes, flops)
        lib_f = cuda_ms(lib_fwd)
        rec.update(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, 2, 1),
                   library_ms=cuda_ms(lib_fwd_bwd) - lib_f,
                   sustained=sustained(kernel),
                   bound_ms=bound_ms, bound_by=bound_by, io_bytes=nbytes,
                   flops=flops,
                   fwd_serving_ms=cuda_ms(lambda: fa.flash_attention_packed(
                       qkv, pad, seed, heads, hb, rate)),
                   fwd_stats_ms=cuda_ms(lambda: fa._packed_fwd_cuda(
                       qkv, pad, seed, heads, hb, rate, True)))
        fns = (kernel, plain, lib_fwd_bwd, lib_fwd)
    log("packed_bwd_kernel", **rec)
    return rec, fns


def phase_packed_bwd_kernel():
    """#7 at HoME's ViT shape (B = 64, L = 197, rate 0, no mask), timed, and
    at the text shape masked at rate 0.1; then one HoME step's calls (2
    layers x 2 micro-batches) back to back."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    vit, fns = packed_bwd_case("vit", VIT["b"], VIT["l"], VIT["heads"],
                               VIT["dh"], VIT["hb"], False, 0.0, gen)
    text, _ = packed_bwd_case("text_dropout_0.1", TEXT["b"], TEXT["l"],
                              TEXT["heads"], TEXT["dh"], TEXT["hb"], True,
                              0.1, gen, timed=False)
    n = expected_launches(home_config())["flash_attention_packed_bwd"]
    kernel, plain, lib_fwd_bwd, lib_fwd = fns

    def calls(fn):
        def run():
            for _ in range(n):
                fn()
        return run
    step = {"calls": n, "ms": cuda_ms(calls(kernel), iters=5, warmup=1),
            "plain_ms": cuda_ms(calls(plain), iters=1, warmup=1),
            "library_ms": (cuda_ms(calls(lib_fwd_bwd), iters=5, warmup=1)
                           - cuda_ms(calls(lib_fwd), iters=5, warmup=1)),
            "bound_ms": n * vit["bound_ms"]}
    log("packed_bwd_kernel_step", **step)
    torch.cuda.empty_cache()
    return vit, text, step


# ---------------------------------------------------------------------------
# phase 4: the full-width Predictor
# ---------------------------------------------------------------------------

_WORDS = ("the tent kept us dry through two nights of heavy rain and the "
          "poles held up well in strong wind but the zipper on the rain fly "
          "started to snag after a week of use so i would buy it again only "
          "at a lower price great value for car camping with kids").split()


def synthetic_texts(rng, n, min_sents, max_sents):
    texts = []
    for _ in range(n):
        sents = []
        for _ in range(rng.integers(min_sents, max_sents + 1)):
            words = rng.choice(_WORDS, size=rng.integers(6, 24))
            sents.append(" ".join(words).capitalize() + ".")
        texts.append(" ".join(sents))
    return texts


def serving_config(batch: int):
    from mmoe_multimodal_rec_tpu_torch.config import Config
    cfg = Config()      # BERT-base x2, ViT-base, bf16 compute, fp32 params
    cfg.train.batch_size = batch
    cfg.model.packer.chunk_budget = 2 * batch    # 2 chunks per sample
    cfg.data.allow_hash_tokenizer = True
    return cfg


def small_config():
    """fp32 model whose text and ViT attention take the kernel: hidden
    128, 2 heads (dh 64), 128-token chunks."""
    from mmoe_multimodal_rec_tpu_torch.config import tiny_config
    cfg = tiny_config(batch_size=4)
    m = cfg.model
    m.use_flash_attention = True
    m.text.hidden_size = m.image.hidden_size = 128
    m.text.num_heads = m.image.num_heads = 2
    m.text.intermediate_size = m.image.intermediate_size = 256
    m.text.max_position_embeddings = 128
    m.packer.max_tok = 128
    return cfg


def kind_of(kernel_name: str) -> str:
    """The port's kernels by wrapper (the attention kernels' first template
    flag tells split from packed), then matrix products, then the rest."""
    low = kernel_name.lower()
    for kernel, kind in (("keep_mask_kernel", "dropout_keep_mask"),
                         ("lora_fwd", "lora_dropout_fwd"),
                         ("lora_da", "lora_dropout_da"),
                         ("lora_dh", "lora_dropout_dh")):
        if kernel in low:
            return kind
    if "attention_bwd" in low:
        return ("flash_attention_packed_bwd"
                if re.search(r"_bf16<\d+, true>", low)
                else "flash_attention_bwd")
    if "attention_fwd" in low:
        return ("flash_attention" if re.search(r"_bf16<\d+, true", low)
                else "flash_attention_packed")
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "matmul"
    return "other"


def profiled(fn):
    """Run fn() under torch.profiler: its result, device ms by kind and the
    top kernels, summed over the window, and the window's host-clock ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel, by_kind = {}, {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
        kind = kind_of(evt.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return outs, window_ms, by_kind, top


def phase_predictor(batch: int, forwards: int, profiled_forwards: int):
    """The main path: warm-up, `forwards` requests timed on the host clock,
    then `profiled_forwards` requests under torch.profiler, whose device
    time by kind gives the attention kernel's ms per forward and the
    device's busy share, and whose attention inputs give its bound per
    forward and the share of key tiles it walked."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.eval.predict import Predictor
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    cfg = serving_config(batch)
    t0 = time.perf_counter()
    pred = Predictor(cfg, batch_size=batch, device="cuda")
    init_s = time.perf_counter() - t0
    batches = []
    for _ in range(forwards + profiled_forwards):
        users = synthetic_texts(rng, batch, 8, 30)
        items = synthetic_texts(rng, batch, 4, 16)
        patches = rng.integers(0, 256, (batch, 196, 768), dtype=np.uint8)
        has_image = (rng.random(batch) < 0.8).astype(np.int32)
        batches.append((users, items, patches, has_image))

    # the main path: counts from 0, warmup + scored batches, counts read
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pred.warmup()
    request_ms, pack_ms, outs = [], [], []
    budget = cfg.model.packer.chunk_budget
    for users, items, patches, has_image in batches[:forwards]:
        t0 = time.perf_counter()
        outs.append(pred.predict(users, items, patches, has_image))
        request_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()    # the host part alone: both text sides
        pred.packer.pack(users, budget)
        pred.packer.pack(items, budget)
        pack_ms.append(1e3 * (time.perf_counter() - t0))
    with attention_calls() as seen:
        prof_outs, window_ms, by_kind, top = profiled(
            lambda: [pred.predict(*batch) for batch in batches[forwards:]])
    outs += prof_outs
    counts = read_launches()
    in_path = in_path_bounds(seen["flash_attention_packed"],
                             profiled_forwards)
    check(in_path["calls"] == 36 and not seen["flash_attention"],
          f"the profiled forwards made {in_path['calls']} packed attention "
          f"calls a forward, expected 36, and "
          f"{len(seen['flash_attention'])} split ones")
    launches = counts.pop("flash_attention_packed")
    peak = torch.cuda.max_memory_allocated()
    n_fwd = forwards + profiled_forwards + len(pred.buckets)
    kernel_ms = by_kind.get("flash_attention_packed", 0.0) / profiled_forwards
    check(kernel_ms > 0, "the profiler saw no attention kernel time")
    device_ms = sum(by_kind.values())
    log("profile", requests=profiled_forwards, window_ms=window_ms,
        device_ms_per_request=device_ms / profiled_forwards,
        device_busy_share=device_ms / window_ms,
        device_ms_per_request_by_kind={
            k: v / profiled_forwards for k, v in by_kind.items()},
        top_kernels_ms_per_request=[(k, v / profiled_forwards)
                                    for k, v in top],
        attention_inputs_per_request=in_path)
    check(launches == 36 * n_fwd,
          f"flash_attention_packed launched {launches} times in {n_fwd} "
          f"forwards, expected 36 per forward")
    check(not any(counts.values()),
          f"serving launched a training kernel: {counts}")
    for out in outs:
        for key in ("prob_good", "prob_best"):
            p = out[key]
            check(p.shape == (batch,) and np.all(np.isfinite(p))
                  and np.all((p > 0) & (p < 1)), f"bad {key}: {p}")

    # the same seeded model on the plain attention path
    cfg_plain = serving_config(batch)
    cfg_plain.model.use_flash_attention = False
    plain = Predictor(cfg_plain, batch_size=batch, device="cuda")
    fa.flash_attention_packed.launches = 0
    users, items, patches, has_image = batches[0]
    ref = plain.predict(users, items, patches, has_image)
    check(fa.flash_attention_packed.launches == 0,
          "the plain-attention model launched the kernel")
    plain_err = max(float(np.abs(outs[0][k] - ref[k]).max())
                    for k in ("prob_good", "prob_best"))
    check(plain_err <= PLAIN_PATH_TOL,
          f"kernel path vs plain path: max prob diff {plain_err}")
    del plain

    # small fp32 model: GPU (kernel) vs CPU (plain version)
    small = small_config()
    texts = synthetic_texts(rng, 4, 4, 20), synthetic_texts(rng, 4, 2, 8)
    p_small = rng.integers(0, 256, (4, 196, 768), dtype=np.uint8)
    h_small = np.array([1, 0, 1, 1], np.int32)
    before = fa.flash_attention_packed.launches
    gpu = Predictor(small, device="cuda").predict(*texts, p_small, h_small)
    check(fa.flash_attention_packed.launches > before,
          "small model did not take the kernel")
    cpu = Predictor(small, device="cpu").predict(*texts, p_small, h_small)
    small_err = max(float(np.abs(gpu[k] - cpu[k]).max())
                    for k in ("prob_good", "prob_best"))
    check(small_err <= SMALL_CPU_TOL,
          f"small fp32 model GPU vs CPU: max prob diff {small_err}")

    log("predictor", batch=batch, forwards=n_fwd, launches=launches,
        launches_per_forward=launches / n_fwd, init_s=init_s,
        request_ms=request_ms, host_pack_ms=pack_ms, peak_bytes=peak,
        kernel_ms_per_forward=kernel_ms,
        kernel_bound_ms_per_forward=in_path["fwd"]["bound_ms"],
        kernel_vs_plain_path_max_prob_diff=plain_err,
        small_fp32_gpu_vs_cpu_max_prob_diff=small_err,
        prob_good_mean=float(np.mean([o["prob_good"] for o in outs])))
    return pred, launches, {"ms": kernel_ms, **in_path["fwd"]}


# ---------------------------------------------------------------------------
# phase 5: the HTTP server
# ---------------------------------------------------------------------------

def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/predict", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def phase_server(pred, n_requests: int = 6, per_request: int = 5):
    from mmoe_multimodal_rec_tpu_torch.eval.server import PredictionServer
    rng = np.random.default_rng(1)
    requests = []
    for r in range(n_requests):
        users = synthetic_texts(rng, per_request, 3, 12)
        items = synthetic_texts(rng, per_request, 2, 6)
        patches = [rng.integers(0, 256, (196, 768), dtype=np.uint8)
                   if (r + j) % 2 else None for j in range(per_request)]
        requests.append((users, items, patches))
    srv = PredictionServer(pred, host="127.0.0.1", port=0, max_wait_ms=5.0,
                           model_info={"variant": "baseline", "step": 0})
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    results = {}
    try:
        def post(r):
            users, items, patches = requests[r]
            insts = []
            for u, i, p in zip(users, items, patches):
                inst = {"user_text": u, "item_text": i}
                if p is not None:
                    inst["patch_b64"] = base64.b64encode(p.tobytes()).decode()
                insts.append(inst)
            t0 = time.perf_counter()
            results[r] = _post(srv.port, {"instances": insts}) + (
                1e3 * (time.perf_counter() - t0),)

        threads = [threading.Thread(target=post, args=(r,))
                   for r in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "a request did not return")
        stats = srv.stats()
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    worst = 0.0
    for r, (users, items, patches) in enumerate(requests):
        code, out, _ = results[r]
        check(code == 200, f"request {r}: HTTP {code} {out}")
        direct = pred.predict(
            users, items,
            np.stack([p if p is not None else np.zeros((196, 768), np.uint8)
                      for p in patches]),
            np.array([int(p is not None) for p in patches], np.int32))
        for j, got in enumerate(out["predictions"]):
            for key in ("prob_good", "prob_best"):
                worst = max(worst, abs(got[key] - float(direct[key][j])))
    check(worst <= SERVER_TOL, f"server vs direct predict: {worst}")
    log("server", requests=n_requests, instances=n_requests * per_request,
        device_batches=stats["device_batches"],
        request_ms=[results[r][2] for r in range(n_requests)],
        max_prob_diff_vs_direct=worst)


# ---------------------------------------------------------------------------
# phases 6 and 7: training
# ---------------------------------------------------------------------------

def train_config(text_layers: int = 12):
    """bench.py --mode train's shape (micro-batch 64, grad_accum 2, 2
    chunks per sample) on the defaults (BERT-base x2 with LoRA r=8 on
    query/value and the fused LoRA dropout, ViT-base, bf16 compute, fp32
    params, dropout 0.1), no remat."""
    from mmoe_multimodal_rec_tpu_torch.config import Config
    cfg = Config()
    cfg.train.batch_size = 64
    cfg.train.optim.grad_accum = 2
    cfg.model.packer.chunk_budget = 128
    cfg.model.text.num_layers = text_layers
    return cfg


def home_config(text_layers: int = 12):
    """The same shape on the HoME model (bench.py's "HoME train")."""
    cfg = train_config(text_layers)
    cfg.model.variant = "home"
    return cfg


def expected_launches(cfg):
    """Kernel launches per optimizer step, from the configuration.  Each
    micro-batch runs every ViT layer's self-attention through #1 (the
    instantiation that stores the softmax statistics where the layer needs
    a gradient: HoME's last two, which #7 then runs backward through),
    every text layer's of both encoders through #2 and #3, and every LoRA
    site (the targets of every text layer of both encoders) through #4
    and #5 and, where its input needs a gradient, #6: every layer but the
    first, whose input comes from frozen embeddings and LayerNorm.  The
    short attentions that stay plain torch draw their dropout mask through
    #8: the sentence cross expert's self-attention blocks (cross_layers a
    side) and its cross attention, and the two fuse experts' blocks."""
    m = cfg.model
    accum = cfg.train.optim.grad_accum
    text = 2 * m.text.num_layers
    sites = len(m.text.lora_targets)
    fine_tuned = 2 if m.variant == "home" else 0
    short = (2 * m.cross_layers + 1 + 2 * m.fuse_depth
             if m.dropout > 0 else 0)
    return {"flash_attention_packed": accum * m.image.num_layers,
            "flash_attention_packed_stats": accum * fine_tuned,
            "flash_attention_packed_bwd": accum * fine_tuned,
            "flash_attention": accum * text,
            "flash_attention_bwd": accum * text,
            "lora_dropout_fwd": accum * text * sites,
            "lora_dropout_da": accum * text * sites,
            "lora_dropout_dh": accum * (text - 2) * sites,
            "dropout_keep_mask": accum * short}


def kernel_wrappers():
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    from mmoe_multimodal_rec_tpu_torch.ops import lora_dropout as ld
    return {"flash_attention_packed": fa.flash_attention_packed,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "lora_dropout_fwd": ld.lora_dropout_fwd,
            "lora_dropout_da": ld.lora_dropout_da,
            "lora_dropout_dh": ld.lora_dropout_dh,
            "flash_attention_packed_bwd": fa.flash_attention_packed_bwd,
            "dropout_keep_mask": fa.dropout_keep_mask}


def reset_launches() -> None:
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    fa.flash_attention_packed.stats_launches = 0


def read_launches():
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    out = {k: w.launches for k, w in kernel_wrappers().items()}
    out["flash_attention_packed_stats"] = \
        fa.flash_attention_packed.stats_launches
    return out


@contextlib.contextmanager
def plain_masks_on_card():
    """Counts the calls of dropout_keep_mask_reference on a CUDA device
    while the block runs (a list, one entry a call)."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    calls, plain = [], fa.dropout_keep_mask_reference

    def spy(*args, **kw):
        device = kw.get("device", args[7] if len(args) > 7 else "cpu")
        if torch.device(device).type == "cuda":
            calls.append(args[1:5])
        return plain(*args, **kw)
    fa.dropout_keep_mask_reference = spy
    try:
        yield calls
    finally:
        fa.dropout_keep_mask_reference = plain


@contextlib.contextmanager
def attention_calls():
    """The model's attention forward calls while the block runs, by
    wrapper (`flash_attention_packed`, `flash_attention`): (batch, L, heads,
    dh, pad mask, statistics stored, element size) a call.  The pad masks
    are kept, not copied (a forward makes its own), and read after the
    block, so that the block's device work is the model's alone."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.models import layers
    calls = {"flash_attention_packed": [], "flash_attention": []}
    real = {name: getattr(layers, name) for name in calls}

    def packed(qkv, pad_mask, seed, n_heads, *rest):
        b, l, d3 = qkv.shape
        calls["flash_attention_packed"].append(
            (b, l, n_heads, d3 // 3 // n_heads, pad_mask,
             qkv.requires_grad and torch.is_grad_enabled(),
             qkv.element_size()))
        return real["flash_attention_packed"](qkv, pad_mask, seed, n_heads,
                                              *rest)

    def split(q, k, v, pad_mask, seed, n_heads, *rest):
        b, l, d = q.shape
        calls["flash_attention"].append(
            (b, l, n_heads, d // n_heads, pad_mask,
             torch.is_grad_enabled() and any(x.requires_grad
                                             for x in (q, k, v)),
             q.element_size()))
        return real["flash_attention"](q, k, v, pad_mask, seed, n_heads,
                                       *rest)
    layers.flash_attention_packed, layers.flash_attention = packed, split
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(layers, name, fn)


def in_path_bounds(calls, per: int, backward: bool = False):
    """The bound of recorded attention calls (attention_calls), per forward
    or step (`per`): the sum of each call's bound from its own inputs, what
    bounds the whole, and the share of key tiles the forward walks; with
    `backward`, also the split backward's bound over the same calls."""
    out = {"calls": len(calls) / per}
    sides = ("fwd", "bwd") if backward else ("fwd",)
    for side in sides:
        ms = nbytes = flops = walked = tiles = 0
        for b, l, heads, dh, pad, stats, el in calls:
            if side == "fwd":
                nb, fl, w, t = fwd_work(pad, b, l, heads, dh, el, stats)
                walked, tiles = walked + w, tiles + t
            else:
                nb, fl = bwd_work(b, l, heads, dh, el)
            ms += bound(nb, fl)[0]
            nbytes, flops = nbytes + nb, flops + fl
        out[side] = {"bound_ms": ms / per,
                     "bound_by": bound(nbytes, flops)[1]}
        if side == "fwd":
            out[side]["key_tiles_walked_share"] = walked / max(tiles, 1)
    return out


def random_batch(cfg, seed: int):
    """bench.py's random_batch: random token ids in every chunk, ~8
    sentences per sample routed into its 2 chunks, random patches, 80% with
    an image, labels at 0.5 / 0.3."""
    from mmoe_multimodal_rec_tpu_torch.train.loop import dummy_batch
    b = cfg.train.batch_size
    n = cfg.model.packer.chunk_budget
    L = cfg.model.packer.max_tok
    r = np.random.default_rng(seed)
    batch = dummy_batch(cfg, batch_size=b)
    for side in ("user", "item"):
        batch[f"{side}_tokens"] = r.integers(
            999, 30000, (n, L)).astype(np.int32)
        chunks = (np.arange(b) * (n // b))[:, None] + \
            r.integers(0, max(n // b, 1), (b, 8))
        batch[f"{side}_sent_chunk"][:, :8] = chunks.astype(np.int32)
        batch[f"{side}_sent_tok"][:, :8] = r.integers(
            1, L - 1, (b, 8)).astype(np.int32)
    batch["patches"] = r.integers(0, 256, (b, 196, 768)).astype(np.uint8)
    batch["has_image"] = (r.random(b) < 0.8).astype(np.int32)
    batch["label_good"] = (r.random(b) < 0.5).astype(np.float32)
    batch["label_best"] = (r.random(b) < 0.3).astype(np.float32)
    return batch


def stacked(cfg, trainer, seed: int):
    """The batch repeated over grad_accum, staged on the card once."""
    accum = cfg.train.optim.grad_accum
    return trainer.to_device({k: np.broadcast_to(v, (accum,) + v.shape)
                              for k, v in random_batch(cfg, seed).items()})


def drive_trainer(cfg, timed_steps: int = 3, keep=None):
    """A training main path: a Trainer on the card, the batch staged once,
    counts from 0, 1 warm-up step, `timed_steps` on the host clock, 1 step
    under torch.profiler, counts read.  Checks the launches per step
    against `expected_launches`, finite losses and no skipped
    micro-batch.  Returns (trainer, batch, run record, profile record,
    copies taken before the first step of the trainable parameters that
    `keep` names)."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    init_s = time.perf_counter() - t0
    kept = {k: p.detach().clone() for k, p in trainer.trainable.items()
            if keep is not None and keep(k)}
    batch = stacked(cfg, trainer, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with plain_masks_on_card() as plain_masks:
        t0 = time.perf_counter()
        metrics = [trainer.run_step(batch)]
        warm_s = time.perf_counter() - t0
        step_ms = []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            metrics.append(trainer.run_step(batch))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        with attention_calls() as seen:
            prof_m, window_ms, by_kind, top = profiled(
                lambda: trainer.run_step(batch))
    metrics.append(prof_m)
    launches = read_launches()
    check(not plain_masks, f"the plain keep mask ran on the card in the "
                           f"steps: {plain_masks[:3]}")
    peak = torch.cuda.max_memory_allocated()
    steps = len(metrics)
    for m in metrics:
        check(math.isfinite(m["loss"]) and m["skipped_micro"] == 0,
              f"{cfg.model.variant} step: {m}")
    check(trainer.step == steps, f"{trainer.step} optimizer steps, "
                                 f"expected {steps}")
    per_step = {k: n / steps for k, n in launches.items()}
    want = expected_launches(cfg)
    check(per_step == want, f"launches per step {per_step}, expected {want}")
    for kind, n in want.items():
        if n and kind != "flash_attention_packed_stats":
            check(by_kind.get(kind, 0.0) > 0,
                  f"no device time of {kind} in the profiled step")
    device_ms = sum(by_kind.values())
    inputs = {"flash_attention_packed":
              in_path_bounds(seen["flash_attention_packed"], 1),
              "flash_attention":
              in_path_bounds(seen["flash_attention"], 1, backward=True)}
    for wrapper, rec in inputs.items():
        check(rec["calls"] == want[wrapper], f"the profiled step made "
              f"{rec['calls']} {wrapper} calls, expected {want[wrapper]}")
    examples = cfg.train.batch_size * cfg.train.optim.grad_accum
    run = {"examples_per_step": examples, "steps": steps, "init_s": init_s,
           "warmup_step_s": warm_s, "step_ms": step_ms,
           "examples_per_sec": examples / (sorted(step_ms)[len(step_ms) // 2]
                                           / 1e3),
           "peak_bytes": peak, "launches": launches,
           "launches_per_step": per_step,
           "plain_keep_masks_on_card": len(plain_masks),
           "losses": [m["loss"] for m in metrics],
           "main_losses": [m["main_loss"] for m in metrics],
           "contrastive_losses": [m["contrastive_loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics]}
    prof = {"window_ms": window_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / window_ms,
            "device_ms_by_kind": by_kind, "top_kernels_ms": top,
            "attention_inputs": inputs}
    return trainer, batch, run, prof, kept


def save_checkpoint(trainer, name: str) -> str:
    """The trainer's state through CheckpointManager into _smoke_work/."""
    from mmoe_multimodal_rec_tpu_torch.train.checkpoint import (
        CheckpointManager)
    directory = os.path.join(WORK, name)
    t0 = time.perf_counter()
    CheckpointManager(directory).save(trainer.host_step, trainer)
    log("checkpoint", directory=os.path.relpath(directory, REPO),
        step=trainer.host_step, seconds=time.perf_counter() - t0,
        bytes=sum(os.path.getsize(os.path.join(directory, f))
                  for f in os.listdir(directory)))
    return directory


def phase_train(timed_steps: int = 3):
    """The baseline training main path at the default configuration; its
    trainer's checkpoint for the eval phase."""
    import torch
    trainer, batch, run, prof, _ = drive_trainer(train_config(),
                                                 timed_steps)
    for loss in run["losses"]:
        check(TRAIN_LOSS_RANGE[0] < loss < TRAIN_LOSS_RANGE[1],
              f"train loss {loss}")
    log("train", **run)
    log("train_profile", **prof)
    ckpt = save_checkpoint(trainer, "ckpt_baseline")
    del trainer, batch
    torch.cuda.empty_cache()
    return run["launches"], prof, ckpt


def check_trainer(cfg, device: str):
    """A Trainer whose LoRA B is seeded non-zero, so that every LoRA
    gradient is non-trivial, and its LoRA parameters by name."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
    trainer = Trainer(cfg, device=device)
    gen = torch.Generator().manual_seed(7)
    lora = {k: p for k, p in trainer.trainable.items() if "lora_" in k}
    with torch.no_grad():
        for k, p in lora.items():
            if k.endswith("lora_b"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    return trainer, lora


def micro_grads(trainer, params, micro):
    """One micro-batch's loss (HoME's contrastive terms included), in
    training mode with step 0's first dropout stream, and its gradients of
    `params` (name -> parameter)."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.train.losses import total_loss
    from mmoe_multimodal_rec_tpu_torch.train.loop import dropout_generator
    cfg = trainer.cfg
    out = trainer.model(micro, deterministic=False,
                        rng=dropout_generator(cfg.train.seed + 1, 0, 0))
    loss = total_loss(out.logit_good, out.logit_best, micro["label_good"],
                      micro["label_best"], cfg.train.loss, aux=out.aux,
                      home=cfg.model.variant == "home").total
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


def grad_gaps(got, want):
    """The largest, over tensors, of max |dg| / max |g| and of
    ||dg|| / ||g||, and the names of the tensors they come from."""
    gaps = {k: ((got[k].float() - w).abs().max().item() / w.abs().max().item(),
                (got[k].float() - w).norm().item() / w.norm().item())
            for k, w in ((k, v.float()) for k, v in want.items())}
    worst = [max(gaps, key=lambda k, i=i: gaps[k][i]) for i in (0, 1)]
    return gaps[worst[0]][0], gaps[worst[1]][1], worst


def compare_paths(phase, cfgs, select, counter, tol):
    """One micro-batch's loss and gradients of the trainable parameters
    that `select` names, then one whole step, on each of two
    configurations (the kernel path first) from the same weights, batch and
    seeds; their gaps against `tol` (loss, grad_norm, max and L2 gradient
    gaps).  The first must launch the `counter` wrapper's kernel and the
    second must not."""
    import torch
    runs = []
    for cfg in cfgs:
        trainer, _ = check_trainer(cfg, "cuda")
        params = {k: p for k, p in trainer.trainable.items() if select(k)}
        batch = stacked(cfg, trainer, seed=1)
        wrapper = kernel_wrappers()[counter]
        before = wrapper.launches
        loss, grads = micro_grads(trainer, params,
                                  {k: v[0] for k, v in batch.items()})
        step = trainer.run_step(batch)
        runs.append((loss, grads, step, wrapper.launches - before))
        del trainer, params, batch
        torch.cuda.empty_cache()
    (lk, gk, sk, nk), (lp, gp, sp, np_) = runs
    check(nk > 0 and np_ == 0, f"{phase}: {counter} launches {nk} / {np_}")
    check(sk["skipped_micro"] == sp["skipped_micro"] == 0,
          f"{phase}: skipped micro-batches")
    grad_gap, grad_gap_l2, worst = grad_gaps(gk, gp)
    rec = {"text_layers": cfgs[0].model.text.num_layers,
           "compute_dtype": cfgs[0].model.compute_dtype,
           "tensors": len(gp), "micro_loss": [lk, lp],
           "micro_loss_gap": abs(lk - lp),
           "step_loss": [sk["loss"], sp["loss"]],
           "step_loss_gap": abs(sk["loss"] - sp["loss"]),
           "grad_norm": [sk["grad_norm"], sp["grad_norm"]],
           "grad_norm_rel_gap": abs(sk["grad_norm"] - sp["grad_norm"])
           / sp["grad_norm"],
           "grad_max_rel_gap": grad_gap, "grad_l2_rel_gap": grad_gap_l2,
           "worst_tensors": worst,
           "tol": dict(zip(("loss", "grad_norm", "grad", "grad_l2"), tol))}
    log(phase, **rec)
    check(rec["micro_loss_gap"] <= tol[0]
          and rec["step_loss_gap"] <= tol[0], f"{phase}: loss gap")
    check(rec["grad_norm_rel_gap"] <= tol[1], f"{phase}: grad_norm gap")
    check(grad_gap <= tol[2] and grad_gap_l2 <= tol[3],
          f"{phase}: gradient gap")
    return rec


def phase_train_check(text_layers: int = 2):
    """train_check: the kernel path against the plain attention path
    (use_flash_attention=false: einsum attention whose dropout hashes the
    same counters), on the LoRA gradients.  lora_check: in fp32, the fused
    LoRA dropout against the unfused branch (HashDropout, then the thin
    matmul: the same masks), on the LoRA gradients."""
    cfgs = []
    for flash in (True, False):
        cfg = train_config(text_layers)
        cfg.model.use_flash_attention = flash
        cfgs.append(cfg)
    lora = lambda name: "lora_" in name
    train = compare_paths("train_check", cfgs, lora, "flash_attention",
                          (CHECK_LOSS_TOL, CHECK_NORM_TOL, CHECK_GRAD_TOL,
                           CHECK_GRAD_L2_TOL))
    cfgs = []
    for fused in (True, False):
        cfg = train_config(text_layers)
        cfg.model.compute_dtype = "float32"
        cfg.model.use_flash_attention = False
        cfg.model.text.lora_fused_dropout = fused
        cfgs.append(cfg)
    fused = compare_paths("lora_check", cfgs, lora, "lora_dropout_fwd",
                          (LORA_CHECK_LOSS_TOL, LORA_CHECK_NORM_TOL,
                           LORA_CHECK_GRAD_TOL, LORA_CHECK_GRAD_L2_TOL))
    return train, fused


def vit_fine_tuned(name: str) -> bool:
    return name.startswith(("img_expert.backbone.layer_10.",
                            "img_expert.backbone.layer_11."))


def vit_fine_tuned_but_key_bias(name: str) -> bool:
    """The fine-tuned ViT tensors whose gradient is not zero in exact
    arithmetic: a key bias adds the constant q.b_k to all of a query's
    scores, which the softmax ignores, so both paths return rounding noise
    for it (norm 2.9e-6 on an H100, against 0.65 for the largest)."""
    return vit_fine_tuned(name) and not name.endswith("attention.key.bias")


def phase_home_train(timed_steps: int = 3):
    """The HoME training main path at full width: launches (#7 through the
    fine-tuned ViT layers), losses, the BatchNorm statistics moved and
    finite, ViT layer 10-11 gradients finite and non-zero and their weights
    unmoved (lr 0 for home_freeze_steps)."""
    import torch
    cfg = home_config()
    check(cfg.train.optim.home_freeze_steps > timed_steps + 2,
          "the fine-tuned ViT layers must still be frozen")
    trainer, batch, run, prof, kept = drive_trainer(cfg, timed_steps,
                                                    keep=vit_fine_tuned)
    for main, cl in zip(run["main_losses"], run["contrastive_losses"]):
        check(TRAIN_LOSS_RANGE[0] < main < TRAIN_LOSS_RANGE[1]
              and HOME_CONTRASTIVE_RANGE[0] < cl < HOME_CONTRASTIVE_RANGE[1],
              f"HoME losses {main} + {cl}")
    buffers = dict(trainer.model.named_buffers())
    check(len(buffers) == 12 and all(torch.isfinite(b).all()
                                     for b in buffers.values()),
          "BatchNorm statistics")
    moved = [k for k, b in buffers.items() if not torch.equal(
        b, torch.zeros_like(b) if k.endswith("mean") else torch.ones_like(b))]
    check(len(moved) == len(buffers), f"BatchNorm statistics moved: {moved}")
    ft = {k: p for k, p in trainer.trainable.items() if vit_fine_tuned(k)}
    check(len(ft) == len(kept) > 0
          and all(torch.equal(p, kept[k]) for k, p in ft.items()),
          "the frozen fine-tuned ViT weights moved")
    _, grads = micro_grads(trainer, ft, {k: v[0] for k, v in batch.items()})
    norms = {k: g.float().norm().item() for k, g in grads.items()}
    check(all(math.isfinite(n) and n > 0 for n in norms.values()),
          f"ViT layer 10-11 gradients: {norms}")
    run["vit_ft_grad_norm_range"] = [min(norms.values()),
                                     max(norms.values())]
    run["batch_norm_var_range"] = [min(b.min().item() for k, b in
                                       buffers.items() if k.endswith("var")),
                                   max(b.max().item() for k, b in
                                       buffers.items() if k.endswith("var"))]
    log("home_train", **run)
    log("home_train_profile", **prof)
    ckpt = save_checkpoint(trainer, "ckpt_home")
    del trainer, batch, ft, grads, kept
    torch.cuda.empty_cache()
    return run["launches"], prof, ckpt


def phase_home_check(text_layers: int = 2):
    """HoME at `text_layers` text layers on the kernel path against the
    plain attention path (einsum everywhere, autograd through it), on the
    gradients of ViT layers 10-11 (but the key biases', zero in exact
    arithmetic), which #7 computes on the kernel path."""
    cfgs = []
    for flash in (True, False):
        cfg = home_config(text_layers)
        cfg.model.use_flash_attention = flash
        cfgs.append(cfg)
    return compare_paths("home_check", cfgs, vit_fine_tuned_but_key_bias,
                         "flash_attention_packed_bwd",
                         (HOME_CHECK_LOSS_TOL, HOME_CHECK_NORM_TOL,
                          HOME_CHECK_GRAD_TOL, HOME_CHECK_GRAD_L2_TOL))


def phase_keep_mask_kernel(rate: float = 0.1):
    """#8 against dropout_keep_mask_reference on the card, bit for bit, at
    every shape of KEEP_MASK_SHAPES for seeds of both signs; its time per
    call at each shape (events over calls back to back, the kernel's device
    time from torch.profiler and the host's time to enqueue a call), and one
    training step's calls (per micro-batch the cross expert's 5 attentions
    at L = 64 and the fuse experts' 4 at L = 2) back to back, against the
    plain version's and the bound: the bytes written over the memory rate
    (it reads nothing)."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
    seed = 987654321
    recs, fns = {}, {}
    for name, (b, h, lq, lk) in KEEP_MASK_SHAPES.items():
        err = 0
        for s in (seed, -12345):
            got = fa.dropout_keep_mask(s, b, h, lq, lk, rate, device="cuda")
            torch.cuda.synchronize()
            want = fa.dropout_keep_mask_reference(s, b, h, lq, lk, rate,
                                                  device="cuda")
            check(got.dtype == torch.bool and got.shape == want.shape,
                  f"keep mask {name}: {got.dtype} {tuple(got.shape)}")
            err = max(err, (got.int() - want.int()).abs().max().item())
            check(torch.equal(got, want),
                  f"keep mask {name}, seed {s}: kernel differs from the "
                  f"plain version in {(got != want).sum().item()} places")
        kernel = (lambda b=b, h=h, lq=lq, lk=lk: fa.dropout_keep_mask(
            seed, b, h, lq, lk, rate, device="cuda"))
        plain = (lambda b=b, h=h, lq=lq, lk=lk: fa.dropout_keep_mask_reference(
            seed, b, h, lq, lk, rate, device="cuda"))
        nbytes = b * h * lq * lk
        _, _, by_kind, _ = profiled(lambda: [kernel() for _ in range(20)])
        recs[name] = {"shape": [b, h, lq, lk], "max_abs_err": float(err),
                      "io_bytes": nbytes,
                      "ms": cuda_ms(kernel, iters=100, warmup=10),
                      "device_ms": by_kind["dropout_keep_mask"] / 20,
                      "host_ms": host_ms(kernel),
                      "plain_ms": cuda_ms(plain, iters=10, warmup=2),
                      "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        fns[name] = (kernel, plain)
    m = train_config().model
    accum = train_config().train.optim.grad_accum
    n_cross = accum * (2 * m.cross_layers + 1)
    n_fuse = accum * 2 * m.fuse_depth
    check(n_cross + n_fuse
          == expected_launches(train_config())["dropout_keep_mask"],
          "keep mask calls per step")

    def step(side):
        def run():
            for _ in range(n_cross):
                fns["cross"][side]()
            for _ in range(n_fuse):
                fns["fuse"][side]()
        return run
    per_step = {"calls": n_cross + n_fuse,
                "ms": cuda_ms(step(0), iters=20, warmup=3),
                "plain_ms": cuda_ms(step(1), iters=5, warmup=1),
                "bound_ms": (n_cross * recs["cross"]["bound_ms"]
                             + n_fuse * recs["fuse"]["bound_ms"])}
    log("keep_mask_kernel", rate=rate, equal=True, library_ms=None,
        library_reason="no single PyTorch call computes this hash",
        cases=recs)
    log("keep_mask_kernel_step", **per_step)
    return recs, per_step


# ---------------------------------------------------------------------------
# phases 11 and 12: evaluation from the trainers' checkpoints
# ---------------------------------------------------------------------------

def eval_config(variant: str = "baseline"):
    """The training shape's model (batch 64, 2 chunks per sample) scoring
    the synthetic shards of _smoke_work/shards."""
    cfg = train_config()
    cfg.model.variant = variant
    cfg.data.allow_hash_tokenizer = True
    cfg.data.valid_pattern = os.path.join(WORK, "shards", "*.tar.gz")
    cfg.train.output_dir = os.path.join(WORK, f"eval_{variant}")
    return cfg


def write_eval_shards():
    from mmoe_multimodal_rec_tpu_torch.data.synthetic import (
        write_synthetic_shards)
    t0 = time.perf_counter()
    paths = write_synthetic_shards(os.path.join(WORK, "shards"),
                                   EVAL_SAMPLES, 64, seed=0)
    log("eval_shards", samples=EVAL_SAMPLES, shards=len(paths),
        seconds=time.perf_counter() - t0)
    return paths


def restored_model(cfg, ckpt: str):
    """MMoERecModel of `cfg` on the card with the checkpoint's tensors."""
    from mmoe_multimodal_rec_tpu_torch.models.mmoe import (DTYPES,
                                                           MMoERecModel)
    from mmoe_multimodal_rec_tpu_torch.train.checkpoint import (
        CheckpointManager)
    model = MMoERecModel(cfg.model)
    step = CheckpointManager(ckpt).restore_model(model)
    check(step is not None, f"no checkpoint in {ckpt}")
    return model.to(device="cuda", dtype=DTYPES[cfg.model.param_dtype]), step


def first_eval_batch(cfg, shards, device):
    """The eval loader's first batch of `cfg`, as tensors on `device`."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.data.loader import make_eval_loader
    from mmoe_multimodal_rec_tpu_torch.data.packer import packer_from_config
    loader = make_eval_loader(shards, cfg.train.batch_size,
                              packer_from_config(cfg),
                              chunk_budget=cfg.model.packer.chunk_budget)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def prob_gap(got, want) -> float:
    """Largest probability difference over the valid rows."""
    valid = want["valid"].bool().cpu()
    return max((got[k].float().cpu() - want[k].float().cpu())[valid]
               .abs().max().item() for k in ("prob_good", "prob_best"))


def check_eval_launches(counts, cfg, forwards: int, phase: str):
    """Each eval forward (LoRA unmerged) runs every ViT layer through #1
    and every layer of both text encoders through #2 at rate 0; nothing
    else launches."""
    want = {k: 0 for k in counts}
    want["flash_attention_packed"] = cfg.model.image.num_layers * forwards
    want["flash_attention"] = 2 * cfg.model.text.num_layers * forwards
    check(counts == want, f"{phase}: launches {counts}, expected {want}")


def small_models(variant: str):
    """The small fp32 model (small_config) of `variant`, seeded init, on
    the card and on the CPU."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.models.layers import init_weights
    from mmoe_multimodal_rec_tpu_torch.models.mmoe import MMoERecModel
    cfg = small_config()
    cfg.model.variant = variant
    out = {}
    for device in ("cuda", "cpu"):
        model = MMoERecModel(cfg.model)
        init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
        out[device] = model.to(device)
    return cfg, out


def cli_eval(ckpt: str, cfg, extra=()):
    """`python -m mmoe_multimodal_rec_tpu_torch eval --checkpoint=<ckpt>` in
    a subprocess at the phase's configuration: its printed result and
    seconds."""
    flags = [f"--checkpoint={ckpt}",
             f"--train.batch_size={cfg.train.batch_size}",
             f"--model.packer.chunk_budget={cfg.model.packer.chunk_budget}",
             f"--model.variant={cfg.model.variant}",
             "--data.allow_hash_tokenizer=true",
             f"--data.valid_pattern={cfg.data.valid_pattern}",
             f"--train.output_dir={os.path.join(WORK, 'eval_cli')}", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "mmoe_multimodal_rec_tpu_torch", "eval", *flags],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI eval exited {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), seconds


def phase_eval(ckpt: str, shards):
    """The baseline checkpoint restored and evaluated at full width: one
    pass on the host clock (the main path, its launches counted), one under
    torch.profiler; the first batch's probabilities against the plain
    attention path; a small fp32 model card against CPU; the CLI."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.eval.evaluate import evaluate
    from mmoe_multimodal_rec_tpu_torch.train.step import make_eval_step
    cfg = eval_config()
    t0 = time.perf_counter()
    model, step = restored_model(cfg, ckpt)
    restore_s = time.perf_counter() - t0
    forwards = math.ceil(EVAL_SAMPLES / cfg.train.batch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = evaluate(cfg, model, shards, output_dir=cfg.train.output_dir,
                   save_preds="preds.csv")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(res["n"] == EVAL_SAMPLES and math.isfinite(res["good"])
          and math.isfinite(res["best"]), f"eval result {res}")
    check_eval_launches(counts, cfg, forwards, "eval")
    again, window_ms, by_kind, top = profiled(
        lambda: evaluate(cfg, model, shards))
    check(again["n"] == res["n"]
          and abs(again["good"] - res["good"]) <= CLI_AUC_TOL
          and abs(again["best"] - res["best"]) <= CLI_AUC_TOL,
          f"a second pass gave {again}, the first {res}")
    for kind in ("flash_attention_packed", "flash_attention"):
        check(by_kind.get(kind, 0.0) > 0, f"no device time of {kind}")
    device_ms = sum(by_kind.values())

    batch = first_eval_batch(cfg, shards, "cuda")
    got = make_eval_step(cfg, model)(batch)
    del model
    torch.cuda.empty_cache()
    cfg_plain = eval_config()
    cfg_plain.model.use_flash_attention = False
    plain, _ = restored_model(cfg_plain, ckpt)
    before = read_launches()
    want = make_eval_step(cfg_plain, plain)(batch)
    check(read_launches() == before, "the plain path launched a kernel")
    plain_err = prob_gap(got, want)
    check(plain_err <= PLAIN_PATH_TOL,
          f"eval, kernel path vs plain path: max prob diff {plain_err}")
    del plain, batch
    torch.cuda.empty_cache()

    small, models = small_models("baseline")
    before = read_launches()
    outs = {d: make_eval_step(small, m)(first_eval_batch(small, shards, d))
            for d, m in models.items()}
    after = read_launches()
    check(after["flash_attention"] > before["flash_attention"]
          and after["flash_attention_packed"]
          > before["flash_attention_packed"],
          "the small model did not take the kernels")
    small_err = prob_gap(outs["cuda"], outs["cpu"])
    check(small_err <= SMALL_CPU_TOL,
          f"eval, small fp32 model GPU vs CPU: max prob diff {small_err}")

    cli, cli_s = cli_eval(ckpt, cfg)
    cli_gap = max(abs(cli["auc_good"] - res["good"]),
                  abs(cli["auc_best"] - res["best"]))
    check(cli["n"] == res["n"] and cli_gap <= CLI_AUC_TOL,
          f"CLI eval printed {cli}, in-process {res}")
    log("eval", batch=cfg.train.batch_size, samples=EVAL_SAMPLES,
        forwards=forwards, checkpoint_step=step, restore_s=restore_s,
        eval_s=eval_s, examples_per_sec=EVAL_SAMPLES / eval_s,
        peak_bytes=peak, launches=counts,
        launches_per_forward={k: v / forwards for k, v in counts.items()
                              if v},
        auc_good=res["good"], auc_best=res["best"], n=res["n"],
        kernel_vs_plain_path_max_prob_diff=plain_err,
        small_fp32_gpu_vs_cpu_max_prob_diff=small_err,
        cli=cli, cli_seconds=cli_s, cli_auc_gap=cli_gap)
    log("eval_profile", forwards=forwards, window_ms=window_ms,
        device_ms=device_ms, device_busy_share=device_ms / window_ms,
        device_ms_per_forward_by_kind={k: v / forwards
                                       for k, v in by_kind.items()},
        top_kernels_ms=top)
    return {"counts": counts, "by_kind": by_kind, "forwards": forwards}


def phase_home_eval(ckpt: str, shards):
    """The HoME checkpoint restored at full width, its BatchNorm statistics
    recalibrated over 2 batches of 128, then evaluated; a small fp32 HoME
    model recalibrated and scored on the card and on the CPU."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.data.packer import packer_from_config
    from mmoe_multimodal_rec_tpu_torch.eval.evaluate import (evaluate,
                                                             recalibrate_bn)
    from mmoe_multimodal_rec_tpu_torch.train.step import make_eval_step
    cfg = eval_config("home")
    model, step = restored_model(cfg, ckpt)
    before = {k: b.clone() for k, b in model.named_buffers()}
    recal_batches = math.ceil(HOME_RECAL_SAMPLES / 128)
    forwards = math.ceil(EVAL_SAMPLES / cfg.train.batch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stats = recalibrate_bn(cfg, model, shards, packer_from_config(cfg),
                           total_samples=HOME_RECAL_SAMPLES,
                           bn_batch_size=128)
    torch.cuda.synchronize()
    recal_s = time.perf_counter() - t0
    check(len(stats) == 12 and all(torch.isfinite(b).all()
                                   for b in stats.values()),
          "recalibrated BatchNorm statistics")
    moved = [k for k, b in stats.items() if not torch.equal(b, before[k])]
    check(len(moved) == len(stats), f"statistics moved: {moved}")
    t0 = time.perf_counter()
    res = evaluate(cfg, model, shards)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(res["n"] == EVAL_SAMPLES and math.isfinite(res["good"])
          and math.isfinite(res["best"]), f"HoME eval result {res}")
    check_eval_launches(counts, cfg, forwards + recal_batches, "home_eval")
    var_range = [min(b.min().item() for k, b in stats.items()
                     if k.endswith("var")),
                 max(b.max().item() for k, b in stats.items()
                     if k.endswith("var"))]
    del model, stats, before
    torch.cuda.empty_cache()

    small, models = small_models("home")
    packer = packer_from_config(small)
    got = {}
    for device, m in models.items():
        recalibrate_bn(small, m, shards, packer, total_samples=8,
                       bn_batch_size=4)
        got[device] = ({k: b.cpu() for k, b in m.named_buffers()},
                       make_eval_step(small, m)(
                           first_eval_batch(small, shards, device)))
    stats_err = max((got["cuda"][0][k] - w).abs().max().item()
                    / w.abs().max().item() for k, w in got["cpu"][0].items())
    small_err = prob_gap(got["cuda"][1], got["cpu"][1])
    check(stats_err <= SMALL_STATS_TOL,
          f"small HoME recalibrated statistics GPU vs CPU: {stats_err}")
    check(small_err <= SMALL_CPU_TOL,
          f"small HoME GPU vs CPU: max prob diff {small_err}")
    log("home_eval", checkpoint_step=step,
        recal_batches=recal_batches, recal_batch=128, recal_s=recal_s,
        eval_s=eval_s, examples_per_sec=EVAL_SAMPLES / eval_s,
        peak_bytes=peak, launches=counts, batch_norm_var_range=var_range,
        auc_good=res["good"], auc_best=res["best"], n=res["n"],
        small_fp32_stats_gpu_vs_cpu=stats_err,
        small_fp32_gpu_vs_cpu_max_prob_diff=small_err)
    return counts


# ---------------------------------------------------------------------------
# phase 13: the offline data pipeline, from raw records to a checkpoint
# ---------------------------------------------------------------------------

# The scale of the raw records: about 300 items and 200 users of 6-10
# reviews each, texts of 40-150 words in 3-12 sentences.  The pipeline keeps
# the JAX CLI's defaults (5 negatives a positive, 20% of the 5-star reviews);
# each user's reviews run over a few weeks from a day of 2023, and the train
# and valid splits end early in the year (PIPELINE_DATES), so that
# build-dataset and pretokenize write a few hundred samples a split and the
# test split, which no phase reads, holds the rest of the rows.
PIPELINE = dict(items=300, users=200, reviews=(6, 10), words=(40, 150),
                sentences=(3, 12), seed=0)
PIPELINE_DATES = ("2023-02-05", "2023-02-25")   # train_end, valid_end
PIPELINE_STEPS = 2                               # optimizer steps trained
PIPELINE_HAS_IMAGE = (0.35, 0.65)   # patches for half the items
PACK_REPEATS = {"python": 3, "native": 10, "pack_encoded": 10}
_CATEGORIES = ("Sports & Outdoors", "Camping & Hiking", "Cycling",
               "Exercise & Fitness")
_REVIEW_WORDS = (
    "the a an and but or so because while after before during with without "
    "for from into onto over under about this that these those it its i we "
    "you they my our your their me us them is was are were be been being "
    "has have had do did does not no very really quite too also just only "
    "still even again never always sometimes tent poles stakes rain fly "
    "zipper zippers sleeping bag pad pillow stove fuel canister lantern "
    "headlamp battery batteries backpack straps hip belt frame pocket "
    "pockets bottle water filter jacket shell hood sleeves gloves boots "
    "shoes socks laces soles trail trails hike hiking camp camping trip "
    "trips weekend night nights morning day days week weeks month months "
    "year bike helmet lights lock tire tires pump chain saddle grips "
    "bottle cage gear kit knife axe cooler chair table hammock tarp rope "
    "cord carabiner compass map weight weighs ounces pounds size fit fits "
    "fitting small medium large light lighter heavy heavier compact sturdy "
    "durable flimsy cheap expensive worth price value quality material "
    "fabric nylon polyester aluminum steel plastic rubber foam mesh seams "
    "stitching waterproof water-resistant breathable warm warmer cold "
    "colder wind windy storm snow heat sun shade dry wet mud rocky sandy "
    "ground floor setup set up pack packed packs fold folds folded easy "
    "easier hard harder simple quick quickly slowly perfect perfectly great "
    "good better best nice fine okay decent poor bad worse worst terrible "
    "awesome excellent amazing solid reliable comfortable uncomfortable "
    "love loved like liked hate hated recommend recommended return "
    "returned replace replaced broke broken tore torn ripped leaked leaks "
    "works worked working held holds hold kept keeps keep used use using "
    "bought buy buying ordered order arrived shipping box instructions "
    "color colors black green blue gray red orange bright dark two three "
    "four five ten first second last every each other another more most "
    "less enough much many few lot lots family kids wife husband friend "
    "friends dog car truck backyard lake river mountain mountains forest "
    "beach park campsite").split()
_TEMPLATE_WORDS = ("category history total reviews review avg price std "
                   "variation browsing item title features feature "
                   "description no n a unknown").split()


def _sentences(rng, lo: int, hi: int, words=(4, 18)) -> str:
    """A text of lo..hi words in PIPELINE's sentence count, from
    _REVIEW_WORDS."""
    total = int(rng.integers(lo, hi + 1))
    n = min(int(rng.integers(PIPELINE["sentences"][0],
                             PIPELINE["sentences"][1] + 1)),
            total // words[0])
    lens = words[0] + rng.multinomial(total - words[0] * n, [1 / n] * n)
    out = []
    for k in lens:
        w = list(rng.choice(_REVIEW_WORDS, size=int(k)))
        if k > 8 and rng.random() < 0.4:
            w[int(rng.integers(2, k - 2))] += ","
        out.append(" ".join(w).capitalize() + str(rng.choice([".", ".",
                                                               ".", "!",
                                                               "?"])))
    return " ".join(out)


def pipeline_records(rng):
    """Meta and review records in the schema transform_meta /
    transform_review emit (what `ingest-meta` / `ingest-reviews` write),
    as tests/test_pipeline.py's end-to-end test builds them, at
    PIPELINE's scale."""
    t0 = 1672531200000   # 2023-01-01T00:00:00Z in ms
    metas = []
    for i in range(PIPELINE["items"]):
        url = f"https://m.media-amazon.com/images/I/{i:08d}.jpg"
        metas.append({
            "parent_asin": f"B{i:09d}", "asin": f"B{i:09d}",
            "main_category": str(rng.choice(_CATEGORIES)),
            "title": _sentences(rng, 4, 9, (4, 9)).rstrip(".!?"),
            "average_rating": round(float(rng.uniform(2.5, 5)), 1),
            "rating_number": int(rng.integers(1, 3000)),
            "price": (None if rng.random() < 0.1 else
                      round(float(rng.uniform(5, 300)), 2)),
            "store": "Outfitters",
            "features": [_sentences(rng, 5, 14, (5, 14))
                         for _ in range(int(rng.integers(2, 6)))],
            "description": [_sentences(rng, *PIPELINE["words"])],
            "details": {"Item Weight": f"{int(rng.integers(2, 90))} ounces"},
            "images": [{"variant": "MAIN", "hi_res": url, "large": url,
                        "thumb": url}],
            "bought_together": None, "categories": ["Sports & Outdoors"]})
    reviews = []
    day = 86400000
    for u in range(PIPELINE["users"]):
        # a user reviews every 1-4 days from a day of 2023 on, so that the
        # rows of the early splits carry a causal history
        ts = t0 + int(rng.integers(0, 330)) * day
        for _ in range(int(rng.integers(PIPELINE["reviews"][0],
                                        PIPELINE["reviews"][1] + 1))):
            ts += int(rng.integers(1, 5)) * day + int(rng.integers(0, day))
            pid = metas[int(rng.integers(0, len(metas)))]["parent_asin"]
            reviews.append({
                "user_id": f"AE{u:026d}", "asin": pid, "parent_asin": pid,
                "rating": float(rng.choice([1, 2, 3, 4, 5],
                                           p=[0.08, 0.06, 0.1, 0.2, 0.56])),
                "title": _sentences(rng, 3, 8, (3, 8)).rstrip(".!?"),
                "text": _sentences(rng, *PIPELINE["words"]),
                "sort_timestamp": ts,
                "verified_purchase": bool(rng.random() < 0.9),
                "helpful_votes": int(rng.integers(0, 12))})
    return metas, reviews


def pipeline_vocab(path: str, vocab_size: int) -> None:
    """A BERT-layout WordPiece vocab.txt of exactly vocab_size entries:
    [PAD], [unused*], [UNK], [CLS], [SEP], [MASK], punctuation, digits and
    letters with their ## pieces, the corpus's and the templates' words,
    and every third long word only as a stem and a ## piece, so that
    WordPiece splits it; [unused*] fill the rest."""
    import string
    held = sorted(w for w in set(_REVIEW_WORDS) if len(w) >= 7)[::3]
    words = sorted(set(_REVIEW_WORDS) - set(held)) + _TEMPLATE_WORDS
    chars = string.digits + string.ascii_lowercase
    entries = dict.fromkeys(
        ["[PAD]"] + [f"[unused{i}]" for i in range(99)] +
        ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(string.punctuation) +
        list(chars) + [f"##{c}" for c in chars] +
        [p for w in held for p in (w[:4], f"##{w[4:]}")] + words)
    entries = list(entries)
    filler = 99
    while len(entries) < vocab_size:
        entries.append(f"[unused{filler}]")
        filler += 1
    check(len(entries) == vocab_size, f"vocab of {len(entries)} entries")
    with open(path, "w") as f:
        f.write("\n".join(entries) + "\n")


def item_patch_record(rng, pid: str) -> dict:
    """A 224x224x3 uint8 image made with numpy (a gradient, a few blocks,
    noise), laid out as patches.decode_and_patch lays out a decoded one:
    CHW, cut into 196 rows of 16x16x3, base64."""
    y, x = np.mgrid[0:224, 0:224].astype(np.float32)
    img = (rng.uniform(0, 255, (3, 1, 1)) +
           rng.uniform(-0.5, 0.5, (3, 1, 1)) * y +
           rng.uniform(-0.5, 0.5, (3, 1, 1)) * x)
    for _ in range(3):
        r, c = rng.integers(0, 180, 2)
        h, w = rng.integers(20, 60, 2)
        img[:, r:r + h, c:c + w] = rng.uniform(0, 255, (3, 1, 1))
    img += rng.normal(0, 6, img.shape)
    chw = np.clip(img, 0, 255).astype(np.uint8)
    rows = (chw.reshape(3, 14, 16, 14, 16).transpose(1, 3, 0, 2, 4)
            .reshape(196, 768))
    return {"parent_asin": pid,
            "patch_b64": base64.b64encode(rows.tobytes()).decode(),
            "shape": [196, 3, 16, 16]}


def run_cli(*argv):
    """The port's CLI in this process: exit code, the last printed line as
    JSON, seconds."""
    import io
    from mmoe_multimodal_rec_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    check(bool(lines), f"{argv[0]} printed nothing")
    return rc, json.loads(lines[-1]), seconds


@contextlib.contextmanager
def pack_paths():
    """The TextPacker calls made while the block runs (loader threads
    included), by path: `pack` (split + WordPiece + packing) and
    `pack_encoded` (packing of pretokenized sentences), each call's
    tokenizer class."""
    from mmoe_multimodal_rec_tpu_torch.data.packer import TextPacker
    calls = {"pack": [], "pack_encoded": []}
    real = {name: getattr(TextPacker, name) for name in calls}
    lock = threading.Lock()

    def spy(name):
        def fn(self, *args, **kw):
            with lock:
                calls[name].append(type(self.tok).__name__)
            return real[name](self, *args, **kw)
        return fn
    for name in calls:
        setattr(TextPacker, name, spy(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(TextPacker, name, fn)


@contextlib.contextmanager
def trainer_steps():
    """The Trainer that runs steps while the block runs, and each step's
    metrics."""
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer
    seen = {"trainer": None, "metrics": []}
    real = Trainer.run_step

    def spy(self, batch):
        m = real(self, batch)
        seen["trainer"] = self
        seen["metrics"].append(m)
        return m
    Trainer.run_step = spy
    try:
        yield seen
    finally:
        Trainer.run_step = real


def trainer_counts(trainer) -> dict:
    """Elements of the trainer's trainable parameters, BatchNorm
    statistics and optimizer state, as ckpt-info counts them."""
    import torch
    parts = {"trainable": list(trainer.trainable.values()),
             "batch_stats": [b for _, b in trainer.model.named_buffers()],
             "opt_state": [t for s in trainer.optimizer.state.values()
                           for t in s.values() if torch.is_tensor(t)]}
    return {k: sum(t.numel() for t in v) for k, v in parts.items()}


def pipeline_data(root: str, vocab_size: int):
    """Raw records, vocab and patches written, then `features`,
    `build-dataset` (train and valid), `pretokenize` and `validate` through
    the CLI.  Returns (stage seconds, counts, the validate reports, the
    pretokenized shard globs, the vocab's path)."""
    import gzip
    from mmoe_multimodal_rec_tpu_torch.data.patches import write_patch_jsonl
    rng = np.random.default_rng(PIPELINE["seed"])
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    seconds = {}
    t0 = time.perf_counter()
    metas, reviews = pipeline_records(rng)
    for name, recs in (("meta", metas), ("reviews", reviews)):
        with gzip.open(os.path.join(raw, f"{name}-00000.jsonl.gz"), "wt",
                       encoding="utf-8") as f:
            for rec in recs:
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
    vocab = os.path.join(root, "vocab.txt")
    pipeline_vocab(vocab, vocab_size)
    n_patches = write_patch_jsonl(
        (item_patch_record(rng, m["parent_asin"]) for m in metas[::2]),
        os.path.join(raw, "patches.jsonl.gz"))
    seconds["records"] = time.perf_counter() - t0
    train_end, valid_end = PIPELINE_DATES
    rc, features, seconds["features"] = run_cli(
        "features", f"--meta={raw}/meta-*.jsonl.gz",
        f"--reviews={raw}/reviews-*.jsonl.gz",
        f"--output={root}/rows", f"--train-end={train_end}",
        f"--valid-end={valid_end}")
    check(rc == 0 and features["splits"] == ["test", "train", "valid"],
          f"features: {rc} {features}")
    rows = {}
    for split in ("train", "valid", "test"):
        d = os.path.join(root, "rows", split)
        rows[split] = sum(sum(1 for _ in open(os.path.join(d, f)))
                          for f in os.listdir(d))
    shards, reports = {}, {}
    for split in ("train", "valid"):
        rc, built, s = run_cli(
            "build-dataset", f"--rows={root}/rows/{split}/*.jsonl",
            f"--patches={raw}/patches.jsonl.gz",
            f"--output={root}/shards_raw/{split}", "--samples-per-shard=128")
        seconds[f"build_dataset_{split}"] = s
        check(rc == 0 and built["shards"] > 0, f"build-dataset: {built}")
        rc, pre, s = run_cli(
            "pretokenize", f"--input={root}/shards_raw/{split}/*.tar.gz",
            f"--output={root}/shards/{split}", f"--data.vocab_path={vocab}")
        seconds[f"pretokenize_{split}"] = s
        check(rc == 0 and pre["shards"] == built["shards"],
              f"pretokenize: {pre}, built {built}")
        shards[split] = f"{root}/shards/{split}/*.tar.gz"
        rc, rep, s = run_cli("validate", f"--input={shards[split]}")
        seconds[f"validate_{split}"] = s
        check(rc == 0 and rep["dropped"] == 0 and
              rep["samples"] == rows[split] and
              rep["pretokenized_rate"] == 1.0 and
              PIPELINE_HAS_IMAGE[0] <= rep["has_image_rate"]
              <= PIPELINE_HAS_IMAGE[1],
              f"validate {split}: exit {rc}, {rep}, {rows[split]} rows")
        reports[split] = rep
    counts = {"items": len(metas), "users": PIPELINE["users"],
              "reviews": len(reviews), "patches": n_patches,
              "image_urls": features["image_urls"], "rows": rows,
              "samples": {k: r["samples"] for k, r in reports.items()},
              "shards": {k: r["shards"] for k, r in reports.items()}}
    return seconds, counts, reports, shards, vocab


def host_pack_times(pattern: str, vocab: str, cfg, batch: int = 64):
    """One batch of `batch` decoded pairs packed on the host three ways:
    the pure-Python WordPiece and the native one (text: split + encode +
    pack), and the native pack_encoded over the pretokenized sentences
    (the loader's path on these shards).  All must give the same arrays.
    Returns ms by way (median of PACK_REPEATS) and the batch's fill."""
    import itertools
    from mmoe_multimodal_rec_tpu_torch.data.io import fs_glob
    from mmoe_multimodal_rec_tpu_torch.data.loader import iter_decoded
    from mmoe_multimodal_rec_tpu_torch.data.native_tokenizer import (
        NativeWordPieceTokenizer)
    from mmoe_multimodal_rec_tpu_torch.data.packer import TextPacker
    from mmoe_multimodal_rec_tpu_torch.data.wordpiece import (
        WordPieceTokenizer)
    samples = list(itertools.islice(iter_decoded(sorted(fs_glob(pattern))),
                                    batch))
    check(len(samples) == batch and all("user_sents" in s for s in samples),
          "the pack batch lacks pretokenized samples")
    budget = cfg.model.packer.chunk_budget
    py = TextPacker(WordPieceTokenizer.from_vocab_file(vocab),
                    cfg.model.packer)
    nat = TextPacker(NativeWordPieceTokenizer(vocab), cfg.model.packer)
    sides = ("user", "item")
    ways = {
        "python": lambda: [py.pack([s[f"{side}_text"] for s in samples],
                                   budget) for side in sides],
        "native": lambda: [nat.pack([s[f"{side}_text"] for s in samples],
                                    budget) for side in sides],
        "pack_encoded": lambda: [nat.pack_encoded(
            [s[f"{side}_sents"] for s in samples], budget) for side in sides]}
    ms, outs = {}, {}
    for name, fn in ways.items():
        times = []
        for _ in range(PACK_REPEATS[name]):
            t0 = time.perf_counter()
            outs[name] = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        ms[name] = sorted(times)[len(times) // 2]
    want = outs["python"]
    for name, got in outs.items():
        for a, b in zip(got, want):
            check(a.n_chunks == b.n_chunks and
                  np.array_equal(a.tokens, b.tokens) and
                  np.array_equal(a.sent_chunk, b.sent_chunk) and
                  np.array_equal(a.sent_tok, b.sent_tok),
                  f"host packing: {name} differs from the pure-Python pack")
    fill = {}
    for side, packed in zip(sides, want):
        real = packed.tokens[:packed.n_chunks] != py.tok.pad_id
        fill[side] = {"chunks": int(packed.n_chunks), "budget": budget,
                      "tokens_per_chunk": float(real.sum(1).mean()),
                      "sentences_per_sample":
                          float((packed.sent_chunk >= 0).sum(1).mean())}
    return ms, fill


def phase_pipeline():
    """The offline data path through the CLI on seeded raw records (the
    schema ingest writes), with a WordPiece vocab of the model's size and
    patches for half the items: features -> build-dataset -> pretokenize
    -> validate; then the full-width baseline trains PIPELINE_STEPS
    optimizer steps on the pretokenized train shards through `train`
    (every batch packed through pack_encoded by the native tokenizer, the
    launches of #2-#6 and #8 per step as expected_launches says, no
    skipped micro-batch, finite losses), `eval` scores the checkpoint over
    the valid shards (every sample counted, the launches of #1 and #2 per
    forward), and `ckpt-info` reads it back (the latest step and the
    trainer's own counts); last, the host packing of one batch of these
    texts, three ways, with equal outputs."""
    import torch
    from mmoe_multimodal_rec_tpu_torch.config import Config
    from mmoe_multimodal_rec_tpu_torch.data.native_tokenizer import (
        NativeWordPieceTokenizer, load_best_tokenizer)
    root = os.path.join(WORK, "pipeline")
    base = train_config()
    seconds, counts, reports, shards, vocab = pipeline_data(
        root, base.model.text.vocab_size - 1)
    tok = load_best_tokenizer(vocab, base.model.text.vocab_size)
    check(isinstance(tok, NativeWordPieceTokenizer),
          f"the native tokenizer did not load: {type(tok).__name__}")
    ckpt = os.path.join(root, "ckpt")
    flags = [f"--train.batch_size={base.train.batch_size}",
             f"--train.optim.grad_accum={base.train.optim.grad_accum}",
             f"--model.packer.chunk_budget={base.model.packer.chunk_budget}",
             f"--data.vocab_path={vocab}", f"--train.checkpoint_dir={ckpt}",
             f"--train.output_dir={root}/out"]
    cfg = Config.from_flags(flags)
    accum = cfg.train.optim.grad_accum
    reset_launches()
    with pack_paths() as packs, trainer_steps() as seen:
        rc, trained, seconds["train"] = run_cli(
            "train", "--device=cuda",
            f"--data.train_pattern={shards['train']}",
            "--train.epochs=1", f"--train.steps_per_epoch="
            f"{PIPELINE_STEPS * accum}", "--train.log_every=1", *flags)
    launches = read_launches()
    metrics, trainer = seen["metrics"], seen["trainer"]
    check(rc == 0 and len(metrics) == PIPELINE_STEPS,
          f"train: exit {rc}, {len(metrics)} steps")
    for m in metrics:
        check(math.isfinite(m["loss"]) and m["skipped_micro"] == 0
              and TRAIN_LOSS_RANGE[0] < m["loss"] < TRAIN_LOSS_RANGE[1],
              f"pipeline train step: {m}")
    check(trainer.device.type == "cuda", f"trained on {trainer.device}")
    check(not packs["pack"] and
          len(packs["pack_encoded"]) >= 2 * PIPELINE_STEPS * accum and
          set(packs["pack_encoded"]) == {"NativeWordPieceTokenizer"},
          f"the loader's pack paths: pack {len(packs['pack'])} calls, "
          f"pack_encoded {len(packs['pack_encoded'])} "
          f"({sorted(set(packs['pack_encoded']))})")
    per_step = {k: n / PIPELINE_STEPS for k, n in launches.items()}
    want = expected_launches(cfg)
    check(per_step == want, f"pipeline train launches per step {per_step}, "
                            f"expected {want}")
    own = trainer_counts(trainer)
    del trainer, seen
    torch.cuda.empty_cache()

    reset_launches()
    with pack_paths() as eval_packs:
        rc, ev, seconds["eval"] = run_cli(
            "eval", "--device=cuda", f"--checkpoint={ckpt}",
            f"--data.valid_pattern={shards['valid']}", *flags)
    eval_launches = read_launches()
    n_valid = counts["samples"]["valid"]
    forwards = math.ceil(n_valid / cfg.train.batch_size)
    check(rc == 0 and ev["n"] == n_valid and math.isfinite(ev["auc_good"])
          and math.isfinite(ev["auc_best"]),
          f"eval: exit {rc}, {ev}, {n_valid} valid samples")
    check(not eval_packs["pack"] and
          len(eval_packs["pack_encoded"]) == 2 * forwards,
          f"eval pack paths: {len(eval_packs['pack'])} pack, "
          f"{len(eval_packs['pack_encoded'])} pack_encoded")
    check_eval_launches(eval_launches, cfg, forwards, "pipeline eval")
    torch.cuda.empty_cache()

    rc, info, seconds["ckpt_info"] = run_cli("ckpt-info",
                                             f"--checkpoint={ckpt}")
    check(rc == 0 and info["latest_step"] == PIPELINE_STEPS
          and info["param_counts"] == own and info["frozen_once"],
          f"ckpt-info: {info}, the trainer's counts {own}")

    pack_ms, fill = host_pack_times(shards["valid"], vocab, cfg)
    log("pipeline", counts=counts, seconds=seconds,
        validate={k: {f: r[f] for f in ("dropped", "pretokenized_rate",
                                        "has_image_rate",
                                        "label_good_pos_rate",
                                        "label_best_pos_rate")}
                  for k, r in reports.items()},
        tokenizer=type(tok).__name__,
        train={"steps": len(metrics), "losses": [m["loss"] for m in metrics],
               "skipped_micro": [m["skipped_micro"] for m in metrics],
               "examples_per_sec": trained["examples_per_sec"],
               "launches_per_step": per_step,
               "pack_encoded_calls": len(packs["pack_encoded"])},
        eval={"n": ev["n"], "auc_good": ev["auc_good"],
              "auc_best": ev["auc_best"], "forwards": forwards,
              "launches": eval_launches},
        ckpt_info={k: info[k] for k in ("latest_step", "steps",
                                        "param_counts", "payload_mb",
                                        "resume")},
        host_pack_ms=pack_ms, host_pack_batch=cfg.train.batch_size,
        host_pack_fill=fill, nvidia_smi=nvidia_smi())
    return pack_ms

def ptxas_report(log_text: str):
    """ptxas's registers and spills, per kernel (its mangled name)."""
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def check_spills(log_text: str, kernel_re: str, count, what: str,
                 strict: bool = True):
    """ptxas's registers and spilled bytes of the kernels whose mangled
    names match `kernel_re`: there must be `count` of them (None: any
    number), none spilling (`strict`; a variant timed beside the shipped
    build only reports them).  A change that outgrows a kernel's register
    budget shows up as spilled bytes, not as registers."""
    spills, regs, name = {}, {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        if not (name and re.search(kernel_re, name)):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills[name] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs[name] = int(m.group(1))
    check(count is None or len(spills) == count, f"ptxas reported "
          f"{len(spills)} of the {count} {what}")
    check(not (strict and any(spills.values())), f"{what} spill: {spills}")
    return {"spill_bytes": spills, "registers": regs}


# The main path's instantiations that must not spill, by source: the
# attention backward's (bf16, dh 64: the split #3 and the packed #7, dq and
# dk/dv each; budgets 128 and 168 registers, for 4 and 3 blocks an SM), the
# forward's (bf16, dh 64: split with statistics #2, packed with and without
# #1; 128 registers, for 2 blocks of 2 warpgroups an SM) and the LoRA
# dropout's bf16 forward #4, dA #5 and dh #6 (128 registers, for 2 blocks of
# 8 warps an SM).  (log key, kernel name pattern, count, what)
SPILL_CHECKS = {
    "flash_attention_bwd": ("dh64", r"attention_bwd_(dq|dkdv)_bf16ILi64E", 4,
                            "dh-64 bf16 backward kernels"),
    "flash_attention_fwd": ("dh64", r"attention_fwd_bf16ILi64E", 3,
                            "dh-64 bf16 forward kernels"),
    "lora_dropout": ("bf16", r"lora_(fwd|da|dh)_mma_kernel", 3,
                     "bf16 LoRA forward, dA and dh kernels"),
}
# Kernels whose compiled loops build_all and the variants' builds report
# (sass_loops), by source: integer issue bounds them.  `lora_dh_kernel`: the
# dh body before its bf16 tensor-core kernel, for a variant built from an
# earlier checkout.
SASS_REPORTS = {"lora_dropout": r"lora_(fwd_mma|da_mma|dh_mma|dh)_kernel",
                "dropout_keep_mask": r"keep_mask_kernel"}
# SASS opcodes (before the first dot) that issue to the integer pipes
INT_OPS = frozenset(("IADD3", "IMAD", "LOP3", "SHF", "ISETP", "LEA", "PRMT",
                     "SEL", "IABS", "IMNMX", "VIADD", "VIMNMX", "SGXT",
                     "BMSK", "FLO", "POPC", "MOV", "PLOP3", "P2R", "R2P"))


def sass_loops(lib, kernel_re: str) -> dict:
    """The compiled code (`cuobjdump -sass`) of the library's kernels whose
    mangled names match `kernel_re`: each kernel's instruction count and,
    for each loop (the instructions from a backward branch's target to the
    branch, NOPs left out), its length, its instructions for the integer
    pipes (INT_OPS), IMADs, tensor-core products and global stores, and its
    ten most frequent opcodes."""
    from mmoe_multimodal_rec_tpu_torch.ops import cuda_lib
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(kernel_re, m.group(1)) else None
            if name:
                kernels[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if name and m and m.group(2) != "NOP":
            kernels[name].append((int(m.group(1), 16),
                                  m.group(2).split(".")[0], m.group(3)))
    report = {}
    for name, code in kernels.items():
        loops = []
        for pc, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op != "BRA" or not target or int(target.group(1), 16) >= pc:
                continue
            body = [o for at, o, _ in code
                    if int(target.group(1), 16) <= at <= pc]
            ops = {}
            for o in body:
                ops[o] = ops.get(o, 0) + 1
            loops.append({
                "length": len(body),
                "int_pipe": sum(n for o, n in ops.items() if o in INT_OPS),
                "imad": ops.get("IMAD", 0), "hmma": ops.get("HMMA", 0),
                "stg": ops.get("STG", 0),
                "top": sorted(ops.items(), key=lambda kv: -kv[1])[:10]})
        report[name] = {"instructions": len(code), "loops": loops}
    return report


def build_all(names):
    """One nvcc per source, all started together."""
    from mmoe_multimodal_rec_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(cuda_lib.build, names)))
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        text = lib.with_name(lib.name + ".log").read_text()
        extra = {}
        if name in SPILL_CHECKS:
            key, *spec = SPILL_CHECKS[name]
            extra[key] = check_spills(text, *spec)
        if name in SASS_REPORTS:
            extra["sass"] = sass_loops(lib, SASS_REPORTS[name])
        log("build", source=f"csrc/{name}.cu", seconds=seconds,
            library=lib.name, ptxas=ptxas_report(text), **extra)


# ---------------------------------------------------------------------------
# --fwd-variants, --lora-variants: kernels of checkouts timed beside each
# other
# ---------------------------------------------------------------------------

# Built in a checkout, by its own ops/cuda_lib.py; prints the libraries.
FWD_VARIANT_BUILD = """
from mmoe_multimodal_rec_tpu_torch.ops import cuda_lib
print(cuda_lib.build("flash_attention_bwd"))
print(cuda_lib.build("flash_attention_fwd"))
"""

# Run in a checkout by its own chip_smoke.py: the kernel phases' forward
# cases, each held to its plain version, and one line of their times.
FWD_VARIANT_CASES = """
import sys
import torch
import chip_smoke as c
ms, library_ms = {}, {}
gen = torch.Generator(device="cuda").manual_seed(0)
for case, s, masked, rate in (("text", c.TEXT, True, 0.0),
                              ("vit", c.VIT, False, 0.0),
                              ("text_dropout_0.1", c.TEXT, True, 0.1)):
    rec, _ = c.attention_case(case, s["b"], s["l"], s["heads"], s["dh"],
                              s["hb"], masked, rate, gen)
    ms[case], library_ms[case] = rec["ms"], rec["library_ms"]
gen = torch.Generator(device="cuda").manual_seed(2)
s = c.TEXT
for case, rate in (("split_0.1", 0.1), ("split_0", 0.0)):
    rec, _ = c.split_case(case, s["b"], s["l"], s["heads"], s["dh"], rate,
                          gen)
    ms[case], library_ms[case] = rec["fwd_ms"], rec["fwd_library_ms"]
c.log("fwd_variant", label=sys.argv[1], round=int(sys.argv[2]), ms=ms,
      library_ms=library_ms)
"""


# The same for the fused LoRA dropout: its build, and phase_lora_kernels
# (#4-#6 held to their plain versions) with one line of their times.
LORA_VARIANT_BUILD = """
from mmoe_multimodal_rec_tpu_torch.ops import cuda_lib
print(cuda_lib.build("lora_dropout"))
"""

LORA_VARIANT_CASES = """
import sys
import chip_smoke as c
recs, step = c.phase_lora_kernels()
c.log("lora_variant", label=sys.argv[1], round=int(sys.argv[2]),
      ms={k: r["ms"] for k, r in recs.items()},
      host_ms={k: r.get("host_ms") for k, r in recs.items()},
      step_ms={k: r["ms"] for k, r in step.items()})
"""

# The same for #8: its build, and in each checkout phase_keep_mask_kernel
# (every shape bit for bit, per call and per step's calls) plus, measured
# here the same way for every checkout, the main path's two shapes' device
# time, events and host enqueue a call, and a step's 18 calls back to back.
KEEP_MASK_VARIANT_BUILD = """
from mmoe_multimodal_rec_tpu_torch.ops import cuda_lib
print(cuda_lib.build("dropout_keep_mask"))
"""

KEEP_MASK_VARIANT_CASES = """
import sys
import chip_smoke as c
from mmoe_multimodal_rec_tpu_torch.ops import flash_attention as fa
_, step = c.phase_keep_mask_kernel()
cases = {}
for name in ("cross", "fuse"):
    b, h, lq, lk = c.KEEP_MASK_SHAPES[name]
    run = (lambda b=b, h=h, lq=lq, lk=lk: fa.dropout_keep_mask(
        987654321, b, h, lq, lk, 0.1, device="cuda"))
    _, _, by_kind, _ = c.profiled(lambda: [run() for _ in range(50)])
    cases[name] = {"device_ms": by_kind["dropout_keep_mask"] / 50,
                   "ms": c.cuda_ms(run, iters=100, warmup=10),
                   "host_ms": c.host_ms(run)}
c.log("keep_mask_variant", label=sys.argv[1], round=int(sys.argv[2]),
      cases=cases, step_ms=step["ms"], step_calls=step["calls"])
"""

# --<kind>-variants: (build script, cases script, pattern of the kernels
# whose registers and spills the build line reports, their count or None,
# what they are, the pattern of those whose loops it reports or None)
VARIANTS = {
    "fwd": (FWD_VARIANT_BUILD, FWD_VARIANT_CASES, r"attention_fwd_bf16ILi64E",
            3, "dh-64 bf16 forward kernels", None),
    "lora": (LORA_VARIANT_BUILD, LORA_VARIANT_CASES, r"lora_", None,
             "LoRA dropout kernels", SASS_REPORTS["lora_dropout"]),
    "keep-mask": (KEEP_MASK_VARIANT_BUILD, KEEP_MASK_VARIANT_CASES,
                  r"keep_mask_kernel", 2, "keep mask kernels",
                  SASS_REPORTS["dropout_keep_mask"]),
}


def fwd_l2_bytes(pad, b, l, heads, dh, q_tiles: int, skip: bool) -> int:
    """Bytes an attention forward's blocks copy from L2 into shared memory
    (bf16), by design and not measured: each 64-row q tile once, and each
    key tile once a block of `q_tiles` q tiles, every tile of a row or
    (`skip`) those it walks (fwd_work's count)."""
    nt, tile = -(-l // 64), 64 * dh * 2
    walked = (fwd_work(pad, b, l, heads, dh, 2, False)[2] // heads if skip
              else b * nt)
    return heads * (b * nt * tile + -(-nt // q_tiles) * walked * 2 * tile)


def log_fwd_design():
    """fwd_l2_bytes for 1-3 q tiles a block, with and without skipping, at
    the text shape (real lengths uniform over [1, L] and one all-pad row,
    from a CPU generator, seed 0) and the ViT shape, and each as a multiple
    of the call's qkv bytes."""
    import torch
    gen = torch.Generator().manual_seed(0)
    b, l = TEXT["b"], TEXT["l"]
    pad = torch.arange(l)[None, :] >= torch.randint(1, l + 1, (b, 1),
                                                    generator=gen)
    pad[b // 2] = True
    out = {}
    for name, shape, p in (("text", TEXT, pad), ("vit", VIT, None)):
        qkv = 3 * shape["b"] * shape["l"] * shape["heads"] * shape["dh"] * 2
        out[name] = {}
        for q in (1, 2, 3):
            for skip in (False, True):
                n = fwd_l2_bytes(p, shape["b"], shape["l"], shape["heads"],
                                 shape["dh"], q, skip)
                out[name][f"{q} q tile{'s' * (q > 1)}{', skip' * skip}"] = [
                    n, n / qkv]
    log("fwd_design", what="bytes copied from L2 into shared memory and "
        "their multiple of the qkv bytes, computed from each design, not "
        "measured", l2_to_sm_bytes=out)


def phase_variants(kind: str, spec: str, rounds: int = 2):
    """`label=checkout;...`: each checkout of the repo (the parent's, from
    `git archive`, under the git-ignored _parent/, or a copy with an edited
    kernel source; empty: this one) builds the `kind` kernels (VARIANTS) in
    a process of its own, all started together; then, in turns (the listed
    order, then reversed), each runs the kind's cases in another.  Each
    variant's registers and spilled bytes are logged, not checked: a
    variant may spill."""
    build, cases, kernel_re, count, what, sass_re = VARIANTS[kind]
    variants = []
    for item in filter(None, (x.strip() for x in spec.split(";"))):
        label, _, path = item.partition("=")
        variants.append((label, os.path.abspath(path or REPO)))
    builds = [subprocess.Popen([sys.executable, "-c", build],
                               cwd=d, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for _, d in variants]
    for (label, d), proc in zip(variants, builds):
        out = proc.communicate()[0]
        check(proc.returncode == 0, f"variant {label} did not build:\n{out}")
        lib = out.split()[-1]
        with open(lib + ".log") as f:
            report = check_spills(f.read(), kernel_re, count,
                                  f"variant {label}'s {what}", strict=False)
        sass = sass_loops(lib, sass_re) if sass_re else None
        log(f"{kind}_variant_build", label=label, checkout=d, kernels=report,
            sass=sass)
    if kind == "fwd":
        log_fwd_design()
    for r in range(rounds):
        for label, d in variants[::-1] if r % 2 else variants:
            proc = subprocess.run([sys.executable, "-c", cases,
                                   label, str(r + 1)], cwd=d)
            check(proc.returncode == 0, f"variant {label} failed in round "
                                        f"{r + 1}")


def main() -> int:
    if REPO is None:
        print(f"chip_smoke: neither the script's directory nor the working "
              f"directory holds {PACKAGE}/: run it from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    flags = {f"--{kind}-variants": kind for kind in VARIANTS}
    if len(sys.argv) == 3 and sys.argv[1] in flags:
        phase_variants(flags[sys.argv[1]], sys.argv[2])
        print(smi, flush=True)
        return 0
    build_all(("flash_attention_fwd", "flash_attention_bwd", "lora_dropout",
               "dropout_keep_mask"))

    (text, vit, drop), forward = phase_kernels()
    split, split0, split_step = phase_split_kernels()
    lora, lora_step = phase_lora_kernels()
    pbwd, pbwd_text, pbwd_step = phase_packed_bwd_kernel()
    keep, keep_step = phase_keep_mask_kernel()
    pred, launches, serving = phase_predictor(batch=64, forwards=3,
                                              profiled_forwards=2)
    phase_server(pred)
    del pred
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        train_launches, train_prof, ckpt = phase_train()
        phase_train_check()
        home_launches, home_prof, home_ckpt = phase_home_train()
        phase_home_check()
        shards = write_eval_shards()
        phase_eval(ckpt, shards)
        phase_home_eval(home_ckpt, shards)
        phase_pipeline()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    train_ms = train_prof["device_ms_by_kind"]
    home_ms = home_prof["device_ms_by_kind"]
    split_in_path = train_prof["attention_inputs"]["flash_attention"]
    source = "mmoe_multimodal_rec_tpu_torch/csrc/"
    replaces = "mmoe_multimodal_rec_tpu/ops/flash_attention.py:"
    records = [{
        "name": "flash_attention_packed", "route": "cuda",
        "source": f"{source}flash_attention_fwd.cu",
        "replaces": f"{replaces}446",
        "launches": launches,
        "launches_train": train_launches["flash_attention_packed"],
        "launches_home": home_launches["flash_attention_packed"],
        "stats_launches_home":
            home_launches["flash_attention_packed_stats"],
        "max_abs_err": max(text["max_abs_err"], vit["max_abs_err"],
                           drop["max_abs_err"]),
        # per serving forward (24 text + 12 ViT calls).  ms and bound_ms:
        # the kernel's device time in the main path's profiled forwards and
        # the bound of those forwards' inputs; the rest: one forward's worth
        # of calls timed back to back on the kernel phase's inputs, beside
        # their bound (phase_kernels)
        "ms": serving["ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "ms_back_to_back": forward["ms"],
        "bound_back_to_back_ms": forward["bound_ms"],
        "plain_ms": forward["plain_ms"], "library_ms": forward["library_ms"],
        "per_call": {c["case"]: {k: c[k] for k in
                                 ("ms", "plain_ms", "bound_ms",
                                  "library_ms", "max_abs_err")}
                     for c in (text, vit, drop)},
        "vit_fwd_ms": {"serving": pbwd["fwd_serving_ms"],
                       "statistics": pbwd["fwd_stats_ms"]},
    }]
    per_call_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "max_abs_err", "max_err_of_largest_grad")
    for side, wrapper, line, err in (
            ("fwd", "flash_attention", 229,
             max(split["fwd_max_abs_err"], split0["fwd_max_abs_err"])),
            ("bwd", "flash_attention_bwd", 374,
             max(split["bwd_max_abs_err"], split0["bwd_max_abs_err"]))):
        step = split_step[side]
        records.append({
            "name": wrapper, "route": "cuda",
            "source": f"{source}flash_attention_{side}.cu",
            "replaces": f"{replaces}{line}",
            "launches": train_launches[wrapper],
            "max_abs_err": err,
            # per training step (2 micro-batches x 24 calls).  ms and
            # bound_ms: the kernel's device time in the train phase's
            # profiled step and the bound of that step's inputs; the rest:
            # one step's worth of calls timed back to back on the kernel
            # phase's inputs, beside their bound (phase_split_kernels)
            "ms": train_ms[wrapper],
            "bound_ms": split_in_path[side]["bound_ms"],
            "bound_by": split_in_path[side]["bound_by"],
            "ms_back_to_back": step["ms"],
            "bound_back_to_back_ms": step["bound_ms"],
            "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
            **{name: {k: rec[f"{side}_{k}"] for k in per_call_keys
                      if f"{side}_{k}" in rec}
               for name, rec in (("per_call", split),
                                 ("per_call_rate_0", split0))}})
    for wrapper, line in (("lora_dropout_fwd", 170), ("lora_dropout_da", 199),
                          ("lora_dropout_dh", 232)):
        rec, step = lora[wrapper], lora_step[wrapper]
        records.append({
            "name": wrapper, "route": "cuda",
            "source": f"{source}lora_dropout.cu",
            "replaces": f"mmoe_multimodal_rec_tpu/ops/lora_dropout.py:{line}",
            "launches": train_launches[wrapper],
            "launches_home": home_launches[wrapper],
            "max_abs_err": rec["max_abs_err"],
            # per training step (step["calls"] calls).  ms: the kernel's
            # device time in the train phase's profiled step; the rest: one
            # step's worth of calls timed back to back (phase_lora_kernels)
            "ms": train_ms[wrapper], "ms_back_to_back": step["ms"],
            "plain_ms": step["plain_ms"], "library_ms": None,
            "bound_ms": step["bound_ms"], "bound_by": rec["bound_by"],
            "per_call": {k: rec[k] for k in ("ms", "device_ms", "host_ms",
                                             "plain_ms", "bound_ms",
                                             "max_abs_err",
                                             "err_of_largest")}})
    records.append({
        "name": "flash_attention_packed_bwd", "route": "cuda",
        "source": f"{source}flash_attention_bwd.cu",
        "replaces": f"{replaces}491",
        "launches": home_launches["flash_attention_packed_bwd"],
        "max_abs_err": max(pbwd["max_abs_err"], pbwd_text["max_abs_err"]),
        # per HoME training step (2 layers x 2 micro-batches).  ms: the
        # kernel's device time in home_train's profiled step; the rest: one
        # step's worth of calls at the ViT shape timed back to back
        "ms": home_ms["flash_attention_packed_bwd"],
        "ms_back_to_back": pbwd_step["ms"],
        "plain_ms": pbwd_step["plain_ms"],
        "library_ms": pbwd_step["library_ms"],
        "bound_ms": pbwd_step["bound_ms"], "bound_by": pbwd["bound_by"],
        "per_call": {k: pbwd[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "max_abs_err")}})
    records.append({
        "name": "dropout_keep_mask", "route": "cuda",
        "source": f"{source}dropout_keep_mask.cu",
        "replaces": f"{replaces}606",
        "launches": train_launches["dropout_keep_mask"],
        "launches_home": home_launches["dropout_keep_mask"],
        "max_abs_err": max(c["max_abs_err"] for c in keep.values()),
        # per training step (keep_step["calls"] calls).  ms: the kernel's
        # device time in the train phase's profiled step; the rest: one
        # step's worth of calls timed back to back (phase_keep_mask_kernel)
        "ms": train_ms["dropout_keep_mask"],
        "ms_back_to_back": keep_step["ms"],
        "plain_ms": keep_step["plain_ms"], "library_ms": None,
        "bound_ms": keep_step["bound_ms"], "bound_by": "bytes",
        "per_call": {k: {f: c[f] for f in ("ms", "device_ms", "host_ms",
                                           "plain_ms", "bound_ms",
                                           "max_abs_err")}
                     for k, c in keep.items()}})
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
