#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits non-zero without the final result line:
  1. device: name, count, and name + power limit from nvidia-smi;
  2. build: every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  3. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes (bf16 in, the plain version in fp32 on the same inputs),
     with the kernel's, the plain version's and the library call's times
     (CUDA events, warm) beside the bound computed from the inputs, per
     call and for one forward's worth of calls timed back to back;
  4. predictor: the full-width Predictor (batch 64, 2 chunks per sample,
     BERT-base x2 + ViT-base, bf16 compute, seeded init weights) scores a
     few batches on the host clock (and, apart, the host packing of their
     texts), then two more under torch.profiler: device time by kind, the
     kernel's device ms per forward and the device's busy share.  The
     kernel launch counts of that run are checked, the probabilities must
     be finite, in (0, 1), and agree with the same model on the plain
     attention path; a small fp32 model must agree with the same model on
     the CPU;
  5. server: PredictionServer on 127.0.0.1 answers concurrent POSTs (some
     with patch_b64) equal to direct predict().
Then one JSON line of kernel records, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.  Needs one card; exits non-zero
without one, and outside a checkout of the repository.
"""
from __future__ import annotations

import base64
import http.client
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
KERNEL_TOL = 2e-2               # bf16 output vs the fp32 plain version
FP32_KERNEL_TOL = 1e-4          # fp32 kernel: summation order, expf
PLAIN_PATH_TOL = 1e-2           # probabilities, kernel vs plain attention
SMALL_CPU_TOL = 1e-4            # probabilities, fp32 model, GPU vs CPU
SERVER_TOL = 2e-3               # probabilities, micro-batched vs direct
TEXT = dict(b=128, l=384, heads=12, dh=64, hb=6, calls=24)
VIT = dict(b=64, l=197, heads=12, dh=64, hb=6, calls=12)


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
        io_bytes = (qkv.numel() * qkv.element_size() + b * l * d
                    * qkv.element_size() + (b * l if masked else 0))
        flops = 4 * b * l * l * d
        rec.update(
            ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, iters=3, warmup=1),
            library_ms=cuda_ms(library),
            bound_ms=1e3 * max(io_bytes / HBM_BYTES_PER_S,
                               flops / BF16_FLOPS_PER_S),
            bound_by=("bytes" if io_bytes / HBM_BYTES_PER_S
                      >= flops / BF16_FLOPS_PER_S else "operations"),
            io_bytes=io_bytes, flops=flops)
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
    low = kernel_name.lower()
    if "packed_attention_fwd" in low:
        return "attention_kernel"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "matmul"
    return "other"


def profiled(pred, batches):
    """Score `batches` under torch.profiler: device ms by kind and the top
    kernels, summed over the window, and the window's host-clock ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    outs = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for users, items, patches, has_image in batches:
            outs.append(pred.predict(users, items, patches, has_image))
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
    device's busy share."""
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
    fa.flash_attention_packed.launches = 0
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
    prof_outs, window_ms, by_kind, top = profiled(pred, batches[forwards:])
    outs += prof_outs
    launches = fa.flash_attention_packed.launches
    peak = torch.cuda.max_memory_allocated()
    n_fwd = forwards + profiled_forwards + len(pred.buckets)
    kernel_ms = by_kind.get("attention_kernel", 0.0) / profiled_forwards
    check(kernel_ms > 0, "the profiler saw no attention kernel time")
    device_ms = sum(by_kind.values())
    log("profile", requests=profiled_forwards, window_ms=window_ms,
        device_ms_per_request=device_ms / profiled_forwards,
        device_busy_share=device_ms / window_ms,
        device_ms_per_request_by_kind={
            k: v / profiled_forwards for k, v in by_kind.items()},
        top_kernels_ms_per_request=[(k, v / profiled_forwards)
                                    for k, v in top])
    check(launches == 36 * n_fwd,
          f"flash_attention_packed launched {launches} times in {n_fwd} "
          f"forwards, expected 36 per forward")
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
        kernel_vs_plain_path_max_prob_diff=plain_err,
        small_fp32_gpu_vs_cpu_max_prob_diff=small_err,
        prob_good_mean=float(np.mean([o["prob_good"] for o in outs])))
    return pred, launches, kernel_ms


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mmoe_multimodal_rec_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = cuda_lib.build("flash_attention_packed")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             lib.with_name(lib.name + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=build_s, library=lib.name, ptxas=ptxas)

    (text, vit, drop), forward = phase_kernels()
    pred, launches, kernel_ms = phase_predictor(batch=64, forwards=3,
                                                profiled_forwards=2)
    phase_server(pred)

    calls = lambda key: TEXT["calls"] * text[key] + VIT["calls"] * vit[key]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_packed", "route": "cuda",
        "source": "mmoe_multimodal_rec_tpu_torch/csrc/"
                  "flash_attention_packed.cu",
        "replaces": "mmoe_multimodal_rec_tpu/ops/flash_attention.py:446",
        "launches": launches,
        "max_abs_err": max(text["max_abs_err"], vit["max_abs_err"],
                           drop["max_abs_err"]),
        # per forward (24 text + 12 ViT calls).  ms: the kernel's device
        # time in the main path's profiled forwards; the rest: one
        # forward's worth of calls timed back to back (phase_kernels)
        "ms": kernel_ms, "ms_back_to_back": forward["ms"],
        "plain_ms": forward["plain_ms"], "library_ms": forward["library_ms"],
        "bound_ms": forward["bound_ms"],
        "bound_by": ("bytes" if calls("io_bytes") / HBM_BYTES_PER_S
                     >= calls("flops") / BF16_FLOPS_PER_S else "operations"),
        "per_call": {c["case"]: {k: c[k] for k in
                                 ("ms", "plain_ms", "bound_ms",
                                  "library_ms", "max_abs_err")}
                     for c in (text, vit, drop)},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
