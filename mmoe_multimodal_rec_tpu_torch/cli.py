"""Command-line entry point of the PyTorch port: the JAX CLI's twelve
commands.  `train`, `eval` and `serve` run the model; the offline data path
runs on the host:

  ingest-meta / ingest-reviews  ~ meta2gcs.py / review2gcs.py (network)
  features       ~ data4moe_beam.py: raw JSONL -> per-split feature rows
  patches        ~ newpatch.py: image URLs -> patch JSONL (network, PIL, httpx)
  build-dataset  ~ data4model.py: feature rows (+ patches) -> tar shards
  pretokenize    token sidecars baked into shards (data/pretokenize.py)
  validate       drop/degradation report over shards (exit 3 on a drop)
  ckpt-info      the port's checkpoint directory, without building a model
  synth          synthetic shards for smoke runs

  python -m mmoe_multimodal_rec_tpu_torch synth --output=shards --samples=48
  python -m mmoe_multimodal_rec_tpu_torch train \\
      --data.train_pattern='shards/*.tar.gz' --data.allow_hash_tokenizer=true
      (add --model.variant=home for the HoME model)
  python -m mmoe_multimodal_rec_tpu_torch eval \\
      --data.valid_pattern='shards/*.tar.gz' --data.allow_hash_tokenizer=true
      (HoME: add --recalibrate-bn)
  python -m mmoe_multimodal_rec_tpu_torch serve --batch-size=64 \\
      --data.allow_hash_tokenizer=true

`train --multihost` is one process of a torchrun launch (one per GPU):

  python -m torch.distributed.run --nproc_per_node=4 \\
      -m mmoe_multimodal_rec_tpu_torch train --multihost \\
      --train.mesh.data_parallel=2 --train.mesh.model_parallel=2 ...

Each takes the JAX CLI's flags and dotted config overrides; `train`,
`eval` and `serve` also take `--device` (default cuda, which raises
without a card; cpu runs the plain PyTorch path).  `train` writes the
port's own torch checkpoints and resumes from them.  `eval` and `serve`
load the port's checkpoints (`--checkpoint`, else train.checkpoint_dir) or
a reference torch .pt (`--reference-ckpt`); with neither they score seeded
init weights, as the JAX CLI does when it finds no checkpoint.  The JAX
trainer's orbax checkpoints are refused with the command that converts
them (tools/orbax_to_torch.py, run where the JAX package is installed):

  python tools/orbax_to_torch.py --checkpoint=<JAX checkpoint_dir> \\
      --output=<dir> [--step=N] <the run's --key=value model flags>
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .config import Config
from .data.io import fs_glob, fs_open


def _split_flags(argv: List[str]):
    """Separate --a.b=c config overrides from plain args."""
    cfg_flags, rest = [], []
    for a in argv:
        (cfg_flags if (a.startswith("--") and "=" in a and
                       "." in a.split("=")[0]) else rest).append(a)
    return cfg_flags, rest


def cmd_synth(argv: List[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--samples-per-shard", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--signal", action="store_true",
                    help="plant an 85%%-correlated sentiment cue in the "
                         "user text so label_good is learnable from text")
    args = ap.parse_args(argv)
    from .data.synthetic import write_synthetic_shards
    paths = write_synthetic_shards(args.output, args.samples,
                                   args.samples_per_shard, args.seed,
                                   signal=args.signal)
    print(json.dumps({"shards": len(paths)}))
    return 0


def cmd_train(argv: List[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multihost", action="store_true",
                    help="one process of a torchrun launch: join its "
                         "torch.distributed group (NCCL on cuda:LOCAL_RANK, "
                         "gloo with --device=cpu) and train on the mesh of "
                         "--train.mesh.*")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the plain "
                         "PyTorch path)")
    cfg_flags, rest = _split_flags(argv)
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)
    from .train.loop import train_from_config
    if not args.multihost:
        result = train_from_config(cfg, device=args.device)
        chief = True
    else:
        import torch.distributed as dist

        from .parallel.mesh import init_distributed
        device = init_distributed(args.device)
        try:
            result = train_from_config(cfg, device=device)
            chief = dist.get_rank() == 0
        finally:
            dist.destroy_process_group()
    if chief:
        print(json.dumps({"examples_per_sec": result["examples_per_sec"],
                          "epoch_losses": result["epoch_losses"]["total"]}))
    return 0


def _inference_model(cfg: Config, checkpoint: Optional[str],
                     reference_ckpt: Optional[str], tag: str,
                     device="cuda"):
    """The unmerged model for eval and serving, on `device`: the port's own
    checkpoint (`checkpoint`, else train.checkpoint_dir), or a reference
    torch .pt converted on the fly over seeded init weights, or the seeded
    init weights alone when there is no checkpoint.  Returns (model,
    optimizer steps of the checkpoint, 0 without one).  Mirrors the JAX
    CLI's `_restore_for_inference`."""
    import torch

    from .models.layers import init_weights
    from .models.mmoe import DTYPES, MMoERecModel
    from .train.checkpoint import CheckpointManager, check_not_orbax
    from .utils.hf_convert import load_reference_checkpoint

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device=cpu to run the "
                           "plain PyTorch path")
    directory = checkpoint or cfg.train.checkpoint_dir
    if reference_ckpt:
        if not os.path.isfile(reference_ckpt):
            raise FileNotFoundError(f"--reference-ckpt {reference_ckpt!r} "
                                    "is not a file")
    else:
        if checkpoint and not os.path.isdir(checkpoint):
            raise FileNotFoundError(f"--checkpoint {checkpoint!r} is not a "
                                    "directory")
        check_not_orbax(directory)
    model = MMoERecModel(cfg.model)
    step = 0
    if reference_ckpt:
        # what the reference checkpoint lacks keeps the seeded init
        init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
        # tensors and plain containers only: the file comes from outside
        ckpt = torch.load(reference_ckpt, map_location="cpu",
                          weights_only=True)
        load_reference_checkpoint(model, ckpt, cfg.model,
                                  log=lambda line: print(line, flush=True))
        print(f"[{tag}] loaded reference checkpoint {reference_ckpt}",
              flush=True)
    else:
        # the port's own checkpoints hold every tensor (a strict load)
        restored = CheckpointManager(directory).restore_model(model)
        if restored is None:
            init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
            print(f"[{tag}] WARNING: no checkpoint found, using init "
                  "weights", flush=True)
        else:
            step = restored
            print(f"[{tag}] restored step={step}", flush=True)
    model.to(device=device, dtype=DTYPES[cfg.model.param_dtype])
    return model, step


def cmd_eval(argv: List[str]) -> int:
    """AUC over data.valid_pattern (eval/evaluate.py); HoME recalibrates
    its BatchNorm statistics first with --recalibrate-bn."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="the port's checkpoint dir (defaults to "
                         "train.checkpoint_dir)")
    ap.add_argument("--reference-ckpt", type=str, default=None,
                    help="torch .pt checkpoint in the reference layout "
                         "(train.py:351-363), converted on the fly")
    ap.add_argument("--recalibrate-bn", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to evaluate on (cpu runs the plain "
                         "PyTorch path)")
    cfg_flags, rest = _split_flags(argv)
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)

    from .eval.evaluate import evaluate_from_config

    model, _ = _inference_model(cfg, args.checkpoint, args.reference_ckpt,
                                "eval", args.device)
    res = evaluate_from_config(cfg, model, recalibrate=args.recalibrate_bn)
    print(json.dumps({"auc_good": res["good"], "auc_best": res["best"],
                      "n": res["n"]}))
    return 0


def cmd_serve(argv: List[str]) -> int:
    """Online prediction server over the LoRA-merged forward
    (eval/server.py): /v1/predict, /healthz, /varz."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--reference-ckpt", type=str, default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="serving batch shape (default train.batch_size)")
    ap.add_argument("--buckets", type=str, default=None,
                    help="comma-separated ascending batch buckets (e.g. "
                         "4,16,64): small requests pad to the smallest "
                         "fitting bucket instead of the full batch")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="micro-batching window for coalescing concurrent "
                         "requests into one device batch")
    ap.add_argument("--no-merge-lora", action="store_true")
    ap.add_argument("--recalibrate-bn", action="store_true",
                    help="refresh HoME BatchNorm running stats over "
                         "data.valid_pattern before serving (same pass as "
                         "eval --recalibrate-bn)")
    ap.add_argument("--recal-samples", type=int, default=None,
                    help="cap the recalibration stream at this many samples "
                         "(default: one full pass over data.valid_pattern)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                         "PyTorch path)")
    cfg_flags, rest = _split_flags(argv)
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)

    from .eval.predict import Predictor
    from .eval.server import PredictionServer

    shards = None
    if args.recalibrate_bn:
        from .data.io import fs_glob
        shards = fs_glob(cfg.data.valid_pattern)
        if not shards:
            raise FileNotFoundError(
                f"--recalibrate-bn needs data.valid_pattern shards "
                f"(no match for {cfg.data.valid_pattern!r})")
    model, step = _inference_model(cfg, args.checkpoint, args.reference_ckpt,
                                   "serve", args.device)
    if shards:
        from .data.packer import packer_from_config
        from .eval.evaluate import recalibrate_bn
        print("[serve] recalibrating BatchNorm running stats...", flush=True)
        recalibrate_bn(cfg, model, shards, packer_from_config(cfg),
                       total_samples=args.recal_samples,
                       bn_batch_size=cfg.train.batch_size)
    buckets = ([int(x) for x in args.buckets.split(",")]
               if args.buckets else None)
    predictor = Predictor(cfg, state=model.state_dict(),
                          batch_size=args.batch_size,
                          merge_lora=not args.no_merge_lora,
                          buckets=buckets, device=args.device)
    del model
    print(f"[serve] warmup (buckets {predictor.buckets})...", flush=True)
    predictor.warmup()
    server = PredictionServer(
        predictor, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms,
        model_info={"variant": cfg.model.variant, "step": step,
                    "lora_merged": not args.no_merge_lora})
    print(json.dumps({"serving": f"{args.host}:{server.port}",
                      "batch_size": predictor.batch_size}), flush=True)
    # graceful SIGTERM: stop accepting, drain in-flight scoring, exit 0.
    # shutdown() blocks until serve_forever() returns, so it must run off
    # the serving thread (the handler fires on the same main thread).
    import signal
    import threading

    def _stop(signum, frame):
        threading.Thread(target=server.httpd.shutdown, daemon=True).start()

    prev = signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.shutdown()
    return 0


def _read_jsonl(pattern: str, skip_bad: bool = False):
    """The records of every JSONL(.gz) file matching `pattern`."""
    import gzip
    import io
    for path in fs_glob(pattern):
        raw = fs_open(path, "rb")
        with (gzip.open(raw, "rt") if path.endswith(".gz")
              else io.TextIOWrapper(raw)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    if not skip_bad:
                        raise


def cmd_features(argv: List[str]) -> int:
    """Meta x reviews -> causal feature rows by split and category, plus the
    items' image URLs (data/features.py)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--meta", required=True, help="meta jsonl(.gz) glob")
    ap.add_argument("--reviews", required=True, help="review jsonl(.gz) glob")
    ap.add_argument("--output", required=True)
    ap.add_argument("--train-end", default="2023-06-30")
    ap.add_argument("--valid-end", default="2023-09-30")
    ap.add_argument("--neg-k", type=int, default=5)
    ap.add_argument("--rate-5", type=float, default=0.2)
    args = ap.parse_args(argv)

    from .data.features import run_feature_pipeline, write_split_jsonl
    split_rows, image_urls = run_feature_pipeline(
        _read_jsonl(args.meta, skip_bad=True),
        _read_jsonl(args.reviews, skip_bad=True),
        args.train_end, args.valid_end, args.neg_k, args.rate_5)
    paths = write_split_jsonl(split_rows, args.output)
    with fs_open(os.path.join(args.output, "image_urls.jsonl"), "w") as f:
        for rec in image_urls:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps({"splits": sorted({s for _, s in split_rows}),
                      "files": len(paths), "image_urls": len(image_urls)}))
    return 0


def cmd_build_dataset(argv: List[str]) -> int:
    """Feature rows of one split (+ optional patch records) -> tar shards
    (data/textbuild.py)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", required=True,
                    help="feature-row jsonl glob (one split)")
    ap.add_argument("--patches", default=None,
                    help="patch jsonl(.gz) glob (optional)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--samples-per-shard", type=int, default=1024)
    args = ap.parse_args(argv)

    rows_by_asin = {}
    for row in _read_jsonl(args.rows):
        rows_by_asin.setdefault(row.get("parent_asin"), []).append(row)
    patches_by_asin = {}
    if args.patches:
        for rec in _read_jsonl(args.patches):
            patches_by_asin[rec["parent_asin"]] = rec

    from .data.textbuild import write_dataset
    paths = write_dataset(rows_by_asin, patches_by_asin, args.output,
                          args.samples_per_shard)
    print(json.dumps({"shards": len(paths)}))
    return 0


def cmd_patches(argv: List[str]) -> int:
    """Image URLs -> 16x16 patch records (data/patches.py; needs network,
    httpx and PIL)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="image-url jsonl glob")
    ap.add_argument("--output", required=True, help="output jsonl.gz path")
    args = ap.parse_args(argv)
    from .data.patches import fetch_patches, write_patch_jsonl
    n = write_patch_jsonl(fetch_patches(_read_jsonl(args.input)),
                          args.output)
    print(json.dumps({"patches": n}))
    return 0


def cmd_ingest(argv: List[str], kind: str) -> int:
    """Amazon Reviews 2023 meta or reviews from the HF hub -> gzip JSONL
    shards (data/ingest.py; needs network and huggingface_hub/datasets)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True)
    ap.add_argument("--split", default="Sports_and_Outdoors")
    ap.add_argument("--shard-size", type=int,
                    default=100_000 if kind == "meta" else 300_000)
    args = ap.parse_args(argv)
    from .data import ingest
    fn = ingest.ingest_meta if kind == "meta" else ingest.ingest_reviews
    paths = fn(args.output, args.split, args.shard_size)
    print(json.dumps({"shards": len(paths)}))
    return 0


def cmd_pretokenize(argv: List[str]) -> int:
    """Bake sentence-token sidecars into shards (data/pretokenize.py) so
    the train/eval loaders skip sentence splitting + WordPiece entirely
    (the reference's stated future work, README.md:670)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="input shard glob")
    ap.add_argument("--output", required=True, help="output shard dir")
    cfg_flags, rest = _split_flags(argv)
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)

    from .data.packer import packer_from_config
    from .data.pretokenize import pretokenize_shards

    paths = pretokenize_shards(args.input, args.output,
                               packer_from_config(cfg))
    print(json.dumps({"shards": len(paths)}))
    return 0


def cmd_validate(argv: List[str]) -> int:
    """Scan shards and report drop/degradation reasons + label/image stats.
    The loaders (and the reference, train.py:54) drop malformed samples
    silently; this surfaces what a training run would quietly lose.
    Exits 3 when a sample would be dropped."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="shard glob")
    ap.add_argument("--limit", type=int, default=0,
                    help="stop after N samples (0 = all)")
    args = ap.parse_args(argv)

    import itertools
    from collections import Counter

    from .data.decode import decode_sample, explain_sample
    from .data.tar_io import iter_shard

    shards = fs_glob(args.input)
    if not shards:
        raise FileNotFoundError(f"no shards match {args.input!r}")
    reasons: Counter = Counter()
    degraded: Counter = Counter()
    n = ok = has_img = pretok = 0
    pos_good = pos_best = 0.0
    samples = itertools.chain.from_iterable(iter_shard(p) for p in shards)
    if args.limit:
        samples = itertools.islice(samples, args.limit)
    for sample in samples:
        n += 1
        rep = explain_sample(sample)
        if rep["status"] == "ok":
            ok += 1
            dec = decode_sample(sample)
            if dec is not None:
                has_img += dec["has_image"]
                pos_good += dec["label_good"]
                pos_best += dec["label_best"]
                pretok += int("user_sents" in dec)
        else:
            reasons[rep["reason"]] += 1
        for d in rep["degraded"]:
            degraded[d] += 1
    print(json.dumps({
        "shards": len(shards), "samples": n, "ok": ok, "dropped": n - ok,
        "drop_reasons": dict(reasons), "degraded": dict(degraded),
        "has_image_rate": round(has_img / ok, 4) if ok else None,
        "pretokenized_rate": round(pretok / ok, 4) if ok else None,
        "label_good_pos_rate": round(pos_good / ok, 4) if ok else None,
        "label_best_pos_rate": round(pos_best / ok, 4) if ok else None,
    }))
    return 0 if n == ok else 3


def cmd_ckpt_info(argv: List[str]) -> int:
    """Inspect the port's checkpoint directory (train/checkpoint.py's
    layout) without building a model: steps present, resume position,
    payload composition, frozen-base fingerprint.  The payloads are read
    with torch.load(weights_only=True); an orbax directory of the JAX
    trainer is refused with the converter's command."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="the port's checkpoint dir (defaults to "
                         "train.checkpoint_dir)")
    cfg_flags, rest = _split_flags(argv)
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)

    import torch

    from .train.checkpoint import CheckpointManager, check_not_orbax

    directory = os.path.abspath(args.checkpoint or cfg.train.checkpoint_dir)
    if not os.path.isdir(directory):
        raise FileNotFoundError(directory)
    check_not_orbax(directory)
    mngr = CheckpointManager(directory)
    steps = mngr.all_steps()
    info = {"directory": directory, "steps": steps,
            "latest_step": steps[-1] if steps else None}
    fp_path = os.path.join(directory, "frozen_once.fingerprint.json")
    if os.path.exists(fp_path):
        with open(fp_path) as f:
            info["frozen_fingerprint"] = json.load(f)["sha256"][:16]
        info["frozen_once"] = os.path.isfile(
            os.path.join(directory, "frozen_once.pt"))
    if steps:
        saved = torch.load(mngr._path(steps[-1]), map_location="cpu",
                           weights_only=True)
        extra = saved.get("extra", {})
        info["resume"] = {k: int(v) for k, v in extra.items()}
        counts, nbytes = {}, {}
        for part, key in (("trainable", "trainable"),
                          ("batch_stats", "batch_stats"),
                          ("opt_state", "optimizer")):
            leaves = _tensor_leaves(saved.get(key) or {})
            counts[part] = sum(t.numel() for t in leaves)
            nbytes[part] = sum(t.numel() * t.element_size() for t in leaves)
        info["param_counts"] = counts
        info["payload_mb"] = {k: round(v / 1e6, 1) for k, v in nbytes.items()}
    print(json.dumps(info))
    return 0


def _tensor_leaves(tree) -> list:
    """Every tensor in a nest of dicts, lists and tuples."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensor_leaves(x)]
    return []


COMMANDS = {
    "train": cmd_train,
    "eval": cmd_eval,
    "features": cmd_features,
    "build-dataset": cmd_build_dataset,
    "patches": cmd_patches,
    "ingest-meta": lambda a: cmd_ingest(a, "meta"),
    "ingest-reviews": lambda a: cmd_ingest(a, "reviews"),
    "synth": cmd_synth,
    "serve": cmd_serve,
    "pretokenize": cmd_pretokenize,
    "validate": cmd_validate,
    "ckpt-info": cmd_ckpt_info,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m mmoe_multimodal_rec_tpu_torch "
              f"{{{','.join(COMMANDS)}}} [flags]")
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
