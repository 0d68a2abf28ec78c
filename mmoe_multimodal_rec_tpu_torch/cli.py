"""Command-line entry point of the PyTorch port: `synth`, `train`, `serve`.

  python -m mmoe_multimodal_rec_tpu_torch synth --output=shards --samples=48
  python -m mmoe_multimodal_rec_tpu_torch train \\
      --data.train_pattern='shards/*.tar.gz' --data.allow_hash_tokenizer=true
      (add --model.variant=home for the HoME model)
  python -m mmoe_multimodal_rec_tpu_torch serve --batch-size=64 \\
      --data.allow_hash_tokenizer=true

Each takes the JAX CLI's flags and dotted config overrides; `train` and
`serve` also take `--device` (default cuda; cpu runs the plain PyTorch
path).  `train` writes the port's own torch checkpoints and resumes from
them.  `serve` does not load a checkpoint yet (orbax, reference .pt or the
port's): with none it scores with seeded init weights, as the JAX CLI does
when it finds none.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .config import Config


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
                    help="multi-host training (not yet ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the plain "
                         "PyTorch path)")
    cfg_flags, rest = _split_flags(argv)
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)
    if args.multihost:
        raise NotImplementedError("--multihost is not yet ported")
    from .train.loop import train_from_config
    result = train_from_config(cfg, device=args.device)
    print(json.dumps({"examples_per_sec": result["examples_per_sec"],
                      "epoch_losses": result["epoch_losses"]["total"]}))
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
                    help="HoME BatchNorm recalibration (not yet ported)")
    ap.add_argument("--recal-samples", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                         "PyTorch path)")
    cfg_flags, rest = _split_flags(argv)
    args = ap.parse_args(rest)
    cfg = Config.from_flags(cfg_flags)

    if args.checkpoint or args.reference_ckpt:
        raise NotImplementedError("loading a checkpoint (--checkpoint / "
                                  "--reference-ckpt) is not yet ported")
    ckpt_dir = cfg.train.checkpoint_dir
    if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        raise NotImplementedError(f"train.checkpoint_dir {ckpt_dir!r} holds "
                                  "a checkpoint, and loading one is not yet "
                                  "ported")
    if args.recalibrate_bn:
        raise NotImplementedError("--recalibrate-bn (HoME) is not yet ported")

    from .eval.predict import Predictor
    from .eval.server import PredictionServer

    print("[serve] WARNING: no checkpoint found, using init weights",
          flush=True)
    buckets = ([int(x) for x in args.buckets.split(",")]
               if args.buckets else None)
    predictor = Predictor(cfg, batch_size=args.batch_size,
                          merge_lora=not args.no_merge_lora,
                          buckets=buckets, device=args.device)
    print(f"[serve] warmup (buckets {predictor.buckets})...", flush=True)
    predictor.warmup()
    server = PredictionServer(
        predictor, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms,
        model_info={"variant": cfg.model.variant, "step": 0,
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


COMMANDS = {"synth": cmd_synth, "train": cmd_train, "serve": cmd_serve}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m mmoe_multimodal_rec_tpu_torch "
              f"{{{','.join(COMMANDS)}}} [flags]")
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
