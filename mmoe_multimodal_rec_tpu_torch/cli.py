"""Command-line entry point of the PyTorch port: `synth`, `train`, `eval`,
`serve`.

  python -m mmoe_multimodal_rec_tpu_torch synth --output=shards --samples=48
  python -m mmoe_multimodal_rec_tpu_torch train \\
      --data.train_pattern='shards/*.tar.gz' --data.allow_hash_tokenizer=true
      (add --model.variant=home for the HoME model)
  python -m mmoe_multimodal_rec_tpu_torch eval \\
      --data.valid_pattern='shards/*.tar.gz' --data.allow_hash_tokenizer=true
      (HoME: add --recalibrate-bn)
  python -m mmoe_multimodal_rec_tpu_torch serve --batch-size=64 \\
      --data.allow_hash_tokenizer=true

Each takes the JAX CLI's flags and dotted config overrides; `train`,
`eval` and `serve` also take `--device` (default cuda, which raises
without a card; cpu runs the plain PyTorch path).  `train` writes the
port's own torch checkpoints and resumes from them.  `eval` and `serve`
load the port's checkpoints (`--checkpoint`, else train.checkpoint_dir) or
a reference torch .pt (`--reference-ckpt`); with neither they score seeded
init weights, as the JAX CLI does when it finds no checkpoint.  The JAX
trainer's orbax checkpoints are refused: reading them needs a design first.
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


COMMANDS = {"synth": cmd_synth, "train": cmd_train, "eval": cmd_eval,
            "serve": cmd_serve}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m mmoe_multimodal_rec_tpu_torch "
              f"{{{','.join(COMMANDS)}}} [flags]")
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
