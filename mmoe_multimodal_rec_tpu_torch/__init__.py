"""mmoe_multimodal_rec_tpu_torch — the PyTorch + CUDA port of
mmoe_multimodal_rec_tpu for NVIDIA Hopper (H100).

Module paths and class names mirror the JAX package, so each module's
counterpart is easy to find; nothing here imports jax or the JAX package.
Ported so far:

- config, host text packing, the shard data path and the offline
  pipeline (copies of the JAX package's jax-free modules, with the
  native WordPiece tokenizer)                           -> `config.py`,
                                                           `data/`, `native/`
- every Pallas kernel of the JAX package as a hand-written CUDA kernel
  for sm_90a, with its plain PyTorch version: packed and split attention
  forward and backward with in-kernel dropout, the fused LoRA dropout
  (forward, dA, dh), the short attentions' keep mask    -> `ops/`, `csrc/`
- the baseline and HoME models with their dropout sites, per-layer
  recompute under the six remat policies, the shared text base and the
  top-k gate                                            -> `models/`
- losses, optimizer groups, the accumulated step, the
  Trainer, checkpoints, preemption                      -> `train/`
- evaluation with HoME BatchNorm recalibration, the Predictor and the
  HTTP server                                           -> `eval/`
- LoRA merge, JAX param, shared-base and scan-layers conversion,
  reference checkpoints, metrics logging                -> `utils/`
- data and tensor parallelism over torch.distributed (the JAX
  `data` x `model` mesh; `train --multihost` under torchrun) -> `parallel/`
- the JAX CLI's twelve commands                         -> `cli.py`
"""

__version__ = "0.1.0"
