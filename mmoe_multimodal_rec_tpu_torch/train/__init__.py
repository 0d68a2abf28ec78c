"""Training: losses, optimizer groups, the accumulated step, the epoch
loop, checkpoints and preemption (port of mmoe_multimodal_rec_tpu/train)."""
