"""Training: losses, optimizer groups, the accumulated step, the epoch
loop, checkpoints and preemption (port of mmoe_multimodal_rec_tpu/train;
the JAX package's TrainState, init_model_variables, merge_params and
param_labels are pytree plumbing that torch modules and optimizers hold
themselves)."""
from .checkpoint import CheckpointManager
from .loop import Trainer, dummy_batch, stack_micro_batches, train_from_config
from .losses import contrastive_loss, total_loss, weighted_bce_with_logits
from .optimizer import label_param, make_optimizer, split_trainable
from .preemption import PreemptionGuard
from .step import make_bn_recalibration_step, make_eval_step, make_train_step

__all__ = [
    "CheckpointManager", "Trainer", "dummy_batch", "stack_micro_batches",
    "train_from_config", "contrastive_loss", "total_loss",
    "weighted_bce_with_logits", "label_param", "make_optimizer",
    "split_trainable", "make_bn_recalibration_step", "make_eval_step",
    "make_train_step", "PreemptionGuard",
]
