"""Training steps, the optimizer and the cross-pod paths (KV migration and
gradient sync with the quantizer fused in), in PyTorch."""
from repro_torch.distribution.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.distribution.steps import (
    loss_fn,
    make_decode_step,
    make_eval_step,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "OptConfig", "adamw_update", "init_opt_state", "loss_fn",
    "make_decode_step", "make_eval_step", "make_prefill_step",
    "make_train_step",
]
