from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    plan_stack,
    prefill,
)
from repro_torch.models.io import make_inputs, make_inputs_for_shape

__all__ = ["decode_step", "forward", "init_cache", "init_params", "plan_stack",
           "prefill", "make_inputs", "make_inputs_for_shape"]
