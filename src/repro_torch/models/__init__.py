from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    plan_stack,
    prefill,
)

__all__ = ["decode_step", "forward", "init_cache", "init_params", "plan_stack",
           "prefill"]
