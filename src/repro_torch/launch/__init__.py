"""Command-line entry points of the port: ``profile_offline`` (the
offline Bayesian profiling of the strategy space), ``serve`` (the
controller over the one-shot PD engine) and ``train`` (training with
checkpoints and optional gradient compression)."""
