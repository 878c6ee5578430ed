"""Command-line entry points of the port: ``profile_offline`` (the
offline Bayesian profiling of the strategy space), ``serve`` (the
controller over the one-shot PD engine), ``train`` (training with
checkpoints and optional gradient compression) and ``dryrun`` (every
(arch × shape × mesh) cell counted against the H100 on a fake 512-rank
group, with ``mesh``, ``op_cost`` and ``roofline``)."""
