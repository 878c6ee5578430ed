"""Command-line entry points of the port: ``profile_offline`` (the
offline Bayesian profiling of the strategy space) and ``serve`` (the
controller over the one-shot PD engine)."""
