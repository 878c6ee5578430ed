"""Small helpers: ``shard_hint`` (sharding constraints from model code),
``Timer`` / ``timed`` and the tree sizes."""
