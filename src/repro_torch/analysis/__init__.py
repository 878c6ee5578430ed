"""Runtime checks of the PyTorch package.

:mod:`.sanitize` is the port's copy of the JAX package's KV sanitizer: it
patches this package's ``PageTable``, ``KVTier``, ``PrefixKVStore``,
``DecodeWorker`` and ``ClusterRuntime``.  The static rules are not
copied: ``python -m repro.analysis src`` already scans ``src/repro_torch``.
"""
