"""The benchmark harness of the PyTorch port: one cell, one seed, one run.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file under ``kvbench/``, found by the name
``BENCHMARK.json`` gives it: a data file, or for a metric a small reader,
or for a configuration the module its file names (``spec.load_model``)."""
