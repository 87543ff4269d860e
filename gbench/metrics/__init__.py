"""One module per per-layer metric, named as in ``BENCHMARK.json``. Each
defines ``read(r)`` over a ``trace.Reading`` and returns the metric's value,
or None where the traced run has nothing for it to read."""
