"""One reader per metric of ``BENCHMARK.json``, named as the metric:
``read(record)`` takes the run's :class:`bench_port.harness.Record` and
returns the number, or None when the run holds nothing to read (the
harness then leaves the metric out of the result line)."""
