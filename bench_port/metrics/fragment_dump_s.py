"""The fragment pass's dedup index dumped to columns, per pass: self
seconds of ``rpvg.fragments.dump``."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.fragments.dump")
