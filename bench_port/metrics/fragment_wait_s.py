"""The fragment pass waiting for the reader thread's next ``.rpa`` block,
per pass: self seconds of ``rpvg.fragments.wait``."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.fragments.wait")
