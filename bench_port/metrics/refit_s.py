"""The fragment-length re-fit, its density table and the effective path
lengths, per pass: self seconds of ``rpvg.refit``."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.refit")
