"""Full collections of the cyclic collector: self seconds of ``rpvg.gc``,
per pass."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.gc")
