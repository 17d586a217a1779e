"""The part of a pass no layer span covers: self seconds of ``rpvg.pass``
and ``rpvg.inference``, summed, per pass."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.pass", "rpvg.inference")
