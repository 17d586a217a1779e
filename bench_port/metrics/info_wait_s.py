"""The wait for the info-TSV parse started beside the fragment pass, per
pass: self seconds of ``rpvg.info_wait``."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.info_wait")
