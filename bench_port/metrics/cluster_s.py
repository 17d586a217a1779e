"""Clustering, the partition of the entries and the cluster order, per
pass: self seconds of ``rpvg.clusters``."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.clusters")
