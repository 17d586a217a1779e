"""Cluster matrices per pass: ``stats["matrix_seconds"]``."""
from bench_port.metrics._passes import mean


def read(record):
    return mean(record, lambda p: p["matrix_seconds"])
