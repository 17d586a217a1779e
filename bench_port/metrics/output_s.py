"""The estimate files per pass: ``stats["output_seconds"]``."""
from bench_port.metrics._passes import mean


def read(record):
    return mean(record, lambda p: p["output_seconds"])
