"""Fragment pass per pass: ``stats["fragment_pass_seconds"]``."""
from bench_port.metrics._passes import mean


def read(record):
    return mean(record, lambda p: p["fragment_pass_seconds"])
