"""Phase D, the EM, per pass: ``phase_seconds["D"]``."""
from bench_port.metrics._passes import phases


def read(record):
    return phases(record, "D")
