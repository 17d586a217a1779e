"""Phase B, the group posteriors, per pass: ``phase_seconds["B"]``."""
from bench_port.metrics._passes import phases


def read(record):
    return phases(record, "B")
