"""Host inference phases A, C and E per pass: ``phase_seconds``."""
from bench_port.metrics._passes import phases


def read(record):
    return phases(record, "A", "C", "E")
