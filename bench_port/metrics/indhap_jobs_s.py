"""The per-transcript route's jobs, per pass: ``phase_seconds`` I1 (one
read-collapsed matrix per (cluster, transcript) job) + I2 (every job's
pair posteriors on the card)."""
from bench_port.metrics._passes import phases


def route_phases(record, *keys):
    """``phases(record, *keys)``, or None where a pass did not run each
    of them (a run of another route)."""
    if not record.passes or any(key not in p.get("phase_seconds", {})
                                for p in record.passes for key in keys):
        return None
    return phases(record, *keys)


def read(record):
    return route_phases(record, "I1", "I2")
