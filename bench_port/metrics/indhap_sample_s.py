"""The per-transcript route's subset sampling, per pass:
``phase_seconds["I3"]`` (1 / min_hap_prob draws per job, the distinct
subsets and their sampled mass)."""
from bench_port.metrics.indhap_jobs_s import route_phases


def read(record):
    return route_phases(record, "I3")
