"""The group posteriors on the host after the scorer (prior,
permutations, normalisation per cluster): self seconds of
``rpvg.groups.finish``, per pass."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.groups.finish")
