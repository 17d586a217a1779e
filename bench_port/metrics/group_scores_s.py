"""The group scorer, phase B at group size k != 2: self seconds of
``rpvg.groups.pack`` (the clusters packed and launched) and
``rpvg.groups.wait`` (the scores read back), per pass."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.groups.pack", "rpvg.groups.wait")
