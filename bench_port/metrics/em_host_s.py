"""Phase D's host half, per pass: self seconds of ``rpvg.em.pack`` (the
tasks packed into ragged sets and copied to the card) and
``rpvg.em.fold`` (the results back in task order, the sub-threshold mass
folded), summed."""
from bench_port.metrics._spans import self_mean


def read(record):
    return self_mean(record, "rpvg.em.pack", "rpvg.em.fold")
