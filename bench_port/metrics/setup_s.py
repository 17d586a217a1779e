"""Seconds from the process's start to the window's: inputs made or read
from the cache, the panel loaded, the kernels built or loaded, one whole
warm pass."""


def read(record):
    return record.setup_s
