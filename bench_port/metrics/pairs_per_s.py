"""Read pairs of all passes of the window over the window's time (host
clock, from the window's start to the end of its last pass)."""


def read(record):
    return record.pairs / record.window_s
