"""Seconds to load the graph and panel JSON (``pipeline.load_inputs``),
once, in set-up (harness clock)."""


def read(record):
    return record.load_s
