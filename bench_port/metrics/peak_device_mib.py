"""``torch.cuda.max_memory_allocated`` over the window, reset at its
start, in MiB."""


def read(record):
    return record.window_peak_bytes / 2**20 if record.window_peak_bytes else None
