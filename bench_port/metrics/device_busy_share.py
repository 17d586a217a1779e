"""Share of the window in which the card ran a kernel, a copy or a set
(the union of their intervals over all streams in the traced window,
over the window's length), in percent."""


def read(record):
    if record.trace is None or record.trace.window_s <= 0:
        return None
    return 100.0 * record.trace.busy_s / record.trace.window_s
