"""The ragged EM kernel (``csrc/em_fixed_point.cu``) against its
roofline, in percent: the least time of every launch of the window
(``bench_port.bounds.ragged_em_bound`` of its task shapes and the
iterations it returned) over the device time of its kernels in the
trace (the union of their intervals, the launches of one call running
on several streams at once)."""
from bench_port.bounds import ragged_em_bound
from bench_port.trace import covered

KERNEL_MARKS = ("em_ragged", "team_kernel")


def read(record):
    if record.trace is None or not record.em_launches:
        return None
    spans = [span for name, intervals in record.trace.kernels.items()
             if all(mark in name for mark in KERNEL_MARKS) for span in intervals]
    if not spans:
        return None
    bound = sum(ragged_em_bound(shapes, iters)[0] for shapes, iters in record.em_launches)
    return 100.0 * bound / covered(spans)
