"""The group scorer (``csrc/group_scores.cu``) against its roofline, in
percent: the least time of the window's group-score work (per run,
``bench_port.group_bounds.group_scores_bound`` of the program's
``groups.*`` counters, summed over the window's runs) over the device
time of the scorer's two kernels in the trace (the union of their
intervals)."""
from bench_port.group_bounds import group_scores_bound
from bench_port.trace import covered

KERNEL_MARKS = ("group_scores::prepare_kernel", "group_scores::score_kernel")
COUNTERS = ("groups.rows", "groups.cells", "groups.groups")


def window_work(record):
    """Per run of the window, its (rows, cells, groups); None
    where the program keeps no spans or a run lacks a counter."""
    try:
        from rpvg_tpu_torch import spans
    except ImportError:
        return None
    runs = spans.recent_runs(len(record.passes))
    if not runs or any(name not in run["counters"] for run in runs for name in COUNTERS):
        return None
    return [tuple(run["counters"][name] for name in COUNTERS) for run in runs]


def read(record):
    if record.trace is None:
        return None
    intervals = [span for name, spans in record.trace.kernels.items()
                 if any(mark in name for mark in KERNEL_MARKS) for span in spans]
    work = window_work(record)
    if not intervals or work is None:
        return None
    bound = sum(group_scores_bound(*run)[0] for run in work)
    return 100.0 * bound / covered(intervals)
