"""The device's busy share and the EM kernel's roofline share on a
synthetic trace of known intervals."""

import numpy as np

from bench_port import bounds, harness, trace
from bench_port.metrics import device_busy_share, em_kernel_roofline

EM = "void em_task::block_team_kernel<em_ragged::RaggedSource>(double const*)"


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events():
    return [
        # Two passes, 0-1,000 us and 1,000-2,000 us (the window).
        _event("bench.pass", "user_annotation", 0.0, 1000.0),
        _event("bench.pass", "user_annotation", 1000.0, 1000.0),
        _event("bench.em", "user_annotation", 100.0, 300.0),
        _event("bench.outputs", "user_annotation", 1200.0, 700.0),
        # EM kernels on two streams, overlapping: their union is 100-300 us.
        _event(EM, "kernel", 100.0, 200.0),
        _event(EM, "kernel", 150.0, 100.0),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 250.0, 100.0),
        # A kernel before the window is left out.
        _event(EM, "kernel", -500.0, 100.0),
        _event("void other_kernel()", "kernel", 1100.0, 50.0),
    ]


def test_busy_share_is_the_union_over_the_window():
    summary = trace.summarize(_events())
    assert summary.window_s == 2000e-6
    assert abs(summary.busy_s - 300e-6) < 1e-12  # 100-350 us and 1,100-1,150 us
    record = harness.Record(1.0, 0.1, 1.0, 1, [], 0, trace=summary)
    share = device_busy_share.read(record)
    assert abs(share - 15.0) < 1e-9 and 0 < share <= 100
    assert summary.device_ops[0] == (EM, 300e-6)
    # Idle, by innermost span: 350-400 us under bench.em, 1,200-1,900 us
    # under bench.outputs, the other 950 us under bench.pass alone.
    idle = dict(summary.idle_gaps)
    assert abs(idle["bench.pass"] - 950e-6) < 1e-12
    assert abs(idle["bench.em"] - 50e-6) < 1e-12
    assert abs(idle["bench.outputs"] - 700e-6) < 1e-12
    assert abs(sum(idle.values()) - (summary.window_s - summary.busy_s)) < 1e-12


def test_em_roofline_share_is_the_bound_over_the_union_of_its_kernels():
    summary = trace.summarize(_events())
    shapes = np.array([[300, 60], [20, 5]])
    iterations = np.array([2500, 30])
    record = harness.Record(1.0, 0.1, 1.0, 1, [], 0, trace=summary,
                            em_launches=[(shapes, iterations)])
    bound, _ = bounds.ragged_em_bound(shapes, iterations)
    share = em_kernel_roofline.read(record)
    assert abs(share - 100.0 * bound / 200e-6) < 1e-9
    assert 0 < share <= 100


def test_no_trace_no_reading():
    record = harness.Record(1.0, 0.1, 1.0, 1, [], 0)
    assert device_busy_share.read(record) is None
    assert em_kernel_roofline.read(record) is None


def test_em_bound_counts_bytes_once_and_flops_per_iteration():
    seconds, what = bounds.ragged_em_bound(np.array([[10, 4]]), np.array([100]))
    flops = 4.0 * 100 * 10 * 4
    in_bytes = 8 * (40 + 10 + 3 * 2 + 2)
    out_bytes = 8 * (4 + 1)
    flops_s = flops / bounds.FP64_FLOPS
    bytes_s = (in_bytes + out_bytes) / bounds.HBM_BYTES_PER_S
    assert seconds == max(flops_s, bytes_s)
    assert what == ("bytes" if bytes_s >= flops_s else "operations")
