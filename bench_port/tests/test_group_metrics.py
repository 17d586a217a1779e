"""The group scorer's metrics: ``group_scores_roofline`` on a synthetic
trace of known kernel intervals and counters, its kernel marks, its
bound's bytes against ``chip_smoke.group_scores_bound``'s, and
``group_scores_s`` / ``group_finish_s`` on small cells run on the CPU
(read at -y 4, None at -y 2)."""

import math
import sys

import numpy as np
import pytest

from bench_port import group_bounds, harness, trace
from bench_port.metrics import em_kernel_roofline, group_finish_s, group_scores_roofline
from bench_port.metrics import group_scores_s
from bench_port.tests.test_span_metrics import recent, record  # noqa: F401

# The names the profiler gives the scorer's kernels on the card (the
# scoring kernel is a template on the group size's branch).
PREPARE = "group_scores::prepare_kernel(group_scores::Clusters)"
SCORE = "void group_scores::score_kernel<3>(group_scores::Clusters)"
OTHER_KERNELS = (
    "void em_task::block_team_kernel<em_ragged::RaggedSource>(em_ragged::RaggedSource, long "
    "const*, int, em_task::Params)",
    "void em_task::warp_team_kernel<em_ragged::RaggedSource>(em_ragged::RaggedSource, long "
    "const*, long, long, int, em_task::Params)",
    "void em_task::block_team_kernel<em_fused::FusedSource>(double const*)",
    "void gibbs_rc::gibbs_kernel(gibbs_rc::Jobs)",
    "void gibbs_post::posterior_gibbs_kernel(gibbs_post::Clusters)",
    "void gibbs_k::gibbs_k_kernel(gibbs_k::Chains)",
)
NEW = ("group_scores_s", "group_finish_s", "group_scores_roofline")


def counters(rows, cells, groups):
    return {"spans": {}, "counters": {"groups.rows": rows, "groups.cells": cells,
                                      "groups.groups": groups}}


def traced_record(passes, kernels):
    summary = trace.TraceSummary(window_s=1.0, busy_s=0.0, device_ops=[], idle_gaps=[],
                                 kernels=kernels)
    return harness.Record(setup_s=1.0, load_s=0.5, window_s=3.0, pairs=passes * 1000,
                          passes=[{} for _ in range(passes)], window_peak_bytes=0,
                          trace=summary)


KERNELS = {
    # The scorer's two kernels: their union is 0-25 us and 100-110 us.
    PREPARE: [(0.0, 10e-6), (100e-6, 104e-6)],
    SCORE: [(5e-6, 25e-6), (102e-6, 110e-6)],
    # Another kernel's time is not the scorer's.
    OTHER_KERNELS[0]: [(30e-6, 90e-6)],
}


def test_roofline_is_the_window_bound_over_the_union_of_the_two_kernels(recent):
    # An older run outside the window is left out.
    recent([counters(10**6, 10**7, 10**6),
            counters(1000, 4000, 8750), counters(3000, 12000, 105)])
    share = group_scores_roofline.read(traced_record(2, KERNELS))
    # Run 1: 8 (4,000 + 2,000) + 8 x 8,750 = 118,000 bytes, against 4,000
    # x 14 FP64 instructions; run 2: 8 (12,000 + 6,000) + 8 x 105 =
    # 144,840 bytes, against 12,000 x 14.
    bound_1 = max(118_000 / 3.35e12, 4_000 * 14 / 34e12)
    bound_2 = max(144_840 / 3.35e12, 12_000 * 14 / 34e12)
    assert bound_1 == 118_000 / 3.35e12 and bound_2 == 144_840 / 3.35e12
    assert share == pytest.approx(100.0 * (bound_1 + bound_2) / 35e-6, rel=1e-12)
    assert 0 < share <= 100
    assert recent.asked == [2]


def test_roofline_bound_is_the_larger_of_bytes_and_logs():
    # A probability costs 8 bytes (2.4 ps at 3.35 TB/s) and one log of 14
    # FP64 instructions (0.41 ps at 34 TFLOP/s): the bytes bound it.
    seconds, what = group_bounds.group_scores_bound(rows=1, cells=10**6, groups=1)
    assert what == "bytes" and seconds == (8 * (10**6 + 2) + 8) / 3.35e12
    assert seconds > 10**6 * 14 / 34e12
    seconds, what = group_bounds.group_scores_bound(rows=10**6, cells=10**6, groups=35)
    assert what == "bytes" and seconds == (8 * 3 * 10**6 + 8 * 35) / 3.35e12


@pytest.mark.parametrize("case", ["no_trace", "no_kernels", "no_counters", "no_runs"])
def test_roofline_reads_none_without_its_inputs(case, recent):
    runs = [counters(1000, 4000, 8750)] * 2
    kernels = KERNELS
    if case == "no_trace":
        rec = harness.Record(1.0, 0.5, 3.0, 2000, [{}, {}], 0)
    else:
        if case == "no_kernels":
            kernels = {OTHER_KERNELS[0]: [(0.0, 1e-3)]}
        if case == "no_counters":
            runs = [counters(1000, 4000, 8750), {"spans": {}, "counters": {}}]
        if case == "no_runs":
            runs = []
        rec = traced_record(2, kernels)
    recent(runs)
    assert group_scores_roofline.read(rec) is None


def test_metrics_read_none_for_a_program_without_spans(monkeypatch):
    # An earlier program has no span recorder to import.
    import rpvg_tpu_torch

    monkeypatch.delattr(rpvg_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "rpvg_tpu_torch.spans", None)
    assert group_scores_roofline.read(traced_record(2, KERNELS)) is None
    assert group_scores_s.read(record(2)) is None
    assert group_finish_s.read(record(2)) is None


def test_marks_match_the_group_scorer_and_no_other_kernel():
    marks = group_scores_roofline.KERNEL_MARKS
    assert [any(mark in name for mark in marks) for name in (PREPARE, SCORE)] == [True, True]
    assert not [name for name in OTHER_KERNELS if any(mark in name for mark in marks)]
    # Nor does the EM's roofline read the scorer's kernels.
    assert not [name for name in (PREPARE, SCORE)
                if all(mark in name for mark in em_kernel_roofline.KERNEL_MARKS)]


def test_bound_bytes_are_chip_smoke_s_but_the_cluster_layout():
    """On one GroupClusters built on the CPU: chip_smoke's bytes (at no
    operations) less its seven offset words per cluster and its tables
    (one per distinct P) equal this bound's bytes."""
    import torch

    import chip_smoke
    from rpvg_tpu_torch.ops import group_scores_cuda

    rng = np.random.default_rng(5)
    k = 4
    inputs = []
    for R, P in ((37, 4), (5, 3), (120, 4), (1, 1), (64, 6)):
        inputs.append((rng.random((R, P)), rng.uniform(1e-4, 0.05, R),
                       rng.integers(1, 5, R).astype(np.float64)))
    clusters = group_scores_cuda.make_clusters(inputs, k, torch.device("cpu"))
    rows = sum(p.shape[0] for p, _, _ in inputs)
    cells = sum(p.size for p, _, _ in inputs)
    groups = sum(math.comb(p.shape[1] + k - 1, k) for p, _, _ in inputs)
    smoke_ms, what = chip_smoke.group_scores_bound(clusters, per_log=0)
    assert what == "bytes"
    smoke_bytes = smoke_ms * 1e-3 * chip_smoke.HBM_BYTES_PER_S
    layout = 8 * 7 * len(inputs) + 4 * clusters.table.numel()
    ours = group_bounds.group_scores_bytes(rows, cells, groups)
    assert ours == pytest.approx(smoke_bytes - layout, rel=1e-12)
    assert group_bounds.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert group_bounds.FP64_FLOPS_NO_TENSOR == chip_smoke.FP64_FLOPS_NO_TENSOR


def test_new_metrics_are_declared_for_the_tetraploid_cell():
    declared = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in NEW:
        entry = declared[name]
        assert entry["moves"] == "pairs_per_s"
        assert "hst_tetraploid.sample100k" in entry["workloads"]
    assert declared["group_scores_roofline"]["unit"] == "%"
    assert declared["group_scores_roofline"]["source"] == "device_trace"


def test_span_metrics_read_at_y4_and_none_at_y2(small_cell):
    from rpvg_tpu_torch import spans

    result = small_cell("tiny_tetraploid.sample3k", seed=2**31 + 29, seconds=0.2)
    assert result["correct"]
    rec = record(result["attempted"])
    runs = spans.recent_runs(result["attempted"])
    assert all(run["counters"]["groups.host_enum_clusters"] == 0 for run in runs)
    assert all(run["counters"]["groups.clusters"] > 0 for run in runs)
    assert group_scores_s.read(rec) > 0 and group_finish_s.read(rec) > 0

    result = small_cell("tiny_diploid.sample3k", seed=2**31 + 29, seconds=0.2)
    assert result["correct"]
    rec = record(result["attempted"])
    assert group_scores_s.read(rec) is None and group_finish_s.read(rec) is None
