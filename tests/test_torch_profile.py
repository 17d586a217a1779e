"""The inference profiler hook (``RPVG_TPU_TORCH_PROFILE=<dir>``) on the
CPU: one Chrome trace per ``run_inference_phases`` call, written even
when the dispatch raises, and the estimate files of a run without the
hook; unset, the hook makes no profiler call.  ``chip_smoke.py``'s
trace reader (phase 17) on a trace of known intervals."""

import glob
import json
import os
import subprocess
import sys

import pytest

import rpvg_tpu_torch.pipeline as port_pipeline
from rpvg_tpu_torch import cli

from test_torch_slice import REPO, _argv, _write_inputs, make_dataset, one_torch_thread  # noqa: F401

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("profile_panel"))
    panel, aln, info = make_dataset(work)
    graph, paths = _write_inputs(panel, work)
    return graph, paths, aln, info


def _read(path):
    with open(path, "rb") as handle:
        return handle.read()


def test_hook_writes_one_trace_per_call_and_the_same_bytes(inputs, tmp_path, monkeypatch):
    plain = str(tmp_path / "plain")
    assert cli.main(_argv(*inputs, plain)) == 0
    trace_dir = str(tmp_path / "traces")
    monkeypatch.setenv("RPVG_TPU_TORCH_PROFILE", trace_dir)
    for run in ("first", "second"):
        prefix = str(tmp_path / run)
        assert cli.main(_argv(*inputs, prefix)) == 0
        for suffix in (".txt", "_joint.txt"):
            assert _read(prefix + suffix) == _read(plain + suffix)
    traces = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))
    assert len(traces) == 2
    assert all(f"rpvg_torch_{os.getpid()}_" in os.path.basename(t) for t in traces)
    for trace in traces:
        summary = chip_smoke.trace_summary(trace)
        # The CPU route runs in the C++ library: a window, nothing on a card.
        assert summary["window_ms"] > 0
        assert summary["device_events"] == 0 and summary["busy_share"] == 0.0


def test_hook_writes_its_trace_when_the_dispatch_raises(inputs, tmp_path, monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(port_pipeline, "batched_haplotype_transcripts", fail)
    trace_dir = str(tmp_path / "traces")
    monkeypatch.setenv("RPVG_TPU_TORCH_PROFILE", trace_dir)
    with pytest.raises(RuntimeError, match="dispatch failed"):
        cli.run_cli(_argv(*inputs, str(tmp_path / "out")))
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as handle:
        assert json.load(handle)["traceEvents"]


_UNSET_RUN = r"""
import sys
import torch.profiler

calls = []

class Refused:
    def __init__(self, *args, **kwargs):
        calls.append(args)
        raise AssertionError("the profiler was called")

torch.profiler.profile = Refused
import rpvg_tpu_torch.cli as cli
rc = cli.main(sys.argv[1:])
print("CALLS", len(calls), "PROFILING", torch.autograd.profiler._is_profiler_enabled)
sys.exit(rc)
"""


def test_hook_unset_makes_no_profiler_call(inputs, tmp_path):
    """``import torch`` itself loads ``torch.profiler``, so the module's
    presence says nothing; the hook's one entry, ``profile``, is
    replaced by a class that refuses, in a fresh interpreter."""
    env = {k: v for k, v in os.environ.items() if k != "RPVG_TPU_TORCH_PROFILE"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _UNSET_RUN, *_argv(*inputs, str(tmp_path / "out"))],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CALLS 0 PROFILING False" in proc.stdout
    assert not glob.glob(str(tmp_path / "**" / "*.pt.trace.json"), recursive=True)


def _event(cat, name, ts, dur, **extra):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1, **extra}


def test_trace_summary_busy_share_top_and_gaps(tmp_path):
    """A 1,000 us window; device work on two streams overlapping at
    100-300 and 250-400 (union 300 us), a copy at 600-650 and a set at
    900-910: busy 360 us, gaps of 200 (400-600), 250 (650-900), 100
    (0-100) and 90 us (910-1000)."""
    events = [
        _event("Trace", "PyTorch Profiler (0)", 0.0, 1000.0),
        _event("kernel", "warp_team_kernel", 100.0, 200.0, args={"stream": 7}),
        _event("kernel", "warp_team_kernel", 250.0, 150.0, args={"stream": 8}),
        _event("gpu_memcpy", "Memcpy HtoD", 600.0, 50.0),
        _event("gpu_memset", "Memset", 900.0, 10.0),
        _event("cpu_op", "aten::copy_", 380.0, 300.0),
        _event("cpu_op", "aten::to", 390.0, 210.0),
        _event("cuda_runtime", "cudaStreamSynchronize", 640.0, 270.0),
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
    ]
    path = str(tmp_path / "trace.json")
    with open(path, "w") as handle:
        json.dump({"traceEvents": events}, handle)
    summary = chip_smoke.trace_summary(path, top=2, gaps=3)
    assert summary["window_ms"] == pytest.approx(1.0)
    assert summary["busy_ms"] == pytest.approx(0.36)
    assert summary["busy_share"] == pytest.approx(0.36)
    assert summary["device_events"] == 4 and summary["host_events"] == 3
    assert summary["top"][0] == {"name": "warp_team_kernel", "cat": "kernel", "ms": 0.35,
                                 "count": 2}
    assert summary["top"][1]["name"] == "Memcpy HtoD"
    assert summary["kernel_names"] == ["warp_team_kernel"]
    gaps = [(g["at_ms"], g["ms"], g["host"]) for g in summary["gaps"]]
    # aten::copy_ and aten::to both cover 400-600: the shorter, inner op
    # names it.
    assert gaps == [
        (pytest.approx(0.65), pytest.approx(0.25), "cudaStreamSynchronize"),
        (pytest.approx(0.4), pytest.approx(0.2), "aten::to"),
        (pytest.approx(0.0), pytest.approx(0.1), None),
    ]
