"""On the card: a short run of each cell through ``run.py`` comes out
correct, with its metrics and device.  Skips where there is no CUDA
device."""

import json
import os
import subprocess
import sys

import pytest

from bench_port import harness


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_a_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload", workload,
         "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"pairs_per_s", "peak_device_mib", "setup_s"}


def test_without_a_card_there_is_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload",
         "hst_diploid.sample100k", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
