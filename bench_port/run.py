"""Run one cell of the port's benchmark on the GPU.

    python3 bench_port/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the estimate files matched the plain reference (``correct``), the passes
of the window (``attempted``, ``failed``), the cell's end-to-end metrics
(``--trace 0``) or per-layer metrics (``--trace 1``), the device, and
last the numbers compared with their limits (``checks``), which are also
the last lines of standard error.  Exits 1 without a result when there
is no CUDA device or fewer than the cell asks for, and 3 when a module
of jax or the JAX package was loaded."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache = os.path.join(ROOT, "bench_port", "cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))

    from bench_port import harness

    bench = harness.benchmark()
    cell = harness.find_cell(args.workload, bench)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ERROR: {cell.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device count {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    from rpvg_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    harness.log(f"device {torch.cuda.get_device_name(device)}, {torch.cuda.device_count()} "
                f"visible; power limit {harness.power_limit()}")
    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), device, T_START,
        harness.metric_names(bench, cell.workload, bool(args.trace)),
    )
    harness.stop_helpers()
    banned = harness.banned_modules()
    if banned:
        print(f"ERROR: modules of {', '.join(banned)} were loaded", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
