#!/usr/bin/env python3
"""Where a pass of the port's benchmark spends its time, by the program's
own spans (``rpvg_tpu_torch/spans.py``).

Run from the repository root, on a machine with CUDA:

    python3 tools/torch_span_breakdown.py --workload hst_diploid.sample100k \
        --seed <n> --seconds 51 --trace <0|1> [--json PATH]

It runs one cell of ``bench_port/run.py`` in this process (the same
arguments, the same result line), then prints, per pass of the window
(the program's last ``attempted`` runs), each span's mean total and self
seconds and its entries, largest first, the counters, and the fragment
pass's rates in MB/s from ``fragments.bytes``: the reader thread's
(``rpvg.fragments.read``), the projection's (``rpvg.fragments.project``)
and the whole pass's (``rpvg.fragments``).  ``--json`` also writes the
window's runs as ``spans.recent_runs`` gives them.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def per_pass(runs):
    """{name: (mean total_s, mean self_s, mean count)} over the runs that
    hold the span, largest total first."""
    names = {name for run in runs for name in run["spans"]}
    table = {}
    for name in names:
        entries = [run["spans"][name] for run in runs if name in run["spans"]]
        table[name] = tuple(
            statistics.mean(entry[key] for entry in entries)
            for key in ("total_s", "self_s", "count")
        )
    return dict(sorted(table.items(), key=lambda item: -item[1][0]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json")
    args, rest = parser.parse_known_args()
    from bench_port import run as bench_run

    with contextlib.redirect_stdout(io.StringIO()) as captured:
        rc = bench_run.main(rest)
    sys.stdout.write(captured.getvalue())
    if rc != 0:
        return rc
    from rpvg_tpu_torch import spans

    result = json.loads(captured.getvalue().strip().splitlines()[-1])
    runs = spans.recent_runs(result["attempted"])
    print(f"per pass, mean over {len(runs)} passes: span, total s, self s, entries")
    table = per_pass(runs)
    for name, (total, own, count) in table.items():
        print(f"  {name:28s} {total:10.6f} {own:10.6f} {count:6.1f}")
    counters = {
        name: statistics.mean(run["counters"].get(name, 0) for run in runs)
        for name in sorted({name for run in runs for name in run["counters"]})
    }
    print(f"counters per pass: {counters}")
    megabytes = counters.get("fragments.bytes", 0) / 1e6
    for name in ("rpvg.fragments.read", "rpvg.fragments.project", "rpvg.fragments"):
        if megabytes and name in table:
            print(f"  {name}: {megabytes / table[name][0]:.1f} MB/s over its total")
    if args.json:
        with open(args.json, "w") as handle:
            json.dump(runs, handle)
    return 0


if __name__ == "__main__":
    sys.exit(main())
