"""The readings that the limits of a cell are set from, at the cell's own
size, on the card:

    python3 bench_port/readings.py --workload <config>.<traffic> \
        --seeds <n> ... [--control-seeds <n> ...] [--draw-library] [--out <file>]

For every seed, one pass of the port (the timed path, as a window runs
it: panel resident, every estimate file written) judged against the
plain reference: these are the lower readings.  For every control seed,
the control, the reference computed in float32 and put in the program's
place, judged the same way: these are the upper readings.  With
``--draw-library`` each seed also draws the library itself (its reads
and expression profile, in place of the traffic's fixed seeds): a sweep
over samples the cell's runs never see.  Inputs of all seeds are made
first, in parallel worker processes.  Prints one JSON
line per seed and a summary; ``--out`` also writes them to a file.  Not
run by the benchmark's runs."""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _prepare(args):
    from bench_port import inputs

    config, traffic, seed = args
    return inputs.prepare(config, traffic, seed)


def _traffic(traffic: dict, seed: int, draw_library: bool) -> dict:
    if not draw_library:
        return traffic
    return {**traffic, "reads": {**traffic["reads"], "seed": seed},
            "expression": {**traffic["expression"], "seed": seed}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--draw-library", action="store_true")
    parser.add_argument("--out")
    parser.add_argument("--generators", type=int, default=6)
    args = parser.parse_args(argv)

    import numpy as np

    from bench_port import harness
    from bench_port.reference import compare
    from bench_port.reference.fragment_pass import Workers

    cell = harness.find_cell(args.workload)
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    t0 = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(min(args.generators, len(seeds)))
    try:
        all_files = pool.map(_prepare, [(cell.config, _traffic(cell.traffic, s, args.draw_library), s)
                                        for s in seeds], chunksize=1)
    finally:
        pool.close()
        pool.join()
    harness.log(f"inputs of {len(seeds)} seeds in {time.perf_counter() - t0:.1f} s")

    import torch

    from rpvg_tpu_torch.device import resolve_device
    from rpvg_tpu_torch.pipeline import PipelineConfig, load_inputs

    device = resolve_device("cuda" if torch.cuda.is_available() else "cpu")
    reference = __import__(f"bench_port.reference.{cell.config['reference']}",
                           fromlist=["expected"])
    ploidy = int(cell.config["run"]["ploidy"])
    graph, paths_index = load_inputs(PipelineConfig(graph=all_files[0]["graph"],
                                                    paths=all_files[0]["panel"]))
    lines = []
    rows_of = {}
    with tempfile.TemporaryDirectory(prefix="bench_port_readings_") as out_dir, \
            Workers(all_files[0], cell.config["run"], harness.REFERENCE_WORKERS) as workers:
        for seed, files in zip(seeds, all_files):
            line = {"workload": cell.workload, "seed": seed}
            t = time.perf_counter()
            prefix = os.path.join(out_dir, f"port{seed}")
            pconfig = harness.pipeline_config(cell, files, graph, paths_index)
            stats = harness.run_pass(pconfig, device, prefix)
            line["pass_s"] = time.perf_counter() - t
            line["em_tasks"] = stats.get("em_tasks")
            t = time.perf_counter()
            # The rows do not follow the order of the pairs: one per pool.
            if files["pool"] not in rows_of or seed in args.control_seeds:
                clusters = reference.cluster(files, workers)
                rows_of[files["pool"]] = reference.expected(clusters, cell.config["run"], workers)
            want = rows_of[files["pool"]]
            line["reference_s"] = time.perf_counter() - t
            line["program"] = compare.compare(prefix, want, ploidy)
            if seed in args.control_seeds:
                control = reference.expected(clusters, cell.config["run"], workers, np.float32)
                compare.write_estimates(control, prefix + "_control", ploidy)
                line["control"] = compare.compare(prefix + "_control", want, ploidy)
            for suffix in (".txt", "_joint.txt", "_control.txt", "_control_joint.txt"):
                if os.path.exists(prefix + suffix):
                    os.remove(prefix + suffix)
            lines.append(line)
            print(json.dumps(line), flush=True)

    names = list(lines[0]["program"])
    summary = {
        "workload": cell.workload,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "seeds": len(lines),
        "lower": {k: max(line["program"][k] for line in lines) for k in names},
        "upper": {k: min(line["control"][k] for line in lines if "control" in line)
                  for k in names} if args.control_seeds else {},
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as handle:
            for line in lines + [summary]:
                handle.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
