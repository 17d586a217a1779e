#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (rpvg_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

0. the card (nvidia-smi name and power limit), torch, and the native host
   library (built with g++ at first use);
1. build the EM kernel from rpvg_tpu_torch/csrc with nvcc for sm_90a;
2. the kernel against its plain PyTorch version on the card, on a seeded
   task set shaped like the main path's phase D;
3. the port's CLI with --backend cuda and --backend cpu on a small gene
   panel: identical rows, numbers within rtol 1e-6 / atol 1e-6;
4. the main path at bench scale (100k read pairs over 1,286 genes x 7
   isoforms x 4 haplotypes), with launch counters reset just before and
   read just after.

The last two lines are a JSON line of kernel results and
{"ok": true, "device": {...}}.  Without CUDA the script exits 1 and
prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

RTOL = 1e-6
ATOL_EM = 1e-9
ATOL_OUT = 1e-6


def log(line: str) -> None:
    print(line, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_em(kernel, plain):
    """(max abs diff, max rel diff, elements out of tolerance) between
    two lists of folded (path counts, noise) results."""
    import numpy as np

    k = np.concatenate([np.append(*r) for r in kernel])
    p = np.concatenate([np.append(*r) for r in plain])
    diff = np.abs(k - p)
    bad = diff > ATOL_EM + RTOL * np.abs(p)
    nz = np.abs(p) > ATOL_EM
    max_rel = float((diff[nz] / np.abs(p[nz])).max()) if nz.any() else 0.0
    return float(diff.max()), max_rel, int(bad.sum())


def phase_kernel(torch, device):
    """Phase 2: kernel vs plain version at main-path shapes."""
    import numpy as np

    from rpvg_tpu_torch.infer.batching import fold_fractions, pack_ragged
    from rpvg_tpu_torch.ops import em_cuda
    from rpvg_tpu_torch.testing import em_task_set

    task_list = em_task_set(4096, seed=11)
    tasks = pack_ragged(task_list, device)
    rows = tasks.n_rows.cpu().numpy()
    cols = tasks.n_cols.cpu().numpy()
    report = {}
    for max_its in (10000, 50):
        k_fracs, k_iters = em_cuda.em_fixed_point(tasks, max_its, 1e-3)
        k_again, _ = em_cuda.em_fixed_point(tasks, max_its, 1e-3)
        torch.cuda.synchronize()
        if not torch.equal(k_fracs, k_again):
            raise AssertionError("EM kernel is not deterministic across runs")
        p_fracs, p_iters = em_cuda.em_fixed_point_plain(tasks, max_its, 1e-3)
        max_abs, max_rel, n_bad = compare_em(
            fold_fractions(k_fracs, tasks, task_list),
            fold_fractions(p_fracs, tasks, task_list),
        )
        iters_k, iters_p = k_iters.cpu().numpy(), p_iters.cpu().numpy()
        off_by = np.flatnonzero(iters_k != iters_p)
        log(
            f"phase 2: max_em_its={max_its}: {len(task_list)} tasks "
            f"(rows median {int(np.median(rows))} max {rows.max()}, cols median "
            f"{int(np.median(cols))} max {cols.max()}), kernel vs plain max abs "
            f"{max_abs:.3e} max rel {max_rel:.3e} (rtol {RTOL}, atol {ATOL_EM}), "
            f"{n_bad} out of tolerance; iterations max {iters_k.max()}, "
            f"{int((iters_k == max_its).sum())} tasks at the cap, "
            f"{off_by.size} tasks with another iteration count than plain"
        )
        if n_bad:
            raise AssertionError(f"EM kernel disagrees with plain version at max_em_its={max_its}")
        report[max_its] = (max_abs, max_rel)

    kernel_ms = cuda_ms(lambda: em_cuda.em_fixed_point(tasks, 10000, 1e-3), reps=20)
    plain_ms = cuda_ms(lambda: em_cuda.em_fixed_point_plain(tasks, 10000, 1e-3), reps=3)
    log(
        f"phase 2: EM at main-path shapes ({len(task_list)} tasks, "
        f"{int(tasks.probs.numel())} elements): kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (CUDA events, mean after warm-up); kernel launches "
        f"in this phase {em_cuda.LAUNCHES}"
    )
    return {
        "max_abs_err": max(a for a, _ in report.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }


def write_dataset(sim, rpa, alignments, out_dir, num_genes, num_pairs, seed_panel, seed_reads):
    """Gene panel (graph/panel JSON, info TSV) and paired multipath reads
    as a binary .rpa stream, made from seeds."""
    panel = sim.build_gene_panel(
        num_genes=num_genes, isoforms_per_gene=7, num_haplotypes=4,
        exons_per_gene=10, exon_length=120, variant_sites=3, seed=seed_panel,
    )
    records, _ = sim.simulate_read_pairs(
        panel, num_pairs, read_length=100, frag_mean=250, frag_sd=25, seed=seed_reads,
        abundances=sim.gene_abundances(panel, seed=7), with_errors=False,
        multipath_dag=True,
    )
    parsed = [alignments.parse_multipath_alignment(r) for r in records]
    paths = {name: os.path.join(out_dir, name) for name in
             ("graph.json", "panel.json", "info.tsv", "aln.rpa")}
    rpa.write_fragments(
        paths["aln.rpa"], list(zip(parsed[0::2], parsed[1::2])),
        is_multipath=True, is_paired=True, frag_mean=250.0, frag_sd=25.0,
    )
    panel.write_graph_json(paths["graph.json"])
    panel.write_panel_json(paths["panel.json"])
    panel.write_info_tsv(paths["info.tsv"])
    return paths


def cli_argv(paths, prefix, backend, threads):
    return [
        "-g", paths["graph.json"], "-p", paths["panel.json"], "-a", paths["aln.rpa"],
        "-o", prefix, "-i", "haplotype-transcripts", "-f", paths["info.tsv"],
        "--backend", backend, "-t", str(threads), "-r", "42", "--score-not-qual",
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; an NVIDIA GPU is required",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(
        f"phase 0: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}"
    )

    from rpvg_tpu_torch import _host, cli
    from rpvg_tpu_torch.compare import check_estimate_file, compare_estimate_files
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.ops import build, em_cuda

    t0 = time.perf_counter()
    if _host.native.load_library() is None:
        raise RuntimeError("the native host library did not build")
    log(f"phase 0: native host library ready in {time.perf_counter() - t0:.1f}s")

    # Phase 1: build the kernel from the checkout's sources.
    t0 = time.perf_counter()
    lib_path, ptxas = build.build_library(em_cuda.KERNEL_NAME, force=True)
    build_s = time.perf_counter() - t0
    ptxas_lines = [ln.strip() for ln in ptxas.splitlines() if ln.strip()]
    log(
        f"phase 1: built {os.path.relpath(lib_path)} from "
        f"{os.path.relpath(build.source_path(em_cuda.KERNEL_NAME))} with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {build_s:.1f}s; ptxas: "
        + " | ".join(ptxas_lines)
    )

    # Phase 2: kernel vs plain version.
    em = phase_kernel(torch, device)

    threads = min(8, os.cpu_count() or 1)
    with tempfile.TemporaryDirectory(prefix="rpvg_smoke_") as work:
        # Phase 3: the slice agrees with itself across devices.
        small = write_dataset(_host.sim, _host.rpa, _host.alignments, work,
                              num_genes=60, num_pairs=5000, seed_panel=23, seed_reads=29)
        reports = []
        for backend in ("cuda", "cpu"):
            rc = cli.main(cli_argv(small, os.path.join(work, f"small_{backend}"), backend, threads))
            if rc != 0:
                raise RuntimeError(f"CLI --backend {backend} exited {rc}")
        for suffix in (".txt", "_joint.txt"):
            rep = compare_estimate_files(
                os.path.join(work, "small_cuda" + suffix),
                os.path.join(work, "small_cpu" + suffix), RTOL, ATOL_OUT,
            )
            reports.append(f"{suffix} {rep['rows']} rows, max abs {rep['max_abs_diff']:.3e}, "
                           f"max rel {rep['max_rel_diff']:.3e}, byte-identical "
                           f"{rep['byte_identical']}")
        log("phase 3: 5000 pairs, --backend cuda vs cpu: rows identical; " + "; ".join(reports))

        # Phase 4: the main path at bench scale.
        t0 = time.perf_counter()
        bench = write_dataset(_host.sim, _host.rpa, _host.alignments, work,
                              num_genes=1286, num_pairs=100000, seed_panel=5, seed_reads=17)
        log(f"phase 4: synthesised 100000 pairs over 1286 genes in "
            f"{time.perf_counter() - t0:.1f}s (set-up, not timed below)")
        prefix = os.path.join(work, "bench")
        torch.cuda.reset_peak_memory_stats(device)
        em_cuda.LAUNCHES = 0
        em_cuda.TASKS = 0
        for key in posteriors.SCORED_CLUSTERS:
            posteriors.SCORED_CLUSTERS[key] = 0
        t0 = time.perf_counter()
        rc, stats = cli.run_cli(cli_argv(bench, prefix, "cuda", threads))
        wall = time.perf_counter() - t0
        launches, em_tasks_run = em_cuda.LAUNCHES, em_cuda.TASKS
        scored = dict(posteriors.SCORED_CLUSTERS)
        if rc != 0:
            raise RuntimeError(f"bench-scale CLI run exited {rc}")
        rows = [check_estimate_file(prefix + s) for s in (".txt", "_joint.txt")]
        if launches < 1 or em_tasks_run != stats["em_tasks"]:
            raise AssertionError(
                f"EM kernel covered {em_tasks_run} of {stats['em_tasks']} tasks "
                f"in {launches} launches"
            )
        if scored.get("cuda", 0) != stats["scored_clusters"] or scored.get("cpu", 0):
            raise AssertionError(f"pair scores not all on cuda: {scored}")
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in stats["phase_seconds"].items())
        log(
            f"phase 4: 100000 pairs on cuda in {wall:.2f}s wall = "
            f"{100000 / wall:.1f} read pairs/s; fragment pass "
            f"{stats['fragment_pass_seconds']:.2f}s, matrices {stats['matrix_seconds']:.2f}s, "
            f"phases {phases}, outputs {stats['output_seconds']:.2f}s; "
            f"{stats['num_clusters']} clusters, {stats['scored_clusters']} scored on cuda, "
            f"{stats['em_tasks']} EM tasks all through the kernel in {launches} launch(es); "
            f"output rows {rows[0]} + {rows[1]}, all finite; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB"
        )

    print(json.dumps({"kernels": [{
        "name": "em_fixed_point",
        "route": "cuda",
        "source": "rpvg_tpu_torch/csrc/em_fixed_point.cu",
        "replaces": "rpvg_tpu/ops/em_pallas.py:46",
        "launches": launches,
        "max_abs_err": em["max_abs_err"],
        "ms": em["ms"],
        "plain_ms": em["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
