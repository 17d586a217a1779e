#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (rpvg_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints at least one line; any failure exits non-zero):

0. the card (nvidia-smi name and power limit), torch, and the native host
   library (built with g++ at first use);
1. build both EM kernels from rpvg_tpu_torch/csrc with nvcc for sm_90a,
   in parallel;
2. the ragged kernel against its plain PyTorch version on the card, on a
   seeded task set shaped like the main path's phase D;
3. the port's CLI with --backend cuda and --backend cpu for all four
   models on a small gene panel: identical rows, numbers within rtol 1e-6
   / atol 1e-6;
4. the main path at bench scale (haplotype-transcripts, 100k read pairs
   over 1,286 genes x 7 isoforms x 4 haplotypes), with launch counters
   reset just before and read just after;
5. the multi-bucket kernel against its plain PyTorch version on the
   launch groups that dispatch_em_device plans for phase 2's task set,
   and against the ragged kernel;
6. transcripts -f (ragged route, then RPVG_TPU_FUSE_EM=1), strains and
   haplotypes on phase 4's dataset, each with the counters reset just
   before and read just after.

The last two lines are a JSON line of kernel results and
{"ok": true, "device": {...}}.  Without CUDA the script exits 1 and
prints no result.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

RTOL = 1e-6
ATOL_EM = 1e-9
ATOL_OUT = 1e-6
PAIRS = 100000


def log(line: str) -> None:
    print(line, flush=True)


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (after one warm-up
    run unless ``warmup`` is false), timed with CUDA events."""
    import torch

    if warmup:
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


def phase_fused_kernel(torch, device, ragged_ms):
    """Phase 5: the multi-bucket kernel vs its plain version on the launch
    groups dispatch_em_device plans (RPVG_TPU_FUSE_EM=1) for phase 2's
    task set, and vs the ragged kernel on the same tasks."""
    import numpy as np

    from rpvg_tpu_torch.infer import batching
    from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda
    from rpvg_tpu_torch.testing import em_task_set

    task_list = em_task_set(4096, seed=11)
    os.environ["RPVG_TPU_FUSE_EM"] = "1"
    try:
        plan = batching.plan_em_groups(task_list, range(len(task_list)))
    finally:
        del os.environ["RPVG_TPU_FUSE_EM"]
    groups = [
        [batching.build_block(task_list, *chunk_plan, device) for chunk_plan in group]
        for group in plan
    ]

    def run(solve, max_its):
        return [solve(blocks, max_its, 1e-3) for blocks in groups]

    def folded(outs):
        results = [None] * len(task_list)
        for group, (fracs, _) in zip(plan, outs):
            batching.gather_em_device(
                [(chunk, f) for (chunk, _, _), f in zip(group, fracs)], task_list, results
            )
        return results

    def iterations(outs):
        return np.concatenate([torch.cat(iters).cpu().numpy() for _, iters in outs])

    kernel = em_fused_cuda.em_fixed_point_padded
    plain = em_fused_cuda.em_fixed_point_padded_plain
    report = {}
    for max_its in (10000, 50):
        k_outs = run(kernel, max_its)
        k_again = run(kernel, max_its)
        torch.cuda.synchronize()
        for (a, _), (b, _) in zip(k_outs, k_again):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError("multi-bucket kernel is not deterministic across runs")
        p_outs = run(plain, max_its)
        k_folded = folded(k_outs)
        max_abs, max_rel, n_bad = compare_em(k_folded, folded(p_outs))
        off_by = int((iterations(k_outs) != iterations(p_outs)).sum())
        tasks = batching.pack_ragged(task_list, device)
        r_fracs, _ = em_cuda.em_fixed_point(tasks, max_its, 1e-3)
        r_folded = batching.fold_fractions(r_fracs, tasks, task_list)
        vs_ragged, _, _ = compare_em(k_folded, r_folded)
        bitwise = all(
            np.array_equal(a, c) and b == d for (a, b), (c, d) in zip(k_folded, r_folded)
        )
        log(
            f"phase 5: max_em_its={max_its}: {len(task_list)} tasks in {len(plan)} launch(es) "
            f"of {[len(g) for g in plan]} blocks (padded shapes "
            f"{sorted({(R, C) for g in plan for _, R, C in g})}), kernel vs plain max abs "
            f"{max_abs:.3e} max rel {max_rel:.3e} (rtol {RTOL}, atol {ATOL_EM}), "
            f"{n_bad} out of tolerance; {off_by} clusters with another iteration count "
            f"than plain; vs the ragged kernel max abs {vs_ragged:.3e}, bitwise equal {bitwise}"
        )
        if n_bad:
            raise AssertionError(
                f"multi-bucket kernel disagrees with plain version at max_em_its={max_its}"
            )
        report[max_its] = max_abs

    kernel_ms = cuda_ms(lambda: run(kernel, 10000), reps=20)
    plain_ms = cuda_ms(lambda: run(plain, 10000), reps=1, warmup=False)
    padded = sum(b[0].numel() for blocks in groups for b in blocks)
    log(
        f"phase 5: EM at main-path shapes ({len(task_list)} tasks, {padded} padded "
        f"elements): multi-bucket kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"ragged kernel (phase 2) {ragged_ms:.3f} ms (CUDA events)"
    )
    return {"max_abs_err": max(report.values()), "ms": kernel_ms, "plain_ms": plain_ms}


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


def cli_argv(paths, prefix, backend, threads, model="haplotype-transcripts", info=True):
    argv = [
        "-g", paths["graph.json"], "-p", paths["panel.json"], "-a", paths["aln.rpa"],
        "-o", prefix, "-i", model,
        "--backend", backend, "-t", str(threads), "-r", "42", "--score-not-qual",
    ]
    return argv + (["-f", paths["info.tsv"]] if info else [])


def output_suffixes(model):
    return (".txt", "_joint.txt") if model == "haplotype-transcripts" else (".txt",)


def reset_counters():
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda

    em_cuda.LAUNCHES = em_cuda.TASKS = 0
    em_fused_cuda.LAUNCHES = em_fused_cuda.TASKS = em_fused_cuda.BLOCKS = 0
    for key in posteriors.SCORED_CLUSTERS:
        posteriors.SCORED_CLUSTERS[key] = 0


def read_counters():
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda

    return {
        "ragged_launches": em_cuda.LAUNCHES, "ragged_tasks": em_cuda.TASKS,
        "fused_launches": em_fused_cuda.LAUNCHES, "fused_tasks": em_fused_cuda.TASKS,
        "fused_blocks": em_fused_cuda.BLOCKS,
        "scored_cuda": posteriors.SCORED_CLUSTERS.get("cuda", 0),
        "scored_cpu": posteriors.SCORED_CLUSTERS.get("cpu", 0),
    }


def check_routes(model, fused, stats, counts):
    """The run's device work went through the kernels and the cuda pair
    scorer: every EM task in the route's kernel, none in the other."""
    em_tasks = stats.get("em_tasks", 0)
    if fused:
        ok = (
            counts["fused_tasks"] == em_tasks and counts["ragged_launches"] == 0
            and counts["fused_blocks"] > counts["fused_launches"] >= 1
        )
    else:
        ok = counts["fused_launches"] == 0 and counts["ragged_tasks"] == em_tasks and (
            counts["ragged_launches"] >= 1 or em_tasks == 0
        )
    if model in ("haplotypes", "haplotype-transcripts"):
        ok = ok and counts["scored_cuda"] == stats["scored_clusters"] and not counts["scored_cpu"]
    if not ok:
        raise AssertionError(f"{model}: device work not all through the kernels: {counts}")


def bench_run(torch, device, cli, check_estimate_file, phase, paths, prefix, threads,
              model, info, fused=False):
    """One CLI run at full width with the counters reset just before and
    read just after; returns (stats, counters) after printing a line."""
    torch.cuda.reset_peak_memory_stats(device)
    if fused:
        os.environ["RPVG_TPU_FUSE_EM"] = "1"
    reset_counters()
    t0 = time.perf_counter()
    try:
        rc, stats = cli.run_cli(cli_argv(paths, prefix, "cuda", threads, model, info))
    finally:
        os.environ.pop("RPVG_TPU_FUSE_EM", None)
    wall = time.perf_counter() - t0
    counts = read_counters()
    if rc != 0:
        raise RuntimeError(f"bench-scale {model} run exited {rc}")
    rows = [check_estimate_file(prefix + s) for s in output_suffixes(model)]
    check_routes(model, fused, stats, counts)
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in stats["phase_seconds"].items())
    route = "multi-bucket kernel" if fused else "ragged kernel"
    em = (
        f"{stats['em_tasks']} EM tasks all through the {route} in "
        f"{counts['fused_launches'] if fused else counts['ragged_launches']} launch(es)"
        + (f" of {counts['fused_blocks']} blocks" if fused else "")
        if "em_tasks" in stats else "no EM"
    )
    scored = f", {stats['scored_clusters']} clusters scored on cuda" if "scored_clusters" in stats else ""
    log(
        f"phase {phase}: {model}{' -f' if info else ''}{' RPVG_TPU_FUSE_EM=1' if fused else ''}: {PAIRS} pairs "
        f"on cuda in {wall:.2f}s wall = {PAIRS / wall:.1f} read pairs/s; fragment pass "
        f"{stats['fragment_pass_seconds']:.2f}s, matrices {stats['matrix_seconds']:.2f}s, "
        f"phases {phases}, outputs {stats['output_seconds']:.2f}s; "
        f"{stats['num_clusters']} clusters{scored}, {em}; output rows "
        f"{' + '.join(map(str, rows))}, all finite; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB"
    )
    return stats, counts


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
    from rpvg_tpu_torch.ops import build, em_cuda, em_fused_cuda

    t0 = time.perf_counter()
    if _host.native.load_library() is None:
        raise RuntimeError("the native host library did not build")
    log(f"phase 0: native host library ready in {time.perf_counter() - t0:.1f}s")

    # Phase 1: build both kernels from the checkout's sources, one nvcc each.
    names = (em_cuda.KERNEL_NAME, em_fused_cuda.KERNEL_NAME)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(lambda name: build.build_library(name, force=True), names))
    build_s = time.perf_counter() - t0
    for name, (lib_path, ptxas) in zip(names, builds):
        ptxas_lines = [ln.strip() for ln in ptxas.splitlines() if ln.strip()]
        log(
            f"phase 1: built {os.path.relpath(lib_path)} from "
            f"{os.path.relpath(build.source_path(name))} with nvcc "
            f"{' '.join(build.NVCC_FLAGS)} ({len(names)} builds in parallel, "
            f"{build_s:.1f}s); ptxas: " + " | ".join(ptxas_lines)
        )

    # Phase 2: ragged kernel vs plain version.
    em = phase_kernel(torch, device)

    threads = min(8, os.cpu_count() or 1)
    with tempfile.TemporaryDirectory(prefix="rpvg_smoke_") as work:
        # Phase 3: every model agrees with itself across devices.
        small = write_dataset(_host.sim, _host.rpa, _host.alignments, work,
                              num_genes=60, num_pairs=5000, seed_panel=23, seed_reads=29)
        for model in ("haplotype-transcripts", "transcripts", "strains", "haplotypes"):
            info = model == "haplotype-transcripts"
            reports = []
            for backend in ("cuda", "cpu"):
                prefix = os.path.join(work, f"small_{model}_{backend}")
                rc = cli.main(cli_argv(small, prefix, backend, threads, model, info))
                if rc != 0:
                    raise RuntimeError(f"{model} CLI --backend {backend} exited {rc}")
            for suffix in output_suffixes(model):
                rep = compare_estimate_files(
                    os.path.join(work, f"small_{model}_cuda{suffix}"),
                    os.path.join(work, f"small_{model}_cpu{suffix}"), RTOL, ATOL_OUT,
                )
                reports.append(f"{suffix} {rep['rows']} rows, max abs {rep['max_abs_diff']:.3e}, "
                               f"max rel {rep['max_rel_diff']:.3e}, byte-identical "
                               f"{rep['byte_identical']}")
            log(f"phase 3: {model}, 5000 pairs, --backend cuda vs cpu: rows identical; "
                + "; ".join(reports))

        # Phase 4: the main path at bench scale.
        t0 = time.perf_counter()
        bench = write_dataset(_host.sim, _host.rpa, _host.alignments, work,
                              num_genes=1286, num_pairs=PAIRS, seed_panel=5, seed_reads=17)
        log(f"phase 4: synthesised {PAIRS} pairs over 1286 genes in "
            f"{time.perf_counter() - t0:.1f}s (set-up, not timed below)")
        ragged_launches = 0
        _, counts = bench_run(torch, device, cli, check_estimate_file, 4, bench,
                              os.path.join(work, "bench"), threads, "haplotype-transcripts",
                              info=True)
        ragged_launches += counts["ragged_launches"]

        # Phase 5: the multi-bucket kernel.
        fused_em = phase_fused_kernel(torch, device, em["ms"])

        # Phase 6: the other models at full width on phase 4's dataset.
        prefixes = {}
        for model, info, fused in (
            ("transcripts", True, False), ("transcripts", True, True),
            ("strains", False, False), ("haplotypes", False, False),
        ):
            prefix = os.path.join(work, f"bench_{model}{'_fused' if fused else ''}")
            prefixes[(model, fused)] = prefix
            _, counts = bench_run(torch, device, cli, check_estimate_file, 6, bench, prefix,
                                  threads, model, info, fused)
            if fused:
                fused_launches = counts["fused_launches"]
            else:
                ragged_launches += counts["ragged_launches"]
        rep = compare_estimate_files(
            prefixes[("transcripts", True)] + ".txt", prefixes[("transcripts", False)] + ".txt",
            RTOL, ATOL_OUT,
        )
        log(f"phase 6: transcripts -f, multi-bucket vs ragged route: rows identical, "
            f"{rep['rows']} rows, max abs {rep['max_abs_diff']:.3e}, max rel "
            f"{rep['max_rel_diff']:.3e}, byte-identical {rep['byte_identical']}")

    print(json.dumps({"kernels": [
        {
            "name": em_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/em_fixed_point.cu",
            "replaces": "rpvg_tpu/ops/em_pallas.py:46",
            "launches": ragged_launches,
            "max_abs_err": em["max_abs_err"],
            "ms": em["ms"],
            "plain_ms": em["plain_ms"],
        },
        {
            "name": em_fused_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/em_fused.cu",
            "replaces": "rpvg_tpu/ops/em_pallas.py:182",
            "launches": fused_launches,
            "max_abs_err": fused_em["max_abs_err"],
            "ms": fused_em["ms"],
            "plain_ms": fused_em["plain_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
