#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (rpvg_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints at least one line; any failure exits non-zero):

0. the card (nvidia-smi name and power limit), torch, and the port's own
   native host library (built with g++ from rpvg_tpu_torch/csrc/host at
   first use);
1. build both EM kernels from rpvg_tpu_torch/csrc with nvcc for sm_90a,
   in parallel;
2. the ragged kernel against its plain PyTorch version on the card, on a
   seeded task set shaped like the main path's phase D; its time beside
   its roofline bound, and its slowest task alone;
3. the port's CLI with --backend cuda and --backend cpu for all four
   models on a small gene panel: identical rows, numbers within rtol 1e-6
   / atol 1e-6;
4. the main path at bench scale (haplotype-transcripts, 100k read pairs
   over 1,286 genes x 7 isoforms x 4 haplotypes), with launch counters
   reset just before and read just after; the tasks phase D hands to
   em_cuda.em_fixed_point are captured (the script wraps that entry) and
   the kernel is re-timed on them, held against its plain version, and
   their slowest task timed alone;
5. the multi-bucket kernel against its plain PyTorch version on the
   launch groups that dispatch_em_device plans for phase 2's task set,
   and against the ragged kernel (bitwise); its bound and slowest cluster;
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
# Roofline of one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM
# bytes per second, and the FP64 peak (tensor cores; 34 TFLOP/s without).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 67e12


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


def em_bound(in_bytes, out_bytes, iterations, rows, cols):
    """(bound ms, what bounds it) of an EM launch: each input byte read
    and each output byte written once at the HBM rate, against this
    run's iterations times 4 R C flops (E and M step) at the FP64 peak."""
    import numpy as np

    flops = 4.0 * float(np.sum(np.asarray(iterations, dtype=np.float64) * rows * cols))
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP64_FLOPS * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def ragged_bound(tasks, iters):
    """em_bound for the ragged kernel over ``tasks`` (RaggedTasks)."""
    n = tasks.n_tasks
    in_bytes = 8 * (tasks.probs.numel() + tasks.counts.numel() + 3 * (n + 1) + 2 * n)
    out_bytes = 8 * (int(tasks.col_offsets[-1]) + n)
    rows, cols = tasks.shapes[:, 0], tasks.shapes[:, 1]
    return em_bound(in_bytes, out_bytes, iters.cpu().numpy(), rows, cols)


def slowest_candidates(task_list, iterations, count=3):
    """Indices of the tasks that may set a launch's time: the ``count``
    with the most iterations (the largest first on ties) and the
    ``count`` with the most iterations times elements."""
    import numpy as np

    iterations = np.asarray(iterations, dtype=np.int64)
    sizes = np.array([p.size for p, _ in task_list], dtype=np.int64)
    by_iterations = np.lexsort((-sizes, -iterations))[:count]
    by_work = np.argsort(-(iterations * sizes), kind="stable")[:count]
    return sorted({int(i) for i in np.concatenate([by_iterations, by_work])})


def ragged_alone_ms(device, task, max_its, tol=1e-3):
    """CUDA-event milliseconds of the ragged kernel on one task alone."""
    from rpvg_tpu_torch.infer.batching import pack_ragged
    from rpvg_tpu_torch.ops import em_cuda

    one = pack_ragged([task], device)
    return cuda_ms(lambda: em_cuda.em_fixed_point(one, max_its, tol), reps=5)


def slowest_task(device, task_list, iterations, max_its, tol=1e-3):
    """(index, milliseconds alone) of the slowest of the candidates."""
    timed = [
        (ragged_alone_ms(device, task_list[i], max_its, tol), i)
        for i in slowest_candidates(task_list, iterations)
    ]
    ms, i = max(timed)
    return i, ms


def per_iteration_us(device):
    """Microseconds per iteration of the ragged kernel on one seeded task
    alone, per shape: the time at 10,000 iterations less the time at
    2,000, over 8,000 (a negative tolerance never converges)."""
    import numpy as np

    from rpvg_tpu_torch.infer.batching import pack_ragged
    from rpvg_tpu_torch.ops import em_cuda
    from rpvg_tpu_torch.testing import random_task

    rng = np.random.default_rng(13)
    out = {}
    for shape in ((3, 9), (14, 16), (32, 32), (64, 64), (205, 41), (348, 61)):
        one = pack_ragged([random_task(rng, *shape)], device)
        short = cuda_ms(lambda: em_cuda.em_fixed_point(one, 2000, -1.0), reps=3)
        long = cuda_ms(lambda: em_cuda.em_fixed_point(one, 10000, -1.0), reps=3)
        out[shape] = (long - short) / 8000 * 1e3
    return out


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
    plain_ms = cuda_ms(lambda: em_cuda.em_fixed_point_plain(tasks, 10000, 1e-3), reps=1,
                       warmup=False)
    _, iters = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    bound_ms, bound_by = ragged_bound(tasks, iters)
    slow, alone_ms = slowest_task(device, task_list, iters.cpu().numpy(), 10000)
    plan = em_cuda.plan_launches(tasks.shapes[:, 0], tasks.shapes[:, 1])
    per_iteration = per_iteration_us(device)
    log(
        f"phase 2: EM at main-path shapes ({len(task_list)} tasks, "
        f"{int(tasks.probs.numel())} elements): kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (CUDA events, mean after warm-up), bound {bound_ms:.4f} ms "
        f"({bound_by}); slowest task {task_list[slow][0].shape} at "
        f"{int(iters[slow])} iterations alone {alone_ms:.3f} ms; "
        f"{len(plan)} launches per call (threads, staged, tasks): "
        f"{[(lc.threads, lc.staged, int(lc.tasks.size)) for lc in plan]}; one task alone, "
        f"microseconds per iteration (R x C: us): "
        + ", ".join(f"{R} x {C}: {us:.3f}" for (R, C), us in per_iteration.items())
    )
    return {
        "max_abs_err": max(a for a, _ in report.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "slowest_task_ms": alone_ms,
    }


def phase_main_path_em(torch, device, captured):
    """Phase 4, after the run: the ragged kernel on the tasks phase D
    handed to em_cuda.em_fixed_point (captured by the script), re-timed
    with CUDA events, held against its plain version, and its slowest task
    alone."""
    from rpvg_tpu_torch.infer.batching import fold_fractions
    from rpvg_tpu_torch.ops import em_cuda

    if len(captured) != 1:
        raise AssertionError(f"phase D called the ragged kernel {len(captured)} times, not once")
    tasks, max_its, tol = captured[0]
    probs, counts = tasks.probs.cpu().numpy(), tasks.counts.cpu().numpy()
    mat_off, row_off = tasks.mat_offsets.cpu().numpy(), tasks.row_offsets.cpu().numpy()
    task_list = [
        (probs[mat_off[i]:mat_off[i + 1]].reshape(R, C), counts[row_off[i]:row_off[i + 1]])
        for i, (R, C) in enumerate(tasks.shapes.tolist())
    ]
    k_fracs, k_iters = em_cuda.em_fixed_point(tasks, max_its, tol)
    kernel_ms = cuda_ms(lambda: em_cuda.em_fixed_point(tasks, max_its, tol), reps=5)
    p_fracs, p_iters = em_cuda.em_fixed_point_plain(tasks, max_its, tol)
    max_abs, max_rel, n_bad = compare_em(
        fold_fractions(k_fracs, tasks, task_list), fold_fractions(p_fracs, tasks, task_list)
    )
    iters = k_iters.cpu().numpy()
    off_by = int((iters != p_iters.cpu().numpy()).sum())
    bound_ms, bound_by = ragged_bound(tasks, k_iters)
    slow, alone_ms = slowest_task(device, task_list, iters, max_its, tol)
    log(
        f"phase 4: the run's phase-D tasks ({len(task_list)} tasks, max_em_its {max_its}) "
        f"re-timed: ragged kernel {kernel_ms:.3f} ms (CUDA events), bound {bound_ms:.4f} ms "
        f"({bound_by}); slowest task {task_list[slow][0].shape} at {int(iters[slow])} "
        f"iterations alone {alone_ms:.3f} ms; vs plain max abs {max_abs:.3e} max rel "
        f"{max_rel:.3e}, {n_bad} out of tolerance, {off_by} tasks with another iteration count"
    )
    if n_bad:
        raise AssertionError("EM kernel disagrees with plain version on the main path's tasks")
    return {"ms": kernel_ms, "bound_ms": bound_ms, "slowest_task_ms": alone_ms,
            "max_abs_err": max_abs}


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

    outs = run(kernel, 10000)
    iters = iterations(outs)
    extents = np.concatenate([em_fused_cuda.cluster_extents(blocks) for blocks in groups])
    in_elems = sum(p.numel() + c.numel() + m.numel() for blocks in groups for p, c, m in blocks)
    out_elems = sum(m.numel() for blocks in groups for _, _, m in blocks) + iters.size
    # Descriptors (5 int64 per block) and cluster offsets (blocks + 1).
    meta = sum(6 * len(blocks) + 1 for blocks in groups)
    bound_ms, bound_by = em_bound(
        8 * (in_elems + meta), 8 * out_elems, iters, extents[:, 0], extents[:, 1]
    )
    # The slowest cluster alone, in its own padded bucket.
    order = [i for group in plan for chunk, _, _ in group for i in chunk]
    timed = []
    for k in slowest_candidates([task_list[i] for i in order], iters):
        os.environ["RPVG_TPU_FUSE_EM"] = "1"
        try:
            (one,) = batching.plan_em_groups(task_list, [order[k]])
        finally:
            del os.environ["RPVG_TPU_FUSE_EM"]
        blocks = [batching.build_block(task_list, *chunk_plan, device) for chunk_plan in one]
        timed.append((cuda_ms(lambda: kernel(blocks, 10000, 1e-3), reps=5), order[k]))
    alone_ms, slow = max(timed)
    log(
        f"phase 5: EM at main-path shapes ({len(task_list)} tasks, {padded} padded "
        f"elements): multi-bucket kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"ragged kernel (phase 2) {ragged_ms:.3f} ms (CUDA events), bound "
        f"{bound_ms:.4f} ms ({bound_by}); slowest cluster {task_list[slow][0].shape} at "
        f"{int(iters.max())} iterations alone {alone_ms:.3f} ms"
    )
    return {
        "max_abs_err": max(report.values()), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "slowest_task_ms": alone_ms,
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
            and counts["fused_launches"] >= 1 and counts["fused_blocks"] >= 1
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

    from rpvg_tpu_torch import alignments, cli, native, sim
    from rpvg_tpu_torch.compare import check_estimate_file, compare_estimate_files
    from rpvg_tpu_torch.io import rpa
    from rpvg_tpu_torch.ops import build, em_cuda, em_fused_cuda

    t0 = time.perf_counter()
    if native.load_library() is None:
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
        small = write_dataset(sim, rpa, alignments, work,
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
        bench = write_dataset(sim, rpa, alignments, work,
                              num_genes=1286, num_pairs=PAIRS, seed_panel=5, seed_reads=17)
        log(f"phase 4: synthesised {PAIRS} pairs over 1286 genes in "
            f"{time.perf_counter() - t0:.1f}s (set-up, not timed below)")
        # Phase D's tasks are captured by wrapping the kernel's entry here.
        captured = []
        launch = em_cuda.em_fixed_point

        def capture(tasks, max_em_its, max_rel_em_conv):
            captured.append((tasks, max_em_its, max_rel_em_conv))
            return launch(tasks, max_em_its, max_rel_em_conv)

        em_cuda.em_fixed_point = capture
        try:
            _, counts = bench_run(torch, device, cli, check_estimate_file, 4, bench,
                                  os.path.join(work, "bench"), threads,
                                  "haplotype-transcripts", info=True)
        finally:
            em_cuda.em_fixed_point = launch
        ragged_launches = main_path_launches = counts["ragged_launches"]
        main_em = phase_main_path_em(torch, device, captured)

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
                fused_route_tasks = counts["fused_tasks"]
            else:
                ragged_launches += counts["ragged_launches"]
        rep = compare_estimate_files(
            prefixes[("transcripts", True)] + ".txt", prefixes[("transcripts", False)] + ".txt",
            RTOL, ATOL_OUT,
        )
        log(f"phase 6: transcripts -f, multi-bucket vs ragged route: rows identical, "
            f"{rep['rows']} rows, max abs {rep['max_abs_diff']:.3e}, max rel "
            f"{rep['max_rel_diff']:.3e}, byte-identical {rep['byte_identical']}")

    kernels = [
        {
            "name": em_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/em_fixed_point.cu",
            "replaces": "rpvg_tpu/ops/em_pallas.py:46",
            "launches": main_path_launches,
            "max_abs_err": max(em["max_abs_err"], main_em["max_abs_err"]),
            "ms": em["ms"],
            "plain_ms": em["plain_ms"],
            "bound_ms": em["bound_ms"],
            "bound_by": em["bound_by"],
            "library_ms": None,
            "launches_per_main_path_run": main_path_launches,
            "launches_all_model_runs": ragged_launches,
            "slowest_task_ms": em["slowest_task_ms"],
            "main_path_tasks_ms": main_em["ms"],
            "main_path_tasks_bound_ms": main_em["bound_ms"],
            "main_path_slowest_task_ms": main_em["slowest_task_ms"],
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
            "bound_ms": fused_em["bound_ms"],
            "bound_by": fused_em["bound_by"],
            "library_ms": None,
            "launches_per_main_path_run": fused_launches,
            "main_path_run": f"transcripts -f, RPVG_TPU_FUSE_EM=1 ({fused_route_tasks} tasks)",
            "slowest_task_ms": fused_em["slowest_task_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
