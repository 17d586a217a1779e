#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (rpvg_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints at least one line; any failure exits non-zero):

0. the card (nvidia-smi name and power limit), torch, and the port's own
   native host library (built with g++ from rpvg_tpu_torch/csrc/host at
   first use);
1. build all six kernels (both EM kernels, the read-count and the
   pair-score Gibbs samplers, the group scorer and the k-slot sampler) from
   rpvg_tpu_torch/csrc with nvcc for sm_90a, in parallel, and beside them
   two one-log probes whose SASS (cuobjdump) counts the FP64 instructions
   of one float64 log, libdevice's and the group scorer's own
   (csrc/log_f64.cuh), for the bounds of phases 11 and 12;
2. the ragged kernel against its plain PyTorch version on the card, on a
   seeded task set shaped like the main path's phase D; its time beside
   its roofline bound, and its slowest task alone;
3. the port's CLI with --backend cuda and --backend cpu for all four
   models, haplotypes -y 3 and haplotype-transcripts -f -y 3,
   haplotypes -y 4 (on a 3-isoform panel, whose clusters stay under the
   enumeration limit) and haplotype-transcripts -f -y 4,
   --ind-hap-inference at -y 2 and -y 3, --multiprocess 2, -b (whose
   _probs.txt.gz must be byte-identical), quality-scored alignments
   (without --score-not-qual), --single-end and --long-reads (400-base
   single reads), on small gene panels:
   identical rows, numbers within rtol 1e-6 / atol 1e-6;
4. the main path at bench scale (haplotype-transcripts, 100k read pairs
   over 1,286 genes x 7 isoforms x 4 haplotypes), with the run's counters
   read just after; the tasks phase D hands to
   em_cuda.em_fixed_point are captured (the script wraps that entry) and
   the kernel is re-timed on them, held against its plain version, and
   their slowest task timed alone;
5. the multi-bucket kernel against its plain PyTorch version on the
   launch groups that dispatch_em_device plans for phase 2's task set,
   and against the ragged kernel (bitwise); its bound and slowest cluster;
6. transcripts -f (ragged route, then RPVG_TPU_FUSE_EM=1), strains and
   haplotypes on phase 4's dataset, each with the run's counters
   read just after;
9. (run before 7 and 8) the Gibbs configurations at full width on phase
   4's dataset: haplotype-transcripts -f -n 100 (the read-count
   sampler's main path; the jobs its phase D2 hands
   gibbs_cuda.gibbs_read_counts are captured), transcripts -f -n 100,
   strains -n 100, haplotypes --use-hap-gibbs (the posterior sampler's
   main path; its clusters are captured), and the -n 100 main path on
   --backend cpu (native samplers) held against the cuda run;
7. the read-count Gibbs kernel against its plain version on 261 seeded
   jobs (every kept fraction within rtol 1e-9, or the job held to the
   distributional bounds against the native sampler), against the native
   sampler on tests/test_gibbs_crossbackend.py's fixture, then on phase
   9's captured jobs: their first min(S, 8) samples against the plain
   version likewise, and re-timed; their slowest job alone, its cycles
   per iteration between the kernel's clock64 marks
   (tools/torch_gibbs_profile.py's build), and its dependent-chain floor
   (its iterations x the time of an iteration with no work);
8. the posterior Gibbs kernel likewise (every sampled pair equal to the
   plain version's, or the cluster within total variation 0.05; against
   the native sampler on the fixture), on seeded clusters of up to 200
   paths and on phase 9's captured clusters, then re-timed on those; its
   launches and blocks per SM on them, and their slowest cluster's
   dependent-chain floor (its steps x the time of a step with no work);
10. (run before 7, 8, 11 and 12, inside the dataset's directory) ploidy
   3 and 4 at full width on phase 4's dataset: haplotypes -y 3,
   haplotype-transcripts -f -y 3, haplotypes -y 3 --use-hap-gibbs and
   haplotype-transcripts -f -y 4,
   each with the run's counters read just after; what
   the group scorer, the host enumeration engine and the k-slot sampler
   were handed is captured;
   per run wall, pairs/s, phases, peak memory, the histogram of P and the
   clusters the host enumeration engine took, with its seconds;
11. the group-score kernel against its plain version on 256 seeded
   clusters per group size 1, 3, 4 and 5 (every score within rtol 1e-10,
   -inf where plain is, bitwise the same on a second run), on phase 10's
   captured clusters and on the clusters its haplotypes -y 3 run handed
   the host enumeration engine (their route unchanged); each timed beside
   group_scores_bound for R x G logs and for the logs the kernel computes
   (tools/torch_group_scores_profile.py's count), with the share of zero
   probabilities, of U and of busy lanes, and the blocks per SM;
12. the k-slot sampler likewise at k = 3 on 65 seeded clusters of up to
   200 paths and at k = 1 and 4 on 17 of them (every group equal to the
   plain version's, or the
   cluster within total variation 0.05 of it; diverged clusters counted)
   and on phase 10's --use-hap-gibbs clusters: their share of zero
   probabilities and of (32-path, row) tiles holding a nonzero, the logs
   the bound counts (R + nonzeros per slot step) beside R x P, and the
   slowest chain alone with its cycles per slot step and its
   dependent-chain floor;
13. (run inside the dataset's directory, after 10) haplotype-transcripts
   -f --ind-hap-inference on phase 4's dataset, with the run's counters
   read just after: wall, pairs/s, phases I1-I3 and C-E,
   EM tasks, peak memory; the tasks its phase D hands
   em_cuda.em_fixed_point are captured, re-timed, held against the plain
   version and their slowest task timed alone, as in phase 4;
14. the main path with --multiprocess 4 through the CLI in a fresh
   interpreter: its workers fork before any CUDA context exists (each
   records the CUDA state it finds), its outputs are phase 4's bytes, and
   its fragment pass (slowest worker's scan, merge) is printed beside
   phase 4's;
15. the shard logic of rpvg_tpu_torch/parallel on 4 virtual shards of
   cuda:0 (autoshard.virtual_devices) with the real kernels: (a) phase
   4's main path, byte-identical to phase 4's outputs, its wall and tasks
   per shard beside phase 4's, and (a') its phase-B pair scores in one
   shard's chunks against four shards' (bitwise, or the largest relative
   difference stated and held to rtol 1e-10); (b) phase 3's
   configurations of all four models, -y 3, -b, -n 8 and --use-hap-gibbs
   against phase 3's one-shard cuda outputs (byte-identical, or the
   estimate files equal under compare.py with the difference stated);
   (c) the giant-cluster shard route under a lowered
   RPVG_TPU_PAIR_TENSOR_LIMIT, asserted to have run; (d) sharded_em_step
   with the multi-bucket kernel on each shard against its plain version;
   (e) entry.dryrun_multidevice(4, cuda, virtual=True); (f) with more
   than one CUDA device, (a) and (e) on the real devices, else a line
   saying that only virtual shards ran;
16. the JAX package's fused native routes on phase 4's dataset, each
   run with the run's counters read just after (every
   task of a device leg in an EM kernel, every Gibbs job in the
   read-count kernel): (a) RPVG_TPU_FUSED_NESTED=1 at the port's
   defaults on cuda (the escalated tail on the ragged kernel, re-timed
   on what it was handed and held against its plain version) and cpu,
   then the staged and fused routes in turns; (b) with
   RPVG_TPU_ESC_MIN_AREA at the JAX package's 10^12, the tail on the
   host; (c) the link's dispatch latency and host-to-device rate, and
   the 16 largest slots routed (RPVG_TPU_DEVICE_SLOT_AREA) to the
   multi-bucket kernel, re-timed on the blocks it was handed and held
   against its plain version, with the dispatch's return time against
   the gather's wait; (d) -n 100, its _gibbs.txt.gz within phase 9's
   bounds of the fused cpu run; (e) RPVG_TPU_FUSED_STRAINS=1 plain (in
   turns with the staged route) and -n 100, against the staged runs;
   (f) RPVG_TPU_COMPOSE_OUT=0 against the composer, byte for byte.
   Estimate files are held to the cpu or staged runs within rtol 1e-6;
17. the profiler hook: phase 4's main path and phase 16 (a)'s fused
   nested route, each without RPVG_TPU_TORCH_PROFILE and then with it
   (the same estimate bytes, one Chrome trace): per trace the card's busy
   share of the profiled window (the union of kernel, copy and set
   intervals over all streams), the 5 device operations with the most
   time, the 3 longest idle gaps with the host event that overlaps each,
   and the hook's cost in wall.  It fails when a trace holds no CUDA
   activity or the main path's lacks the ragged EM kernel.

Phase 3 also runs the CPU tests' seven Gibbs configurations (-n 8 for
every abundance model, --use-hap-gibbs for both haplotype models),
--use-hap-gibbs at -y 3 for both haplotype models, and
--ind-hap-inference with -n 8 and with --use-hap-gibbs on both devices: -n
runs keep their point estimates within rtol 1e-6 and their _gibbs.txt.gz
rows within 6 standard errors; --use-hap-gibbs posteriors are no further
apart across devices (total variation per cluster) than two CPU runs
with different seeds.

The last two lines are a JSON line of kernel results and
{"ok": true, "device": {...}}.  Without CUDA the script exits 1 and
prints no result.
"""

import collections
import concurrent.futures
import json
import math
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
FP64_FLOPS_NO_TENSOR = 34e12


T_START = time.perf_counter()


def log(line: str) -> None:
    """Print a result line, with the script's elapsed seconds at its end."""
    print(f"{line} [{time.perf_counter() - T_START:.0f}s]", flush=True)


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


def timed_once(fn):
    """(``fn()``'s result, its milliseconds by CUDA events): one run, no
    warm-up, for the plain versions, which take seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    stop.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(stop)


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


def phase_main_path_em(torch, device, captured, phase=4, run="the run", plain_tasks=None):
    """Phase 4 (and 13), after the run: the ragged kernel on the tasks
    phase D handed to em_cuda.em_fixed_point (captured by the script),
    re-timed with CUDA events, held against its plain version (timed),
    and its slowest task alone.  With ``plain_tasks`` and more tasks than
    that, the plain version (which steps each padded bucket in torch ops
    and took 483 s on phase 13's 256,874 tasks) runs on a sample: every
    k-th task, k the task count over ``plain_tasks`` rounded up, and the
    candidates for the slowest task; the kernel is timed on the sample
    too, for a like-for-like ``ms`` and ``plain_ms``."""
    from rpvg_tpu_torch.infer.batching import fold_fractions, pack_ragged
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
    iters = k_iters.cpu().numpy()
    bound_ms, bound_by = ragged_bound(tasks, k_iters)
    slow, alone_ms = slowest_task(device, task_list, iters, max_its, tol)
    result = {"ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "slowest_task_ms": alone_ms, "tasks": len(task_list)}
    held, held_list, held_fracs, held_iters = tasks, task_list, k_fracs, k_iters
    sampled = ""
    if plain_tasks is not None and len(task_list) > plain_tasks:
        step = -(-len(task_list) // plain_tasks)
        picked = sorted(set(range(0, len(task_list), step))
                        | set(slowest_candidates(task_list, iters)))
        held_list = [task_list[i] for i in picked]
        held = pack_ragged(held_list, device)
        held_fracs, held_iters = em_cuda.em_fixed_point(held, max_its, tol)
        result["ms"] = cuda_ms(lambda: em_cuda.em_fixed_point(held, max_its, tol), reps=5)
        result["bound_ms"], result["bound_by"] = ragged_bound(held, held_iters)
        result.update(all_tasks_ms=kernel_ms, all_tasks_bound_ms=bound_ms,
                      all_tasks_bound_by=bound_by, sample_tasks=len(held_list))
        sampled = (
            f"; plain version on a sample of {len(held_list)} tasks (every {step}th and the "
            f"slowest candidates): kernel {result['ms']:.3f} ms, bound "
            f"{result['bound_ms']:.4f} ms ({result['bound_by']}) on it"
        )
    (p_fracs, p_iters), plain_ms = timed_once(
        lambda: em_cuda.em_fixed_point_plain(held, max_its, tol)
    )
    max_abs, max_rel, n_bad = compare_em(
        fold_fractions(held_fracs, held, held_list), fold_fractions(p_fracs, held, held_list)
    )
    off_by = int((held_iters.cpu().numpy() != p_iters.cpu().numpy()).sum())
    result.update(plain_ms=plain_ms, max_abs_err=max_abs)
    log(
        f"phase {phase}: {run}'s phase-D tasks ({len(task_list)} tasks, "
        f"{int(tasks.probs.numel())} elements, max_em_its {max_its}) re-timed: ragged kernel "
        f"{kernel_ms:.3f} ms (CUDA events), bound {bound_ms:.4f} ms ({bound_by}); slowest "
        f"task {task_list[slow][0].shape} at {int(iters[slow])} iterations alone "
        f"{alone_ms:.3f} ms{sampled}; plain {plain_ms:.1f} ms (one run); vs plain max abs "
        f"{max_abs:.3e} max rel {max_rel:.3e}, {n_bad} out of tolerance (rtol {RTOL}, atol "
        f"{ATOL_EM}), {off_by} tasks with another iteration count"
    )
    if n_bad:
        raise AssertionError(f"EM kernel disagrees with plain version on {run}'s tasks")
    return result


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


GIBBS_THIN = 25
N_SE = 6.0
KS_P = 1e-3
TV_MAX = 0.05
# Largest mean excess of the cuda-vs-cpu total variation of a cluster's
# --use-hap-gibbs posterior over the cpu-vs-cpu one (another seed).
TV_EXCESS = 0.01


def gibbs_rows_allowed(rows):
    """_gibbs.txt.gz rows allowed outside N_SE standard errors across
    devices.  A chain keeps few, autocorrelated samples, and two near-equal
    haplotypes of one transcript swap mass between them for stretches of
    it, so the sample standard error of such a pair understates its spread
    and two rows at a time land far out under a correct sampler (seen
    between two CPU samplers drawing different streams)."""
    return max(4, math.ceil(0.005 * rows))


def gibbs_clusters_allowed(clusters):
    """Clusters whose _gibbs.txt.gz row set may differ across devices.  On
    cpu the pair posteriors come from C++, on cuda from the torch op; in
    the last bit they differ, and where ``_nested_gibbs``'s binomial
    thinning of a cluster's samples over its subsets lands on that bit, a
    subset gets another count of samples, none at worst, and its paths
    another set of rows."""
    return max(4, math.ceil(0.005 * clusters))


def hold_gibbs_rows(compare, path, reference):
    """Two -n runs' _gibbs.txt.gz across devices: the same rows, or the
    clusters whose row sets differ counted and held to
    gibbs_clusters_allowed; the rows both files have within N_SE standard
    errors (compare.compare_gibbs_files), at most gibbs_rows_allowed of
    them outside.  Returns its report with ``clusters``, ``differing``
    (clusters) and ``only_one`` (rows in one file only)."""
    _, rows = compare.read_gibbs_file(path)
    _, ref_rows = compare.read_gibbs_file(reference)
    names = {}
    for which, keys in enumerate((rows, ref_rows)):
        for name, cluster in keys:
            names.setdefault(cluster, (set(), set()))[which].add(name)
    differing = sum(a != b for a, b in names.values())
    rep = compare.compare_gibbs_files(path, reference, N_SE,
                                      same_rows=list(rows) == list(ref_rows))
    rep.update(clusters=len(names), differing=differing,
               only_one=sum(len(a ^ b) for a, b in names.values()))
    rep["ok"] = (rep["outside"] <= gibbs_rows_allowed(rep["rows"])
                 and differing <= gibbs_clusters_allowed(len(names)))
    return rep


def gibbs_rows_text(rep):
    """A hold_gibbs_rows report as text."""
    rows = ("same rows" if not rep["differing"] else
            f"{rep['differing']} of {rep['clusters']} clusters with another row set (allowed "
            f"{gibbs_clusters_allowed(rep['clusters'])}), {rep['only_one']} rows in one file only")
    return (f"_gibbs.txt.gz {rep['rows']} common rows ({rows}), {rep['outside']} outside "
            f"{N_SE:.0f} se (allowed {gibbs_rows_allowed(rep['rows'])}), worst "
            f"{rep['max_se']:.2f} se")


def distribution_check(a, b):
    """(largest mean difference in standard errors, smallest KS p-value)
    over the columns of two sample matrices (samples x columns), and
    whether both bounds of tests/test_gibbs_crossbackend.py hold (means
    within 6 standard errors, KS p > 1e-3)."""
    import numpy as np
    from scipy.stats import ks_2samp

    worst_se, worst_p = 0.0, 1.0
    ok = True
    for j in range(a.shape[1]):
        x, y = a[:, j], b[:, j]
        se = np.sqrt(x.var() / x.size + y.var() / y.size)
        diff = abs(x.mean() - y.mean())
        if diff > max(N_SE * se, 1e-9 * max(1.0, abs(y.mean()))):
            ok = False
        if se > 0:
            worst_se = max(worst_se, diff / se)
        if x.std() > 0 or y.std() > 0:
            p = ks_2samp(x, y).pvalue
            worst_p = min(worst_p, p)
            ok = ok and p > KS_P
    return worst_se, worst_p, ok


def total_variation(a, b):
    support = set(a) | set(b)
    return 0.5 * sum(abs(a.get(g, 0.0) - b.get(g, 0.0)) for g in support)


def gibbs_fixture():
    """tests/test_gibbs_crossbackend.py's 60 x 7 cluster."""
    import numpy as np

    rng = np.random.default_rng(21)
    R, P = 60, 6
    probs = rng.random((R, P + 1)) * 0.5
    probs /= probs.sum(axis=1, keepdims=True)
    counts = rng.integers(1, 12, size=R).astype(np.float64)
    return probs, counts


def gibbs_job_slices(jobs, out):
    """Per job, its kept fractions (S, C) as a host array."""
    out = out.cpu().numpy()
    offsets = jobs.out_offsets.cpu().numpy()
    return [
        out[offsets[j] : offsets[j + 1]].reshape(int(jobs.host_samples[j]), int(C))
        for j, C in enumerate(jobs.shapes[:, 1])
    ]


def gibbs_bound(jobs, thin):
    """(bound ms, what bounds it) of a read-count Gibbs call: every task
    matrix, count, starting fraction and per-job word read once and every
    kept fraction written once at the HBM rate, against the least
    arithmetic the function needs at the FP64 peak, whatever algorithm
    computes it.  Per iteration of a job:
    - 2 R C for the rows' masses, a product and an add per element (the
      running sums are each row's CDF);
    - per row of n > 0 reads and positive mass, its multinomial split as
      the fewer of n binary searches of that CDF (ceil(log2 C)
      comparisons each) and C conditional binomial draws (one operation
      each);
    - 3 C for the columns' Gamma draws (one operation each), their sum
      and the normalisation.
    The random bits (integer Philox rounds) and a draw's cost beyond one
    operation are not counted, so the bound is a lower bound."""
    import numpy as np

    shapes = jobs.shapes
    R, C = shapes[:, 0].astype(np.float64), shapes[:, 1].astype(np.float64)
    S = jobs.host_samples.astype(np.float64)
    tasks = jobs.tasks
    probs = tasks.probs.cpu().numpy()
    counts = tasks.counts.cpu().numpy()
    mat_off = tasks.mat_offsets.cpu().numpy()
    row_off = tasks.row_offsets.cpu().numpy()
    split = np.zeros(jobs.n_jobs)
    for j, task in enumerate(jobs.host_task_ids):
        rows, cols = int(shapes[j, 0]), int(shapes[j, 1])
        n = counts[row_off[task]:row_off[task + 1]]
        mass = probs[mat_off[task]:mat_off[task + 1]].reshape(rows, cols).sum(axis=1)
        n = n[(n > 0) & (mass > 0)]
        split[j] = np.minimum(n * math.ceil(math.log2(cols)), cols).sum()
    in_bytes = 8 * float((R * C + R + C + 7).sum())
    out_bytes = 8 * float((S * C).sum())
    flops = float((S * thin * (2 * R * C + split + 3 * C)).sum())
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP64_FLOPS * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def k_slot_logs(jobs, dense=False):
    """FP64 logs of a k-slot call: over clusters, chains x (burn + its) x k
    x (R + nonzeros), one per row and one per nonzero probability (a zero
    entry's log is its row's, computed once), or with ``dense`` R x P, one
    per entry as the first kernel computed them."""
    import numpy as np

    h = jobs.host
    R, P = h["n_rows"].astype(np.float64), h["n_cols"].astype(np.float64)
    per_step = R * P if dense else R + h["n_nonzeros"].astype(np.float64)
    steps = (h["n_chains"] * (h["n_burn"] + h["n_its"])).astype(np.float64)
    return float((steps * jobs.group_size * per_step).sum())


def posterior_bound(jobs, per_log=None):
    """(bound ms, what bounds it) of a posterior Gibbs call.

    Group size 2 (``PosteriorJobs``): the (P, P) scores read once and the
    sampled int32 pairs written once at the HBM rate, against 4 P^2 flops
    (maximum, difference, exponential and sum, then the division) for the
    CDFs plus two binary searches of ceil(log2 P) comparisons per chain
    step, at the FP64 peak.

    k slots (``KSlotJobs``): the probabilities, noise, counts and log
    frequencies read once and every iteration's int32 group written once
    at the HBM rate, against the FP64 logs the function needs
    (``k_slot_logs``: R + nonzeros per slot step), each ``per_log`` FP64
    instructions (this build's SASS, ``fp64_log_instructions``) counted as
    one operation at the FP64 peak without tensor cores (34 TFLOP/s; a
    lower bound, since that peak counts a fused multiply-add as two)."""
    import numpy as np

    h = jobs.host
    if per_log is not None:
        R, P = h["n_rows"].astype(np.float64), h["n_cols"].astype(np.float64)
        in_bytes = 8 * float((R * P + 2 * R + P + 11).sum())
        out_bytes = 4 * float(h["out_offsets"][-1])
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = k_slot_logs(jobs) * per_log / FP64_FLOPS_NO_TENSOR * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
    P = h["n_cols"].astype(np.float64)
    steps = (h["n_chains"] * (h["n_burn"] + h["n_its"])).astype(np.float64)
    in_bytes = 8 * float((P * P + 7).sum())
    out_bytes = 8 * float((h["n_chains"] * h["n_its"]).sum())
    flops = float((4 * P * P + steps * 2 * np.ceil(np.log2(P + 1))).sum())
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP64_FLOPS * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def group_scores_bound(clusters, per_log, logs=None):
    """(bound ms, what bounds it) of a group-score call: probabilities,
    noise, counts, the group tables and per-cluster words read once and
    the float64 scores written once at the HBM rate, against the FP64
    logs, ``logs`` of them (by default one per (row, group) of every
    cluster, R x G), each ``per_log`` FP64 instructions (this build's
    SASS) counted as one operation at the FP64 peak without tensor cores
    (34 TFLOP/s; a lower bound, since that peak counts a fused
    multiply-add as two)."""
    import numpy as np

    h = clusters.host
    R, P = h["n_rows"].astype(np.float64), h["n_cols"].astype(np.float64)
    if logs is None:
        logs = float((R * h["n_groups"]).sum())
    in_bytes = 8 * float((R * P + 2 * R + 7).sum()) + 4 * clusters.table.numel()
    out_bytes = 8 * float(h["out_offsets"][-1])
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = logs * per_log / FP64_FLOPS_NO_TENSOR * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def group_score_logs(clusters):
    """(R x G logs, the logs the kernel computes: R x P for the last slot
    plus every group's rows U, lane-busy share of its warps, share of zero
    probabilities) of GroupClusters, by tools/torch_group_scores_profile.py's
    count."""
    tool = load_tool("torch_group_scores_profile.py")
    inputs = tool.host_inputs(clusters)
    dense, factored, busy = tool.factored_logs(inputs, clusters.group_size)
    return dense, factored, busy, tool.zero_share(inputs)


LOG_PROBE = r"""
extern "C" __global__ void log_probe(const double* x, double* y) {
  y[threadIdx.x] = log(x[threadIdx.x]);
}
"""
# The group scorer's own log (rpvg_tpu_torch/csrc/log_f64.cuh).
TABLE_LOG_PROBE = r"""
#include "log_f64.cuh"
extern "C" __global__ void log_probe(const double* x, const double2* table, double* y) {
  y[threadIdx.x] = log_f64::log_pos(x[threadIdx.x], table);
}
"""
FP64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")


def fp64_log_instructions(work, source=LOG_PROBE):
    """(FP64 instructions of one double-precision log, by opcode) in the
    SASS of a one-log kernel built with the kernels' nvcc flags for
    sm_90a: every FP64-pipe instruction of the function, its rare paths
    (zero, negative, denormal, infinite arguments) included.  ``source``
    is libdevice's log (LOG_PROBE) or the group scorer's
    (TABLE_LOG_PROBE)."""
    import re
    from collections import Counter

    from rpvg_tpu_torch.ops import build

    name = "log_probe" if source is LOG_PROBE else "table_log_probe"
    src, cubin = os.path.join(work, name + ".cu"), os.path.join(work, name + ".cubin")
    with open(src, "w") as handle:
        handle.write(source)
    nvcc = build._nvcc()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-I",
                    build.CSRC_DIR, "-o", cubin, src], check=True, capture_output=True, text=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                          check=True, capture_output=True, text=True).stdout
    ops = Counter(re.findall(r"\b(" + "|".join(FP64_OPCODES) + r")(?=[ .])", sass))
    return sum(ops.values()), dict(ops)


def load_tool(name):
    """tools/<name> as a module (the profile tools' clock64 builds and
    sparsity counts)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def profile_tool():
    """tools/torch_gibbs_profile.py as a module."""
    return load_tool("torch_gibbs_profile.py")


def step_cycles(module, call, steps):
    """Cycles per step between the kernel's clock64 marks (thread 0 of
    block 0, a build with -DRPVG_GIBBS_PROFILE) over one ``call()`` of
    ``steps`` steps, and whether that build's output is the port's."""
    from rpvg_tpu_torch.ops import build

    tool = profile_tool()
    lib, marks = tool.profiled_library(build, module)
    cycles, same = tool.run_profiled(module, lib, marks, call)
    return [round(c / steps) for c in cycles], same


def readcount_minimum_us(device):
    """Microseconds of one read-count iteration with no work: a 1 x 1
    job's time at 2,000 iterations less at 1,000, over 1,000."""
    import numpy as np

    from rpvg_tpu_torch.infer.batching import pack_ragged
    from rpvg_tpu_torch.ops import gibbs_cuda

    tiny = pack_ragged([(np.ones((1, 1)), np.ones(1))], device)

    def ms(samples):
        jobs = gibbs_cuda.make_jobs(tiny, [0], [np.ones(1)], [1], [samples])
        return cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(jobs, 10, 1.0), reps=5)

    return (ms(200) - ms(100)) / 1000 * 1e3


def k_slot_minimum_us(device, k):
    """Microseconds of one slot step with no work: a 1-row, 1-path
    cluster's one chain at 2,000 iterations less at 1,000, over 1,000 k."""
    import numpy as np

    from rpvg_tpu_torch.ops import posterior_gibbs_k_cuda

    tiny = (np.ones((1, 1)), np.full(1, 0.01), np.ones(1), np.zeros(1))

    def ms(its):
        jobs = posterior_gibbs_k_cuda.make_jobs([tiny], k, [(1, its // 2, its // 2)], [1], device)
        return cuda_ms(lambda: posterior_gibbs_k_cuda.posterior_gibbs_k(jobs), reps=5)

    return (ms(2000) - ms(1000)) / (1000 * k) * 1e3


def pair_step_minimum_us(device):
    """Microseconds of one pair-sampler step with no work: a one-path
    cluster's one chain at 4,000 steps less at 2,000, over 2,000."""
    import torch

    from rpvg_tpu_torch.ops import posterior_gibbs_cuda

    one = torch.zeros(1, dtype=torch.float64, device=device)

    def ms(steps):
        jobs = posterior_gibbs_cuda.make_jobs(one, [0], [1], [1], [(1, steps // 2, steps // 2)], [1])
        return cuda_ms(lambda: posterior_gibbs_cuda.posterior_gibbs(jobs), reps=10)

    return (ms(4000) - ms(2000)) / 2000 * 1e3


def gibbs_job_item(jobs, j):
    """Job j of ``jobs`` as a sampler input (P, counts, abundances, noise,
    total 1: its starting fractions as they are) and its threefry key,
    read back from the card."""
    import numpy as np

    tasks = jobs.tasks
    task = int(jobs.host_task_ids[j])
    rows, cols = map(int, tasks.shapes[task])
    m0, r0 = int(tasks.mat_offsets[task]), int(tasks.row_offsets[task])
    probs = tasks.probs[m0:m0 + rows * cols].cpu().numpy().reshape(rows, cols)
    counts = tasks.counts[r0:r0 + rows].cpu().numpy()
    f0, f1 = int(jobs.frac_offsets[j]), int(jobs.frac_offsets[j + 1])
    fracs = jobs.init_fracs[f0:f1].cpu().numpy()
    seed = int(jobs.seeds[j].item()) & 0xFFFFFFFFFFFFFFFF
    key = np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)
    return (probs, counts, fracs[:-1], float(fracs[-1]), 1.0), key


def check_diverged_job(label, item, key, device, thin, gamma):
    """A job whose kernel samples left the plain version's is held to the
    distributional bounds: 200 samples from the kernel and from the native
    sampler, both folded as the outputs fold them."""
    import numpy as np

    from rpvg_tpu_torch.infer import readcount_gibbs

    on_card = readcount_gibbs.run_batched_gibbs([item], [key], 200, thin, gamma, device)[0]
    native = readcount_gibbs.run_native_gibbs([item], [key], 200, thin, gamma)[0]
    worst_se, worst_p, ok = distribution_check(
        np.column_stack([on_card[1], on_card[0]]), np.column_stack([native[1], native[0]])
    )
    if not ok:
        raise AssertionError(
            f"diverged {label} {item[0].shape} fails the distributional bounds against the "
            f"native sampler: {worst_se:.2f} se, KS p {worst_p:.2e}"
        )


def compare_gibbs(jobs, kernel, plain):
    """(jobs whose kept fractions leave rtol 1e-9 of the plain version's,
    the largest absolute difference over the others)."""
    import numpy as np

    diverged, max_abs = [], 0.0
    for j, (k, p) in enumerate(zip(gibbs_job_slices(jobs, kernel), gibbs_job_slices(jobs, plain))):
        if not np.allclose(k, p, rtol=1e-9, atol=0.0):
            diverged.append(j)
        elif k.size:
            max_abs = max(max_abs, float(np.abs(k - p).max()))
    return diverged, max_abs


def phase_gibbs_kernel(torch, device, captured):
    """Phase 7: the read-count kernel against its plain version on 261
    seeded jobs shaped like phase D's tasks (8 samples at thin 25), every
    diverged job held to the distributional bounds against the native
    sampler; against the native sampler on the crossbackend fixture; then
    on the jobs phase D2 of phase 9's -n 100 main-path run handed it:
    re-timed, their first min(S, 8) samples held against the plain version
    (and against the kernel's full run: the same prefix), and their
    slowest job timed alone."""
    import numpy as np

    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.infer import readcount_gibbs
    from rpvg_tpu_torch.ops import gibbs_cuda
    from rpvg_tpu_torch.testing import gibbs_job_set, gibbs_jobs_on

    inputs = gibbs_job_set(256, seed=61)
    jobs = gibbs_jobs_on(inputs, device, [8] * len(inputs), seed=62)
    kernel = gibbs_cuda.gibbs_read_counts(jobs, GIBBS_THIN, 1.0)
    again = gibbs_cuda.gibbs_read_counts(jobs, GIBBS_THIN, 1.0)
    torch.cuda.synchronize()
    if not torch.equal(kernel, again):
        raise AssertionError("read-count Gibbs kernel is not deterministic across runs")
    plain = gibbs_cuda.gibbs_read_counts_plain(jobs, GIBBS_THIN, 1.0)
    diverged, max_abs = compare_gibbs(jobs, kernel, plain)
    keys = prng.split(prng.prng_key(62), len(inputs))
    for j in diverged:
        check_diverged_job(f"seeded job {j}", inputs[j], keys[j], device, GIBBS_THIN, 1.0)
    kernel_ms = cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(jobs, GIBBS_THIN, 1.0), reps=10)
    plain_ms = cuda_ms(lambda: gibbs_cuda.gibbs_read_counts_plain(jobs, GIBBS_THIN, 1.0),
                       reps=1, warmup=False)
    bound_ms, bound_by = gibbs_bound(jobs, GIBBS_THIN)
    log(
        f"phase 7: read-count Gibbs kernel vs plain on {len(inputs)} seeded jobs (8 samples, "
        f"thin {GIBBS_THIN}): {len(inputs) - len(diverged)} within rtol 1e-9 (max abs "
        f"{max_abs:.3e}), {len(diverged)} diverged (each within {N_SE:.0f} se and KS p > "
        f"{KS_P} of the native sampler at 200 samples); kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (CUDA events), bound {bound_ms:.5f} ms ({bound_by})"
    )

    # The crossbackend fixture: 400 samples at thin 50, one chain each.
    probs, counts = gibbs_fixture()
    total = float(counts.sum())
    item = (probs, counts, np.full(6, total / 6), 1.0, total)
    key = prng.prng_key(77)
    on_card = readcount_gibbs.run_batched_gibbs([item], [key], 400, 50, 1.0, device)[0]
    native = readcount_gibbs.run_native_gibbs([item], [key], 400, 50)[0]
    worst_se, worst_p, ok = distribution_check(
        np.column_stack([on_card[1], on_card[0]]), np.column_stack([native[1], native[0]])
    )
    log(
        f"phase 7: read-count Gibbs on cuda vs the native sampler, crossbackend fixture "
        f"(60 x 7, 400 samples at thin 50): worst mean difference {worst_se:.2f} se, "
        f"smallest KS p {worst_p:.3e}"
    )
    if not ok:
        raise AssertionError("read-count Gibbs on cuda fails the distributional bounds")

    if len(captured) != 1:
        raise AssertionError(f"phase D2 called the read-count kernel {len(captured)} times, not once")
    main_jobs, thin, gamma = captured[0]
    full = gibbs_cuda.gibbs_read_counts(main_jobs, thin, gamma)
    main_ms = cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(main_jobs, thin, gamma), reps=3)
    main_bound, main_by = gibbs_bound(main_jobs, thin)
    # The plain version on the main path's jobs: a shorter run is the
    # prefix of a longer one on the same counters, so the jobs are rebuilt
    # at min(S, 8) samples on the same packed tasks, fractions and seeds.
    fracs = main_jobs.init_fracs.cpu().numpy()
    offsets = main_jobs.frac_offsets.cpu().numpy()
    short = gibbs_cuda.make_jobs(
        main_jobs.tasks, main_jobs.host_task_ids,
        [fracs[offsets[j]:offsets[j + 1]] for j in range(main_jobs.n_jobs)],
        main_jobs.seeds.cpu().numpy().view(np.uint64), np.minimum(main_jobs.host_samples, 8),
    )
    short_kernel = gibbs_cuda.gibbs_read_counts(short, thin, gamma)
    not_prefix = [
        j for j, (f, s) in enumerate(zip(gibbs_job_slices(main_jobs, full),
                                         gibbs_job_slices(short, short_kernel)))
        if not np.array_equal(f[:len(s)], s)
    ]
    if not_prefix:
        raise AssertionError(f"{len(not_prefix)} main-path jobs: min(S, 8) samples are not the "
                             "prefix of the full run's")
    t0 = time.perf_counter()
    short_plain = gibbs_cuda.gibbs_read_counts_plain(short, thin, gamma)
    torch.cuda.synchronize()
    short_plain_s = time.perf_counter() - t0
    main_diverged, main_max_abs = compare_gibbs(short, short_kernel, short_plain)
    for j in main_diverged:
        check_diverged_job(f"main-path job {j}", *gibbs_job_item(main_jobs, j), device, thin, gamma)
    shapes = main_jobs.shapes
    work = main_jobs.host_samples * shapes[:, 0] * shapes[:, 1]
    slow = []
    for j in sorted(set(np.argsort(-work)[:3].tolist()) | set(np.argsort(-main_jobs.host_samples)[:1].tolist())):
        one = gibbs_cuda.make_jobs(
            main_jobs.tasks, [int(main_jobs.host_task_ids[j])],
            [fracs[offsets[j]:offsets[j + 1]]],
            [int(main_jobs.seeds[j].item()) & 0xFFFFFFFFFFFFFFFF], [int(main_jobs.host_samples[j])],
        )
        slow.append((cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(one, thin, gamma), reps=3), j, one))
    alone_ms, j, one = max(slow, key=lambda item: item[0])
    # Where an iteration of that job goes, and the floor its chain of
    # dependent iterations sets.
    iterations = int(main_jobs.host_samples[j]) * thin
    cycles, same = step_cycles(gibbs_cuda, lambda: gibbs_cuda.gibbs_read_counts(one, thin, gamma),
                               iterations)
    minimum_us = readcount_minimum_us(device)
    floor_ms = iterations * minimum_us / 1e3
    task = int(main_jobs.host_task_ids[j])
    r0, r1 = (int(main_jobs.tasks.row_offsets[task + i]) for i in (0, 1))
    row_counts = main_jobs.tasks.counts[r0:r1].cpu().numpy()
    (route,) = gibbs_cuda.plan_launches(one.shapes[:, 0], one.shapes[:, 1],
                                        gibbs_cuda.job_trials(one))
    log(
        f"phase 7: the -n 100 run's phase-D2 jobs ({main_jobs.n_jobs}, samples median "
        f"{int(np.median(main_jobs.host_samples))} max {int(main_jobs.host_samples.max())}, "
        f"thin {thin}): vs plain at min(S, 8) samples (the prefix of the full run, bitwise): "
        f"{main_jobs.n_jobs - len(main_diverged)} within rtol 1e-9 (max abs "
        f"{main_max_abs:.3e}), {len(main_diverged)} diverged (each within the distributional "
        f"bounds of the native sampler), plain {short_plain_s:.1f} s; re-timed: kernel "
        f"{main_ms:.3f} ms (CUDA events), bound {main_bound:.5f} ms ({main_by}); slowest job "
        f"{tuple(map(int, shapes[j]))} x {int(main_jobs.host_samples[j])} samples "
        f"({int(row_counts.sum())} reads, largest row {int(row_counts.max())}; "
        f"{route.ctas} CTA(s) of {route.threads} threads, staged {route.staged}) alone "
        f"{alone_ms:.3f} ms"
    )
    log(
        f"phase 7: that job's {iterations} iterations, cycles per iteration between the "
        f"kernel's marks (CDF build, trials, barrier 1 (the cluster's when split), Gamma "
        f"draws, barrier 2, output) {cycles} "
        f"(sum {sum(cycles)}; profiled build bitwise the port's: {same}); per-iteration minimum "
        f"(a 1 x 1 job) {minimum_us:.3f} us, so its dependent-chain floor is {iterations} x "
        f"{minimum_us:.3f} us = {floor_ms:.3f} ms beside the work bound {main_bound:.5f} ms"
    )
    return {
        "max_abs_err": max(max_abs, main_max_abs), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "diverged_jobs": len(diverged),
        "main_path_jobs": main_jobs.n_jobs, "main_path_diverged_jobs": len(main_diverged),
        "main_path_jobs_ms": main_ms, "main_path_jobs_bound_ms": main_bound,
        "main_path_slowest_job_ms": alone_ms,
        "main_path_slowest_job_cycles_per_iteration": cycles,
        "iteration_minimum_us": minimum_us, "main_path_slowest_job_floor_ms": floor_ms,
    }


def pair_posteriors(posteriors, jobs, samples):
    """Per cluster, sorted pair -> sample frequency, of sampled pairs."""
    host = jobs.host
    return [dict(zip(map(tuple, groups), freqs)) for groups, freqs in
            posteriors._dedup_pairs(samples, host["out_offsets"], host["n_chains"], host["n_its"])]


def diverged_clusters(jobs, kernel, plain):
    """Clusters whose sampled pairs are not all equal to the plain
    version's (host arrays)."""
    import numpy as np

    offsets = jobs.host["out_offsets"]
    return [b for b in range(jobs.n_clusters)
            if not np.array_equal(kernel[offsets[b]:offsets[b + 1]], plain[offsets[b]:offsets[b + 1]])]


def phase_posterior_kernel(torch, device, captured):
    """Phase 8: the posterior kernel against its plain version on 256
    seeded clusters of up to the main path's 120 paths and one of 200
    (its CDFs past shared memory), every pair equal or the cluster within
    total variation 0.05 of the native sampler; against the native
    sampler on the crossbackend fixture (total variation, top group);
    then on the clusters of phase 9's haplotypes --use-hap-gibbs run:
    against the plain version (every pair equal, or a cluster's posterior
    within total variation 0.05 of the plain version's) and re-timed."""
    import numpy as np

    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.ops import posterior_gibbs_cuda
    from rpvg_tpu_torch.testing import posterior_cluster_set, posterior_wide_cluster

    clusters = posterior_cluster_set(256, seed=71, max_paths=120) + [posterior_wide_cluster(200, 73)]
    keys = prng.split(prng.prng_key(72), len(clusters))
    jobs = posteriors.posterior_gibbs_jobs(clusters, keys, device)
    unstaged = sum(lc.tasks.size for lc in jobs.launches if not lc.staged)
    kernel = posterior_gibbs_cuda.posterior_gibbs(jobs).cpu().numpy()
    plain = posterior_gibbs_cuda.posterior_gibbs_plain(jobs).cpu().numpy()
    diverged = diverged_clusters(jobs, kernel, plain)
    if diverged:
        k_post = pair_posteriors(posteriors, jobs, kernel)
        native = posteriors._posterior_gibbs_native([clusters[b] for b in diverged],
                                                    [keys[b] for b in diverged])
        for b, (groups, freqs) in zip(diverged, native):
            tv = total_variation(k_post[b], dict(zip(map(tuple, groups), freqs)))
            if tv >= TV_MAX:
                raise AssertionError(f"diverged cluster {b}: total variation {tv:.3f} vs native")
    kernel_ms = cuda_ms(lambda: posterior_gibbs_cuda.posterior_gibbs(jobs), reps=10)
    plain_ms = cuda_ms(lambda: posterior_gibbs_cuda.posterior_gibbs_plain(jobs), reps=1, warmup=False)
    bound_ms, bound_by = posterior_bound(jobs)
    cols = jobs.host["n_cols"]
    log(
        f"phase 8: posterior Gibbs kernel vs plain on {len(clusters)} seeded clusters (P "
        f"{int(cols.min())}-{int(cols.max())}, {unstaged} with CDFs past shared memory, "
        f"{int(jobs.host['n_chains'].sum())} chains): {len(clusters) - len(diverged)} with every "
        f"pair equal, {len(diverged)} diverged (each within total variation {TV_MAX} of the "
        f"native sampler); kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events), "
        f"bound {bound_ms:.5f} ms ({bound_by})"
    )

    probs_full, counts = gibbs_fixture()
    cluster = (probs_full[:, :-1], probs_full[:, -1], counts, [1] * 6)
    key = prng.prng_key(33)
    (on_card,) = posteriors.path_group_posteriors_gibbs_batched([cluster], 2, [key], device)
    (native,) = posteriors._posterior_gibbs_native([cluster], [key])
    d_card = dict(zip(map(tuple, on_card[0]), on_card[1]))
    d_native = dict(zip(map(tuple, native[0]), native[1]))
    tv = total_variation(d_card, d_native)
    same_top = max(d_card, key=d_card.get) == max(d_native, key=d_native.get)
    log(f"phase 8: posterior Gibbs on cuda vs the native sampler, crossbackend fixture: "
        f"total variation {tv:.4f}, same top group {same_top}")
    if tv >= TV_MAX or not same_top:
        raise AssertionError("posterior Gibbs on cuda disagrees with the native sampler")

    if len(captured) != 1:
        raise AssertionError(f"phase B called the posterior kernel {len(captured)} times, not once")
    main = captured[0]
    main_kernel = posterior_gibbs_cuda.posterior_gibbs(main).cpu().numpy()
    t0 = time.perf_counter()
    main_plain = posterior_gibbs_cuda.posterior_gibbs_plain(main).cpu().numpy()
    main_plain_s = time.perf_counter() - t0
    main_diverged = diverged_clusters(main, main_kernel, main_plain)
    worst_tv = 0.0
    if main_diverged:
        # The scores alone were captured, not the native sampler's inputs:
        # a diverged cluster's posterior is held to the plain version's.
        k_post = pair_posteriors(posteriors, main, main_kernel)
        p_post = pair_posteriors(posteriors, main, main_plain)
        worst_tv = max(total_variation(k_post[b], p_post[b]) for b in main_diverged)
        if worst_tv >= TV_MAX:
            raise AssertionError(f"main-path clusters: total variation {worst_tv:.3f} vs plain")
    main_ms = cuda_ms(lambda: posterior_gibbs_cuda.posterior_gibbs(main), reps=5)
    main_bound, main_by = posterior_bound(main)
    h = main.host
    steps = h["n_burn"] + h["n_its"]
    slow = int(np.lexsort((h["n_cols"], steps))[-1])
    minimum_us = pair_step_minimum_us(device)
    floor_ms = int(steps[slow]) * minimum_us / 1e3
    launches = [
        f"{lc.tasks.size} clusters in {len(h['block_starts'][i]) - 1} blocks"
        + (f" staging up to {lc.smem_bytes} bytes ({posterior_gibbs_cuda.blocks_per_sm(lc.smem_bytes)} "
           f"blocks per SM)" if lc.staged else " with tables in the global scratch")
        for i, lc in enumerate(main.launches)
    ]
    log(
        f"phase 8: the --use-hap-gibbs run's clusters in {len(main.launches)} launch(es): "
        + "; ".join(launches)
        + f"; its slowest cluster (P {int(h['n_cols'][slow])}, {int(h['n_chains'][slow])} chains of "
        f"{int(h['n_burn'][slow])} + {int(h['n_its'][slow])} steps) has a dependent-chain floor of "
        f"{int(steps[slow])} x {minimum_us:.4f} us = {floor_ms:.5f} ms (a step with no work: a "
        f"one-path cluster's chain, 4,000 less 2,000 steps)"
    )
    log(
        f"phase 8: the --use-hap-gibbs run's {main.n_clusters} clusters (P median "
        f"{int(np.median(main.host['n_cols']))} max {int(main.host['n_cols'].max())}): vs plain "
        f"{main.n_clusters - len(main_diverged)} with every pair equal, {len(main_diverged)} "
        f"diverged (worst total variation vs plain {worst_tv:.4f}, allowed {TV_MAX}), plain "
        f"{main_plain_s:.2f} s; re-timed: kernel {main_ms:.3f} ms (CUDA events), bound "
        f"{main_bound:.5f} ms ({main_by})"
    )
    return {
        "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "diverged_clusters": len(diverged),
        "main_path_clusters": main.n_clusters, "main_path_diverged_clusters": len(main_diverged),
        "main_path_clusters_ms": main_ms, "main_path_clusters_bound_ms": main_bound,
        "step_minimum_us": minimum_us, "main_path_slowest_cluster_floor_ms": floor_ms,
    }


def compare_scores(kernel, plain):
    """(max abs diff, max rel diff, scores out of tolerance) between two
    host arrays of group scores: -inf where the other is -inf, the rest
    within rtol 1e-10 (only the order of the sums over rows differs)."""
    import numpy as np

    bad = int((np.isneginf(kernel) != np.isneginf(plain)).sum())
    bad += int((np.isnan(kernel) != np.isnan(plain)).sum())
    finite = np.isfinite(plain) & np.isfinite(kernel)
    diff = np.abs(kernel[finite] - plain[finite])
    bad += int((diff > 1e-10 * np.abs(plain[finite])).sum())
    rel = diff / np.maximum(np.abs(plain[finite]), 1e-300)
    return (float(diff.max()) if diff.size else 0.0, float(rel.max()) if rel.size else 0.0, bad)


def histogram_of_paths(cols):
    """Clusters by P, in bins 1, 2-8, 9-16, 17-32, 33-64, 65-128, 129+."""
    import numpy as np

    cols = np.asarray(cols)
    edges = [(1, 1), (2, 8), (9, 16), (17, 32), (33, 64), (65, 128), (129, None)]
    return {
        f"{lo}" if lo == hi else f"{lo}+" if hi is None else f"{lo}-{hi}":
        int(((cols >= lo) & (cols <= (hi or cols.max(initial=0)))).sum())
        for lo, hi in edges
    }


def phase_group_scores_kernel(torch, device, captured, over, per_log, table_per_log):
    """Phase 11: the group-score kernel against its plain version on 256
    seeded clusters per group size 1, 3, 4, 5 (P up to 32, 16 at k = 5;
    one of 512 rows x P_max; one with -inf groups), every score within
    rtol 1e-10 and -inf where plain is, bitwise the same on a second run;
    timed at k = 3 beside group_scores_bound for R x G logs (libdevice's
    log, ``per_log`` FP64 instructions) and for the logs the kernel
    computes (R x P + the rows U of every group, its own log,
    ``table_per_log``); then on the clusters phase 10's three enumeration
    runs handed it (their zero and U shares, the warps' busy lanes, both
    counts, the blocks per SM; the -y 4 run's at k = 4), and on the
    clusters the haplotypes -y 3 run handed the host engine, ``over``
    (held and timed likewise; their route is unchanged)."""
    import numpy as np

    from rpvg_tpu_torch.ops import group_scores_cuda
    from rpvg_tpu_torch.testing import enumeration_cluster_set

    def held(packed, label):
        kernel = group_scores_cuda.group_scores(packed)
        again = group_scores_cuda.group_scores(packed)
        torch.cuda.synchronize()
        if not torch.equal(kernel.view(torch.int64), again.view(torch.int64)):
            raise AssertionError(f"{label}: group-score kernel is not bitwise the same across runs")
        plain, plain_ms = timed_once(lambda: group_scores_cuda.group_scores_ragged_plain(packed))
        max_abs, max_rel, n_bad = compare_scores(kernel.cpu().numpy(), plain.cpu().numpy())
        if n_bad:
            raise AssertionError(f"{label}: group-score kernel disagrees with plain version")
        return max_abs, max_rel, plain_ms, int(np.isneginf(plain.cpu().numpy()).sum())

    def bounds(packed):
        dense, factored, busy, zeros = group_score_logs(packed)
        rg_ms, _ = group_scores_bound(packed, per_log)
        ms, by = group_scores_bound(packed, table_per_log, factored)
        return {"logs_rg": dense, "logs": factored, "lanes_busy": busy, "zero_share": zeros,
                "bound_rg_ms": rg_ms, "bound_ms": ms, "bound_by": by}

    worst = 0.0
    seeded = None
    for k in (1, 3, 4, 5):
        clusters = enumeration_cluster_set(256, seed=80 + k, group_size=k)
        packed = group_scores_cuda.make_clusters([c[:3] for c in clusters], k, device)
        max_abs, max_rel, plain_ms, neginf = held(packed, f"k = {k}")
        h = packed.host
        log(
            f"phase 11: group scores, k = {k}: {len(clusters)} seeded clusters (P "
            f"{int(h['n_cols'].min())}-{int(h['n_cols'].max())}, R max {int(h['n_rows'].max())}, "
            f"{int(h['out_offsets'][-1])} groups, {neginf} -inf), kernel vs plain max abs "
            f"{max_abs:.3e} max rel {max_rel:.3e}, every score within rtol 1e-10 and -inf where "
            f"plain is; bitwise the same on a second run"
        )
        worst = max(worst, max_abs)
        if k == 3:
            seeded, seeded_plain_ms = packed, plain_ms
    kernel_ms = cuda_ms(lambda: group_scores_cuda.group_scores(seeded), reps=10)
    seeded_bounds = bounds(seeded)
    blocks = group_scores_cuda.blocks_per_sm(3)
    log(
        f"phase 11: group scores at k = 3 on the seeded set: kernel {kernel_ms:.3f} ms, plain "
        f"{seeded_plain_ms:.3f} ms (CUDA events); bound {seeded_bounds['bound_ms']:.5f} ms "
        f"({seeded_bounds['bound_by']}; the {seeded_bounds['logs']} logs the kernel computes at "
        f"{table_per_log} FP64 instructions each), {seeded_bounds['bound_rg_ms']:.5f} ms for "
        f"R x G = {seeded_bounds['logs_rg']} logs at libdevice's {per_log}; {blocks} blocks of "
        f"{group_scores_cuda.WARPS_PER_BLOCK} warps per SM"
    )
    report = {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": seeded_plain_ms,
              "bound_ms": seeded_bounds["bound_ms"], "bound_by": seeded_bounds["bound_by"],
              "bound_rg_ms": seeded_bounds["bound_rg_ms"], "blocks_per_sm": blocks}
    sets = dict(captured)
    if len(over.get("haplotypes", [])) == 0:
        raise AssertionError("the haplotypes -y 3 run handed the host engine no cluster")
    for run, calls in sets.items():
        if len(calls) != 1:
            raise AssertionError(f"{run}: phase B called the group scorer {len(calls)} times")
    sets["over_limit"] = [group_scores_cuda.make_clusters(over["haplotypes"], 3, device)]
    for run, (packed,) in sets.items():
        max_abs, max_rel, plain_ms, _ = held(packed, run)
        run_ms = cuda_ms(lambda: group_scores_cuda.group_scores(packed), reps=5)
        b = bounds(packed)
        h = packed.host
        what = ("the clusters the haplotypes -y 3 run handed the host engine" if run == "over_limit"
                else f"the {run} run's clusters")
        log(
            f"phase 11: {what}: {packed.n_clusters} (P median {int(np.median(h['n_cols']))} max "
            f"{int(h['n_cols'].max())}, R max {int(h['n_rows'].max())}, "
            f"{int(h['out_offsets'][-1])} groups); {b['zero_share']:.4f} of the probabilities are "
            f"zero; the kernel computes {b['logs']} logs, {b['logs'] / b['logs_rg']:.4f} of R x G "
            f"= {b['logs_rg']}, its warps' lanes {b['lanes_busy']:.4f} busy; vs plain max abs "
            f"{max_abs:.3e} max rel {max_rel:.3e}, none out of rtol 1e-10 or -inf, bitwise the "
            f"same on a second run, plain {plain_ms:.1f} ms; kernel {run_ms:.3f} ms (CUDA "
            f"events), bound {b['bound_ms']:.5f} ms ({b['bound_by']}; R x G at libdevice's log "
            f"{b['bound_rg_ms']:.5f} ms)"
        )
        report["max_abs_err"] = max(report["max_abs_err"], max_abs)
        report[f"{run}_clusters"] = packed.n_clusters
        report[f"{run}_ms"] = run_ms
        report[f"{run}_plain_ms"] = plain_ms
        for key in ("bound_ms", "bound_rg_ms", "logs", "logs_rg", "lanes_busy", "zero_share"):
            report[f"{run}_{key}"] = b[key]
    return report


def k_slot_posteriors(posteriors, jobs, samples):
    """Per cluster, sorted group -> sample frequency, of k-slot samples."""
    return [dict(zip(map(tuple, groups), freqs)) for groups, freqs in
            posteriors._group_sample_posteriors(samples, jobs.host, jobs.group_size)]


def held_to_plain(posteriors, jobs, kernel, plain):
    """(diverged clusters, worst total variation among them, largest
    difference of one group's posterior) of a k-slot kernel run against
    the plain version; raises when a diverged cluster's total variation
    reaches TV_MAX."""
    diverged = diverged_clusters(jobs, kernel, plain)
    k_post = k_slot_posteriors(posteriors, jobs, kernel)
    p_post = k_slot_posteriors(posteriors, jobs, plain)
    worst_tv = max((total_variation(k_post[b], p_post[b]) for b in diverged), default=0.0)
    if worst_tv >= TV_MAX:
        raise AssertionError(f"k-slot kernel: a diverged cluster at total variation {worst_tv:.3f}")
    max_abs = max(
        (abs(a.get(g, 0.0) - z.get(g, 0.0)) for a, z in zip(k_post, p_post) for g in set(a) | set(z)),
        default=0.0,
    )
    return diverged, worst_tv, max_abs


def phase_posterior_k_kernel(torch, device, captured, per_log):
    """Phase 12: the k-slot posterior sampler against its plain version
    on seeded clusters of 1-120 paths and one of 200 paths x 150 rows
    (past shared memory), 64 of them at k = 3 and the first 16 at k = 1
    and 4 (the plain version steps every chain k x (burn + its) times):
    every sampled group equal, or
    the cluster's posterior within total variation 0.05 of the plain
    version's (the diverged clusters counted); timed at k = 3 beside its
    bound; then on the clusters of phase 10's haplotypes -y 3
    --use-hap-gibbs run, likewise, and re-timed."""
    import numpy as np

    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.ops import posterior_gibbs_k_cuda
    from rpvg_tpu_torch.testing import posterior_cluster_set, posterior_wide_cluster

    wide = posterior_wide_cluster(200, 93, n_rows=150)
    seeded_set = posterior_cluster_set(64, seed=91, max_paths=120)
    report = {"max_abs_err": 0.0}
    seeded = None
    for k in (1, 3, 4):
        clusters = (seeded_set if k == 3 else seeded_set[:16]) + [wide]
        keys = prng.split(prng.prng_key(94 + k), len(clusters))
        jobs = posteriors.posterior_gibbs_k_jobs(clusters, k, keys, device)
        kernel = posterior_gibbs_k_cuda.posterior_gibbs_k(jobs)
        again = posterior_gibbs_k_cuda.posterior_gibbs_k(jobs)
        torch.cuda.synchronize()
        if not torch.equal(kernel, again):
            raise AssertionError("k-slot kernel is not deterministic across runs")
        plain, plain_ms = timed_once(lambda: posterior_gibbs_k_cuda.posterior_gibbs_k_plain(jobs))
        diverged, worst_tv, max_abs = held_to_plain(
            posteriors, jobs, kernel.cpu().numpy(), plain.cpu().numpy()
        )
        unstaged, clustered = k_slot_routes(jobs)
        log(
            f"phase 12: k-slot sampler, k = {k}: {len(clusters)} seeded clusters ({unstaged} past "
            f"shared memory, {clustered} on a cluster of CTAs, "
            f"{int(jobs.host['n_chains'].sum())} chains in {len(jobs.launches)} launches): "
            f"{len(clusters) - len(diverged)} with every group equal to plain, {len(diverged)} "
            f"diverged (worst total variation {worst_tv:.4f}, allowed {TV_MAX}); largest "
            f"posterior difference {max_abs:.4f}"
        )
        report["max_abs_err"] = max(report["max_abs_err"], max_abs)
        report[f"diverged_clusters_k{k}"] = len(diverged)
        if k == 3:
            seeded, seeded_plain_ms = jobs, plain_ms
    kernel_ms = cuda_ms(lambda: posterior_gibbs_k_cuda.posterior_gibbs_k(seeded), reps=5)
    plain_ms = seeded_plain_ms
    bound_ms, bound_by = posterior_bound(seeded, per_log)
    log(
        f"phase 12: k-slot sampler at k = 3 on the {seeded.n_clusters} seeded clusters: kernel "
        f"{kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (CUDA events), bound {bound_ms:.5f} ms ({bound_by})"
    )
    report.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    if len(captured) != 1:
        raise AssertionError(f"phase B called the k-slot sampler {len(captured)} times, not once")
    (main,) = captured
    kernel = posterior_gibbs_k_cuda.posterior_gibbs_k(main).cpu().numpy()
    main_ms = cuda_ms(lambda: posterior_gibbs_k_cuda.posterior_gibbs_k(main), reps=3)
    t0 = time.perf_counter()
    plain = posterior_gibbs_k_cuda.posterior_gibbs_k_plain(main).cpu().numpy()
    plain_s = time.perf_counter() - t0
    diverged, worst_tv, max_abs = held_to_plain(posteriors, main, kernel, plain)
    main_bound, main_by = posterior_bound(main, per_log)
    unstaged, clustered = k_slot_routes(main)
    tool = profile_tool()
    zero_share, tile_share, _, _ = tool.sparsity([item[0] for item in tool.cluster_inputs(main)])
    logs, dense_logs = k_slot_logs(main), k_slot_logs(main, dense=True)
    log(
        f"phase 12: the run's clusters: {zero_share:.4f} of the probabilities are zero, "
        f"{tile_share:.4f} of the (32-path, row) tiles hold a nonzero; the bound counts "
        f"{logs:.4g} FP64 logs (R + nonzeros per slot step) where a log per entry would be "
        f"{dense_logs:.4g} (R x P, {main_bound * dense_logs / logs:.5f} ms); {unstaged} "
        f"clusters past shared memory, {clustered} on a cluster of CTAs"
    )
    chain = slowest_chain(main, device)
    main_floor_ms = chain["slot_steps"] * chain["minimum_us"] / 1e3
    log(
        f"phase 12: the slowest chain (cluster {chain['cluster']}: {chain['shape'][0]} x "
        f"{chain['shape'][1]}, {chain['nonzeros']} nonzeros, {chain['slot_steps']} slot steps on "
        f"{chain['threads']} threads x {chain['ctas']} CTA(s)) alone {chain['ms']:.3f} ms; cycles "
        f"per slot step between the kernel's marks (step 1, barrier, step 2, cluster barrier, "
        f"draw, barrier) {chain['cycles']} (sum {sum(chain['cycles'])}; profiled build bitwise "
        f"the port's: {chain['same']}); slot-step minimum (a 1 x 1 cluster) "
        f"{chain['minimum_us']:.3f} us, so its dependent-chain floor is {chain['slot_steps']} x "
        f"{chain['minimum_us']:.3f} us = {main_floor_ms:.3f} ms beside the work bound "
        f"{main_bound:.5f} ms"
    )
    log(
        f"phase 12: the haplotypes -y 3 --use-hap-gibbs run's {main.n_clusters} clusters (P median "
        f"{int(np.median(main.host['n_cols']))} max {int(main.host['n_cols'].max())}, "
        f"{int(main.host['n_chains'].sum())} chains): {main.n_clusters - len(diverged)} with every "
        f"group equal to plain, {len(diverged)} diverged (worst total variation {worst_tv:.4f}, "
        f"allowed {TV_MAX}), plain {plain_s:.2f} s; re-timed: kernel {main_ms:.3f} ms (CUDA "
        f"events), bound {main_bound:.5f} ms ({main_by})"
    )
    report.update(
        max_abs_err=max(report["max_abs_err"], max_abs), main_path_clusters=main.n_clusters,
        main_path_diverged_clusters=len(diverged), main_path_clusters_ms=main_ms,
        main_path_clusters_bound_ms=main_bound, main_path_zero_share=zero_share,
        main_path_tile_share=tile_share, main_path_logs=logs, main_path_logs_per_entry=dense_logs,
        main_path_slowest_chain_ms=chain["ms"], main_path_slowest_chain_shape=chain["shape"],
        main_path_slowest_chain_cycles_per_slot_step=chain["cycles"],
        slot_step_minimum_us=chain["minimum_us"], main_path_slowest_chain_floor_ms=main_floor_ms,
    )
    return report


def k_slot_routes(jobs):
    """(clusters past shared memory, clusters whose chains run on a
    thread-block cluster of several CTAs) of KSlotJobs."""
    import numpy as np

    cluster_of = jobs.chain_cluster.cpu().numpy()
    unstaged = {int(c) for lc in jobs.launches if not lc.staged for c in cluster_of[lc.tasks]}
    return len(unstaged), int(np.count_nonzero(jobs.host["n_ctas"] > 1))


def slowest_chain(jobs, device):
    """The chain that sets a k-slot call's critical path: of the cluster
    with the most logs per chain (slot steps x (R + nonzeros)), one chain
    alone, timed, and its cycles per slot step between the kernel's
    marks; with the slot-step minimum."""
    import numpy as np

    from rpvg_tpu_torch.ops import posterior_gibbs_k_cuda

    h = jobs.host
    k = jobs.group_size
    steps = h["n_burn"] + h["n_its"]
    b = int(np.argmax(steps * (h["n_rows"] + h["n_nonzeros"])))
    (item,) = profile_tool().cluster_inputs(jobs)[b:b + 1]
    seed = int(jobs.seeds[b].item()) & 0xFFFFFFFFFFFFFFFF
    one = posterior_gibbs_k_cuda.make_jobs(
        [item], k, [(1, int(h["n_burn"][b]), int(h["n_its"][b]))], [seed], device
    )
    sample = posterior_gibbs_k_cuda.posterior_gibbs_k
    slot_steps = k * int(steps[b])
    cycles, same = step_cycles(posterior_gibbs_k_cuda, lambda: sample(one), slot_steps)
    (launch,) = one.launches
    return {
        "cluster": b, "shape": [int(h["n_rows"][b]), int(h["n_cols"][b])],
        "nonzeros": int(h["n_nonzeros"][b]), "slot_steps": slot_steps,
        "threads": launch.threads, "ctas": launch.ctas,
        "ms": cuda_ms(lambda: sample(one), reps=3), "cycles": cycles, "same": same,
        "minimum_us": k_slot_minimum_us(device, k),
    }


GIBBS_CONFIGS = (
    # (label, model, -f, extra flags, -n)
    ("transcripts -n 8", "transcripts", False, ("-n", "8"), True),
    ("transcripts -f -n 8", "transcripts", True, ("-n", "8"), True),
    ("strains -n 8", "strains", False, ("-n", "8"), True),
    ("haplotype-transcripts -n 8", "haplotype-transcripts", True, ("-n", "8"), True),
    ("haplotypes --use-hap-gibbs", "haplotypes", False, ("--use-hap-gibbs",), False),
    ("haplotype-transcripts --use-hap-gibbs", "haplotype-transcripts", True,
     ("--use-hap-gibbs",), False),
    ("haplotype-transcripts -n 8 --use-hap-gibbs", "haplotype-transcripts", True,
     ("-n", "8", "--use-hap-gibbs"), True),
    ("haplotypes -y 3 --use-hap-gibbs", "haplotypes", False, ("-y", "3", "--use-hap-gibbs"),
     False),
    ("haplotype-transcripts -y 3 --use-hap-gibbs", "haplotype-transcripts", True,
     ("-y", "3", "--use-hap-gibbs"), False),
    ("haplotype-transcripts --ind-hap-inference -n 8", "haplotype-transcripts", True,
     ("--ind-hap-inference", "-n", "8"), True),
    ("haplotype-transcripts --ind-hap-inference --use-hap-gibbs", "haplotype-transcripts", True,
     ("--ind-hap-inference", "--use-hap-gibbs"), False),
)


def cluster_posteriors(stats):
    """Per non-empty cluster, group set -> posterior, from a run's results."""
    out = []
    for result in stats["results"]:
        est = result.estimates
        if est.path_group_sets:
            out.append({tuple(g): p for g, p in zip(est.path_group_sets, est.posteriors)})
        else:
            out.append(None)
    return out


def phase_gibbs_cli(cli, compare, small, work, threads):
    """Phase 3, Gibbs runs: the CPU tests' seven configurations and
    --use-hap-gibbs at -y 3 for both haplotype models, with --backend
    cuda and cpu at 5k pairs.  -n runs: .txt within rtol 1e-6
    (Gibbs does not touch point estimates) and _gibbs.txt.gz rows within
    6 se.  --use-hap-gibbs runs: per cluster total variation between the
    devices, against the same between two CPU seeds."""
    import numpy as np

    for label, model, info, extra, n_run in GIBBS_CONFIGS:
        stats = {}
        for backend in ("cuda", "cpu"):
            prefix = os.path.join(work, f"gibbs_{label.replace(' ', '_')}_{backend}")
            rc, stats[backend] = cli.run_cli(cli_argv(small, prefix, backend, threads, model, info)
                                             + list(extra))
            if rc != 0:
                raise RuntimeError(f"{label} --backend {backend} exited {rc}")
        prefix = lambda b: os.path.join(work, f"gibbs_{label.replace(' ', '_')}_{b}")  # noqa: E731
        parts = []
        hap_gibbs = "--use-hap-gibbs" in extra
        if not hap_gibbs:
            for suffix in output_suffixes(model):
                rep = compare.compare_estimate_files(prefix("cuda") + suffix, prefix("cpu") + suffix,
                                                     RTOL, ATOL_OUT)
                parts.append(f"{suffix} {rep['rows']} rows within rtol {RTOL}")
        if n_run and not hap_gibbs:
            rep = hold_gibbs_rows(compare, prefix("cuda") + "_gibbs.txt.gz",
                                  prefix("cpu") + "_gibbs.txt.gz")
            parts.append(gibbs_rows_text(rep))
            if not rep["ok"]:
                log(f"phase 3: {label}: " + "; ".join(parts))
                raise AssertionError(f"{label}: Gibbs samples differ across devices")
        elif n_run:
            rep = compare.compare_gibbs_files(prefix("cuda") + "_gibbs.txt.gz",
                                              prefix("cpu") + "_gibbs.txt.gz", N_SE,
                                              same_rows=False)
            allowed = gibbs_rows_allowed(rep["rows"])
            parts.append(
                f"_gibbs.txt.gz {rep['rows']} common rows, "
                f"{rep['outside']} outside {N_SE:.0f} se (allowed {allowed}), worst "
                f"{rep['max_se']:.2f} se"
            )
            if rep["outside"] > allowed:
                log(f"phase 3: {label}: " + "; ".join(parts))
                raise AssertionError(f"{label}: Gibbs sample means differ across devices")
        if hap_gibbs:
            seed_argv = cli_argv(small, os.path.join(work, "gibbs_seed43"), "cpu", threads, model, info)
            seed_argv[seed_argv.index("-r") + 1] = "43"
            rc, other = cli.run_cli(seed_argv + list(extra))
            if rc != 0:
                raise RuntimeError(f"{label} -r 43 exited {rc}")
            pairs = [
                (a, b, c) for a, b, c in zip(cluster_posteriors(stats["cuda"]),
                                             cluster_posteriors(stats["cpu"]),
                                             cluster_posteriors(other))
                if a is not None and b is not None and c is not None
            ]
            tv_dev = np.array([total_variation(a, b) for a, b, _ in pairs])
            tv_seed = np.array([total_variation(b, c) for _, b, c in pairs])
            # Paired over clusters: how much further cuda's posteriors sit
            # from cpu's than a second cpu seed's do.
            excess = tv_dev - tv_seed
            excess_se = float(excess.std(ddof=1) / np.sqrt(excess.size)) if excess.size > 1 else 0.0
            parts.append(
                f"{len(pairs)} clusters: total variation cuda vs cpu mean {tv_dev.mean():.4f} "
                f"({float((tv_dev < TV_MAX).mean()):.3f} of clusters < {TV_MAX}); cpu -r 42 vs "
                f"-r 43 mean {tv_seed.mean():.4f} ({float((tv_seed < TV_MAX).mean()):.3f} < "
                f"{TV_MAX}); excess {excess.mean():.4f} +- {excess_se:.4f} (allowed "
                f"{TV_EXCESS} + 3 se)"
            )
            if excess.mean() > TV_EXCESS + 3 * excess_se:
                log(f"phase 3: {label}: " + "; ".join(parts))
                raise AssertionError(f"{label}: posteriors differ across devices beyond seed noise")
        log(f"phase 3: {label}, 5000 pairs, --backend cuda vs cpu: " + "; ".join(parts))


CLI_CONFIGS = (
    # (label, model, dataset, extra flags, quality-scored)
    ("haplotype-transcripts", "haplotype-transcripts", "small", (), False),
    ("transcripts", "transcripts", "small", (), False),
    ("strains", "strains", "small", (), False),
    ("haplotypes", "haplotypes", "small", (), False),
    ("haplotypes -y 3", "haplotypes", "small", ("-y", "3"), False),
    ("haplotype-transcripts -y 3", "haplotype-transcripts", "small", ("-y", "3"), False),
    # At 7 isoforms, 7 clusters of up to 80 paths pass the enumeration
    # limit at k = 4 and take minutes on the host engine; at 3 none does.
    ("haplotypes -y 4", "haplotypes", "three_isoforms", ("-y", "4"), False),
    ("haplotype-transcripts -y 4", "haplotype-transcripts", "small", ("-y", "4"), False),
    ("haplotype-transcripts --ind-hap-inference", "haplotype-transcripts", "small",
     ("--ind-hap-inference",), False),
    ("haplotype-transcripts --ind-hap-inference -y 3", "haplotype-transcripts", "small",
     ("--ind-hap-inference", "-y", "3"), False),
    ("haplotype-transcripts --multiprocess 2", "haplotype-transcripts", "small",
     ("--multiprocess", "2"), False),
    ("haplotype-transcripts -b", "haplotype-transcripts", "small", ("-b",), False),
    ("transcripts -b", "transcripts", "small", ("-b",), False),
    ("haplotype-transcripts, quality-scored", "haplotype-transcripts", "qual", (), True),
    ("transcripts, quality-scored", "transcripts", "qual", (), True),
    ("haplotype-transcripts --single-end", "haplotype-transcripts", "single_end",
     ("--single-end", "-m", "250", "-d", "25"), False),
    ("transcripts --single-end", "transcripts", "single_end",
     ("--single-end", "-m", "250", "-d", "25"), False),
    ("haplotype-transcripts --long-reads", "haplotype-transcripts", "long_reads",
     ("--long-reads",), False),
    ("transcripts --long-reads", "transcripts", "long_reads", ("--long-reads",), False),
)


def phase_cli_configs(cli, compare_estimate_files, datasets, work, threads):
    """Phase 3, point estimates: each configuration of CLI_CONFIGS with
    --backend cuda and cpu on its 5k-read dataset: identical rows,
    numbers within rtol 1e-6 / atol 1e-6; with -b the _probs.txt.gz of
    both devices identical (host code)."""
    import gzip

    for label, model, dataset, extra, qual in CLI_CONFIGS:
        info = model == "haplotype-transcripts"
        name = "small_" + "".join(c if c.isalnum() else "_" for c in label)
        for backend in ("cuda", "cpu"):
            prefix = os.path.join(work, f"{name}_{backend}")
            argv = cli_argv(datasets[dataset], prefix, backend, threads, model, info, qual)
            if cli.main(argv + list(extra)) != 0:
                raise RuntimeError(f"{label} CLI --backend {backend} exited non-zero")
        reports = []
        for suffix in output_suffixes(model):
            rep = compare_estimate_files(
                os.path.join(work, f"{name}_cuda{suffix}"),
                os.path.join(work, f"{name}_cpu{suffix}"), RTOL, ATOL_OUT,
            )
            reports.append(f"{suffix} {rep['rows']} rows, max abs {rep['max_abs_diff']:.3e}, "
                           f"max rel {rep['max_rel_diff']:.3e}, byte-identical "
                           f"{rep['byte_identical']}")
        if "-b" in extra:
            probs = []
            for backend in ("cuda", "cpu"):
                with gzip.open(os.path.join(work, f"{name}_{backend}_probs.txt.gz"), "rb") as handle:
                    probs.append(handle.read())
            if probs[0] != probs[1] or not probs[0]:
                raise AssertionError(f"{label}: _probs.txt.gz differs across devices")
            reports.append(f"_probs.txt.gz {probs[0].count(b'#')} blocks, byte-identical")
        reads = {"long_reads": "2000 reads", "single_end": "5000 reads",
                 "three_isoforms": "5000 pairs, 3 isoforms per gene"}.get(dataset, "5000 pairs")
        log(f"phase 3: {label}, {reads}, "
            f"--backend cuda vs cpu: rows identical; " + "; ".join(reports))


def write_dataset(sim, rpa, alignments, out_dir, num_genes, num_pairs, seed_panel, seed_reads,
                  with_errors=False, tag="", isoforms=7):
    """Gene panel (graph/panel JSON, info TSV; ``isoforms`` per gene) and
    paired multipath reads as a binary .rpa stream, made from seeds;
    ``with_errors`` gives the reads sequencing errors and base qualities
    (for quality-scored runs).  File names carry ``tag``."""
    panel = sim.build_gene_panel(
        num_genes=num_genes, isoforms_per_gene=isoforms, num_haplotypes=4,
        exons_per_gene=10, exon_length=120, variant_sites=3, seed=seed_panel,
    )
    records, _ = sim.simulate_read_pairs(
        panel, num_pairs, read_length=100, frag_mean=250, frag_sd=25, seed=seed_reads,
        abundances=sim.gene_abundances(panel, seed=7), with_errors=with_errors,
        multipath_dag=True,
    )
    parsed = [alignments.parse_multipath_alignment(r) for r in records]
    paths = {name: os.path.join(out_dir, tag + name) for name in
             ("graph.json", "panel.json", "info.tsv", "aln.rpa")}
    rpa.write_fragments(
        paths["aln.rpa"], list(zip(parsed[0::2], parsed[1::2])),
        is_multipath=True, is_paired=True, frag_mean=250.0, frag_sd=25.0,
    )
    panel.write_graph_json(paths["graph.json"])
    panel.write_panel_json(paths["panel.json"])
    panel.write_info_tsv(paths["info.tsv"])
    return paths


def write_single_end_dataset(sim, out_dir, num_genes, num_reads, seed_panel, seed_reads,
                             read_length=100, tag="se_"):
    """write_dataset's gene panel with single-end multipath reads (JSON
    lines) of ``read_length``, for --single-end and --long-reads runs;
    file names carry ``tag``."""
    panel = sim.build_gene_panel(
        num_genes=num_genes, isoforms_per_gene=7, num_haplotypes=4,
        exons_per_gene=10, exon_length=120, variant_sites=3, seed=seed_panel,
    )
    records, _ = sim.simulate_single_reads(
        panel, num_reads, read_length=read_length, abundances=sim.gene_abundances(panel, seed=7),
        seed=seed_reads,
    )
    paths = {name: os.path.join(out_dir, tag + name) for name in
             ("graph.json", "panel.json", "info.tsv")}
    # Under cli_argv's key for the alignments; the file is JSON lines.
    paths["aln.rpa"] = os.path.join(out_dir, tag + "aln.json")
    sim.write_alignment_json(records, paths["aln.rpa"])
    panel.write_graph_json(paths["graph.json"])
    panel.write_panel_json(paths["panel.json"])
    panel.write_info_tsv(paths["info.tsv"])
    return paths


def cli_argv(paths, prefix, backend, threads, model="haplotype-transcripts", info=True,
             qual=False):
    argv = [
        "-g", paths["graph.json"], "-p", paths["panel.json"], "-a", paths["aln.rpa"],
        "-o", prefix, "-i", model,
        "--backend", backend, "-t", str(threads), "-r", "42",
    ] + ([] if qual else ["--score-not-qual"])
    return argv + (["-f", paths["info.tsv"]] if info else [])


def output_suffixes(model):
    return (".txt", "_joint.txt") if model == "haplotype-transcripts" else (".txt",)


def read_counters():
    """The last finished run's counters; one it never added to reads 0."""
    from rpvg_tpu_torch import spans

    return collections.Counter(spans.recent_runs(1)[0]["counters"])


def check_routes(model, fused, stats, counts, hap_gibbs=False, ploidy=2):
    """The run's device work went through the kernels and the cuda
    scorers: every EM task in the route's kernel, none in the other; every
    Gibbs job and (with --use-hap-gibbs) every cluster of phase B (with
    --ind-hap-inference every (cluster, transcript group) job of phase
    I2, which the run counts as its scored clusters) in its
    sampler kernel (the pair-score sampler at ploidy 2, the k-slot sampler
    otherwise); without it at ploidy != 2 every cluster of phase B in the
    group-score kernel but those over the enumeration limit, which the
    host engine takes."""
    em_tasks = stats.get("em_tasks", 0)
    if fused:
        ok = (
            counts["em.padded.tasks"] == em_tasks and counts["em.ragged.launches"] == 0
            and counts["em.padded.launches"] >= 1 and counts["em.padded.blocks"] >= 1
        )
    else:
        ok = counts["em.padded.launches"] == 0 and counts["em.ragged.tasks"] == em_tasks and (
            counts["em.ragged.launches"] >= 1 or em_tasks == 0
        )
    scored = stats.get("scored_clusters", 0)
    host = counts["groups.host_enum_clusters"]
    enumeration = not hap_gibbs and ploidy != 2
    if model in ("haplotypes", "haplotype-transcripts"):
        on_card = 0 if hap_gibbs and ploidy != 2 else scored - host
        ok = ok and counts["posteriors.scored.cuda"] == on_card
        ok = ok and counts["posteriors.scored.cpu"] == host and (host == 0 or enumeration)
    gibbs_jobs = stats.get("gibbs_jobs", 0)
    ok = ok and counts["gibbs.readcount.jobs"] == gibbs_jobs and (
        counts["gibbs.readcount.launches"] >= 1) == (gibbs_jobs > 0)
    for kernel, covered, clusters in (
        ("gibbs.pair", "clusters", scored if hap_gibbs and ploidy == 2 else 0),
        ("gibbs.kslot", "clusters", scored if hap_gibbs and ploidy != 2 else 0),
        ("groups", "kernel_clusters", scored - host if enumeration else 0),
    ):
        ok = ok and counts[f"{kernel}.{covered}"] == clusters and (
            counts[f"{kernel}.launches"] >= 1) == (clusters > 0)
    if not ok:
        raise AssertionError(f"{model}: device work not all through the kernels: {counts}")


def gibbs_writer_seconds(stats):
    """The _gibbs.txt.gz writer's share of a run's wall, as text."""
    return (f"{stats['gibbs_writer_seconds']:.3f}s on the main thread (rows collected and "
            f"formatted) + {stats['gibbs_writer_join_seconds']:.3f}s waiting for its gzip "
            f"thread after the outputs")


def bench_run(torch, device, cli, check_estimate_file, phase, paths, prefix, threads,
              model, info, fused=False, extra=()):
    """One CLI run at full width with the run's counters read just after;
    returns (stats, counters) after printing a line."""
    torch.cuda.reset_peak_memory_stats(device)
    if fused:
        os.environ["RPVG_TPU_FUSE_EM"] = "1"
    t0 = time.perf_counter()
    try:
        rc, stats = cli.run_cli(cli_argv(paths, prefix, "cuda", threads, model, info) + list(extra))
    finally:
        os.environ.pop("RPVG_TPU_FUSE_EM", None)
    wall = time.perf_counter() - t0
    counts = read_counters()
    if rc != 0:
        raise RuntimeError(f"bench-scale {model} run exited {rc}")
    rows = [check_estimate_file(prefix + s) for s in output_suffixes(model)]
    ploidy = int(extra[list(extra).index("-y") + 1]) if "-y" in extra else 2
    check_routes(model, fused, stats, counts, hap_gibbs="--use-hap-gibbs" in extra,
                 ploidy=ploidy)
    gibbs = ""
    if "-n" in extra:
        from rpvg_tpu_torch.compare import read_gibbs_file

        header, gibbs_rows = read_gibbs_file(prefix + "_gibbs.txt.gz")
        if not gibbs_rows or not all(all(map(math.isfinite, v)) for v in gibbs_rows.values()):
            raise AssertionError(f"{model}: _gibbs.txt.gz has no rows or non-finite samples")
        gibbs = (f", {stats['gibbs_jobs']} Gibbs jobs through the read-count kernel in "
                 f"{counts['gibbs.readcount.launches']} launch(es), _gibbs.txt.gz {len(gibbs_rows)} rows x "
                 f"{len(header) - 2} samples, all finite, its writer "
                 f"{gibbs_writer_seconds(stats)}")
    if "--use-hap-gibbs" in extra and ploidy == 2:
        gibbs += (f", {counts['gibbs.pair.clusters']} clusters through the posterior kernel in "
                  f"{counts['gibbs.pair.launches']} launch(es)")
    elif "--use-hap-gibbs" in extra:
        gibbs += (f", {counts['gibbs.kslot.clusters']} clusters through the k-slot kernel in "
                  f"{counts['gibbs.kslot.launches']} launch(es)")
    elif ploidy != 2:
        gibbs += (f", {counts['groups.kernel_clusters']} clusters through the group-score kernel in "
                  f"{counts['groups.launches']} launch(es), {counts['groups.host_enum_clusters']} on the "
                  f"host engine in {stats['spans']['rpvg.groups.host_enum']['total_s']:.2f}s")
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in stats["phase_seconds"].items())
    route = "multi-bucket kernel" if fused else "ragged kernel"
    em = (
        f"{stats['em_tasks']} EM tasks all through the {route} in "
        f"{counts['em.padded.launches'] if fused else counts['em.ragged.launches']} launch(es)"
        + (f" of {counts['em.padded.blocks']} blocks" if fused else "")
        if "em_tasks" in stats else "no EM"
    )
    scored = f", {stats['scored_clusters']} clusters scored on cuda" if "scored_clusters" in stats else ""
    log(
        f"phase {phase}: {model}{' -f' if info else ''}{' ' + ' '.join(extra) if extra else ''}"
        f"{' RPVG_TPU_FUSE_EM=1' if fused else ''}: {PAIRS} pairs "
        f"on cuda in {wall:.2f}s wall = {PAIRS / wall:.1f} read pairs/s; fragment pass "
        f"{stats['fragment_pass_seconds']:.2f}s, matrices {stats['matrix_seconds']:.2f}s, "
        f"phases {phases}, outputs {stats['output_seconds']:.2f}s; "
        f"{stats['num_clusters']} clusters{scored}, {em}{gibbs}; output rows "
        f"{' + '.join(map(str, rows))}, all finite; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB"
    )
    return stats, counts


PLOIDY_RUNS = (
    # (key, model, -f, extra flags)
    ("haplotypes", "haplotypes", False, ("-y", "3")),
    ("haplotype-transcripts", "haplotype-transcripts", True, ("-y", "3")),
    ("hap-gibbs", "haplotypes", False, ("-y", "3", "--use-hap-gibbs")),
    # haplotypes -y 4 stays out: its clusters of up to 120 paths pass the
    # enumeration limit and run on the Python host engine.
    ("haplotype-transcripts-y4", "haplotype-transcripts", True, ("-y", "4")),
)


def phase_full_width_ploidy(torch, device, cli, check_estimate_file, bench, work, threads):
    """Phase 10: haplotypes -y 3, haplotype-transcripts -f -y 3,
    haplotypes -y 3 --use-hap-gibbs and haplotype-transcripts -f -y 4 on
    phase 4's dataset, each with the run's counters read just after;
    what each run handed the group-score kernel and the k-slot sampler
    is captured (the script
    wraps both entries), and so are the P of phase B's clusters.  Prints
    per run the phase-4 line, then phase B's engine, the histogram of P
    and the clusters the host enumeration engine took, with its seconds.
    Returns (scores captured by run, the host engine's clusters captured
    by run, k-slot jobs captured, launches of each kernel in its main-path
    run)."""
    from rpvg_tpu_torch.infer import batched_models, posteriors
    from rpvg_tpu_torch.ops import group_scores_cuda, posterior_gibbs_k_cuda

    score, sample = group_scores_cuda.group_scores, posterior_gibbs_k_cuda.posterior_gibbs_k
    full, gibbs = batched_models.full_posteriors_batched, batched_models.path_group_posteriors_gibbs_batched
    host_engine = posteriors.path_group_posteriors_full
    current = [None]
    scores, jobs, paths, engine_inputs = {}, {}, {}, {}

    def capture_over(probs, noise, counts, path_counts, group_size):
        engine_inputs.setdefault(current[0], []).append((probs, noise, counts))
        return host_engine(probs, noise, counts, path_counts, group_size)

    def capture_scores(clusters):
        scores.setdefault(current[0], []).append(clusters)
        return score(clusters)

    def capture_jobs(k_jobs):
        jobs.setdefault(current[0], []).append(k_jobs)
        return sample(k_jobs)

    def record_full(inputs, group_size, device):
        paths[current[0]] = [item[0].shape[1] for item in inputs]
        return full(inputs, group_size, device)

    def record_gibbs(inputs, group_size, keys, device):
        paths[current[0]] = [item[0].shape[1] for item in inputs]
        return gibbs(inputs, group_size, keys, device)

    launches = {}
    group_scores_cuda.group_scores, posterior_gibbs_k_cuda.posterior_gibbs_k = capture_scores, capture_jobs
    batched_models.full_posteriors_batched = record_full
    batched_models.path_group_posteriors_gibbs_batched = record_gibbs
    posteriors.path_group_posteriors_full = capture_over
    try:
        for key, model, info, extra in PLOIDY_RUNS:
            current[0] = key
            stats, counts = bench_run(torch, device, cli, check_estimate_file, 10, bench,
                                      os.path.join(work, f"ploidy_{key}"), threads, model, info,
                                      extra=extra)
            launches[key] = counts
            ploidy = int(extra[1])
            limit = posteriors._FULL_ENUM_GROUP_LIMIT
            over = sorted(
                P for P in paths[key]
                if math.comb(posteriors._ceil_pow2(P) + ploidy - 1, ploidy) > limit
            ) if "--use-hap-gibbs" not in extra else []
            log(
                f"phase 10: {model}{' -f' if info else ''} {' '.join(extra)}: phase B "
                f"({stats['group_engine']}) {stats['phase_seconds']['B']:.3f}s; P of its "
                f"{len(paths[key])} clusters: {histogram_of_paths(paths[key])}; "
                f"{counts['groups.host_enum_clusters']} clusters on the host enumeration "
                f"engine (P {over}) in "
                f"{stats['spans'].get('rpvg.groups.host_enum', {}).get('total_s', 0.0):.3f}s"
            )
    finally:
        group_scores_cuda.group_scores, posterior_gibbs_k_cuda.posterior_gibbs_k = score, sample
        batched_models.full_posteriors_batched = full
        batched_models.path_group_posteriors_gibbs_batched = gibbs
        posteriors.path_group_posteriors_full = host_engine
    return (
        scores, engine_inputs, jobs.get("hap-gibbs", []),
        launches["haplotypes"]["groups.launches"], launches["hap-gibbs"]["gibbs.kslot.launches"],
    )


def phase_independent(torch, device, cli, check_estimate_file, bench, work, threads):
    """Phase 13: haplotype-transcripts -f --ind-hap-inference on phase 4's
    dataset with the run's counters read just after (the
    EM tasks all through the ragged kernel, phase I2's jobs through the
    pair scorer on cuda); the tasks phase D hands em_cuda.em_fixed_point
    are captured, then re-timed and held against the plain version as in
    phase 4.  Returns (stats, counters, the EM result on the tasks)."""
    from rpvg_tpu_torch.ops import em_cuda

    captured = []
    launch = em_cuda.em_fixed_point

    def capture(tasks, max_em_its, max_rel_em_conv):
        captured.append((tasks, max_em_its, max_rel_em_conv))
        return launch(tasks, max_em_its, max_rel_em_conv)

    em_cuda.em_fixed_point = capture
    try:
        stats, counts = bench_run(torch, device, cli, check_estimate_file, 13, bench,
                                  os.path.join(work, "independent"), threads,
                                  "haplotype-transcripts", True, extra=("--ind-hap-inference",))
    finally:
        em_cuda.em_fixed_point = launch
    phases = stats["phase_seconds"]
    log(
        f"phase 13: --ind-hap-inference: I1 group matrices {phases['I1']:.3f}s, I2 group "
        f"posteriors ({stats['group_engine']}, {stats['scored_clusters']} (cluster, transcript "
        f"group) jobs, {counts['posteriors.scored.cuda']} scored on cuda) {phases['I2']:.3f}s, I3 subset "
        f"sampling {phases['I3']:.3f}s, C task fill {phases['C']:.3f}s, D {phases['D']:.3f}s "
        f"on {stats['em_tasks']} EM tasks ({counts['em.ragged.tasks']} through the ragged kernel "
        f"in {counts['em.ragged.launches']} launches), E {phases['E']:.3f}s"
    )
    em = phase_main_path_em(torch, device, captured, phase=13, run="the --ind-hap-inference run",
                            plain_tasks=1024)
    return stats, counts, em


# Runs the CLI in a fresh interpreter (so its workers fork before any
# CUDA context exists), each worker recording the CUDA state it finds,
# with the run's counters read just after.
MP_PROBE = r"""
import json, os, sys
import torch
import chip_smoke
from rpvg_tpu_torch import cli
from rpvg_tpu_torch.parallel import multihost

out_dir, argv = sys.argv[1], sys.argv[2:]
shard_worker = multihost._shard_worker

def recording_worker(args):
    with open(os.path.join(out_dir, f"mp_worker_{os.getpid()}.json"), "w") as handle:
        json.dump({"initialized": torch.cuda.is_initialized(),
                   "bad_fork": torch.cuda._is_in_bad_fork()}, handle)
    return shard_worker(args)

multihost._shard_worker = recording_worker
rc, stats = cli.run_cli(argv)
counts = chip_smoke.read_counters()
keep = ("phase_seconds", "em_tasks", "scored_clusters", "gibbs_jobs", "num_clusters", "fragment_pass_seconds", "fragment_scan_s", "merge_s",
        "matrix_seconds", "output_seconds", "wall_seconds")
print(json.dumps({"rc": rc, "stats": {k: stats[k] for k in keep} if stats else None,
                  "counts": counts, "peak_mib": torch.cuda.max_memory_allocated() / 2**20}))
"""


def phase_multiprocess(bench, work, threads, main_stats, main_prefix, workers=4):
    """Phase 14: the main path with --multiprocess 4 through the CLI in a
    fresh interpreter: every worker found no CUDA state, the device work
    went through the kernels, and the outputs are phase 4's bytes.
    Prints the fragment pass (the slowest worker's scan and the merge)
    beside phase 4's single-process pass."""
    import glob
    import json

    prefix = os.path.join(work, "multiprocess")
    argv = cli_argv(bench, prefix, "cuda", threads) + ["--multiprocess", str(workers)]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", MP_PROBE, work, *argv], capture_output=True, text=True,
        cwd=root, env=dict(os.environ, PYTHONPATH=root), timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"--multiprocess {workers} exited {proc.returncode}: {proc.stderr[-2000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    stats, counts = result["stats"], collections.Counter(result["counts"])
    if result["rc"] != 0:
        raise RuntimeError(f"--multiprocess {workers} CLI exited {result['rc']}")
    found = [json.load(open(path)) for path in glob.glob(os.path.join(work, "mp_worker_*.json"))]
    if len(found) != workers or any(f != {"initialized": False, "bad_fork": False} for f in found):
        raise AssertionError(f"--multiprocess workers found CUDA state: {found}")
    check_routes("haplotype-transcripts", False, stats, counts)
    same = []
    for suffix in output_suffixes("haplotype-transcripts"):
        with open(prefix + suffix, "rb") as a, open(main_prefix + suffix, "rb") as b:
            same.append(a.read() == b.read())
    if not all(same):
        raise AssertionError(f"--multiprocess {workers} outputs differ from phase 4's")
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in stats["phase_seconds"].items())
    log(
        f"phase 14: haplotype-transcripts -f --multiprocess {workers}: {PAIRS} pairs on cuda in "
        f"{stats['wall_seconds']:.2f}s inside the CLI = {PAIRS / stats['wall_seconds']:.1f} read "
        f"pairs/s ({wall:.2f}s with the interpreter's start); fragment pass "
        f"{stats['fragment_pass_seconds']:.2f}s (slowest worker's scan "
        f"{stats['fragment_scan_s']:.2f}s, merge {stats['merge_s']:.3f}s) against phase 4's "
        f"single-process {main_stats['fragment_pass_seconds']:.2f}s; matrices "
        f"{stats['matrix_seconds']:.2f}s, phases {phases}, outputs "
        f"{stats['output_seconds']:.2f}s; {stats['em_tasks']} EM tasks through the ragged kernel "
        f"in {counts['em.ragged.launches']} launches; {workers} workers forked with no CUDA state "
        f"(not initialised, not a bad fork); .txt and _joint.txt byte-identical to phase 4's; "
        f"max_memory_allocated {result['peak_mib']:.1f} MiB"
    )
    return stats, counts


VIRTUAL_SHARDS = 4

# Phase 3's configurations that phase 15 repeats on virtual shards: all
# four models, -y 3, -b, -n 8 and --use-hap-gibbs.
SHARD_LABELS = (
    "haplotype-transcripts", "transcripts", "strains", "haplotypes", "haplotypes -y 3",
    "haplotype-transcripts -y 3", "haplotype-transcripts -b", "transcripts -b",
    "transcripts -n 8", "strains -n 8", "haplotype-transcripts -n 8",
    "haplotypes --use-hap-gibbs", "haplotype-transcripts --use-hap-gibbs",
)


def read_outputs(prefix, suffixes):
    """Each output file's bytes (a .gz file's decompressed bytes)."""
    import gzip

    out = {}
    for suffix in suffixes:
        with (gzip.open if suffix.endswith(".gz") else open)(prefix + suffix, "rb") as handle:
            out[suffix] = handle.read()
    return out


def sharded_cli_run(torch, device, cli, argv, shards):
    """One CLI run on ``shards`` virtual shards of the card, the run's
    counters read just after; returns (stats, counters)."""
    from rpvg_tpu_torch.parallel import autoshard

    with autoshard.virtual_devices(device, shards):
        torch.cuda.reset_peak_memory_stats(device)
        rc, stats = cli.run_cli(argv)
        counts = read_counters()
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[-4:])} on {shards} virtual shards exited {rc}")
    if stats["data_shards"] != shards:
        raise AssertionError(f"the run saw {stats['data_shards']} data shards, not {shards}")
    return stats, counts


def hold_sharded_outputs(label, compare, prefix, ref_prefix, suffixes):
    """'byte-identical', or for a last-bit difference of a pair score
    (cuBLAS may pick another product for another batch) the compare.py
    fallback: estimate files equal under compare.py with the largest
    difference stated, -b and _gibbs.txt.gz files still byte-identical."""
    ours, ref = read_outputs(prefix, suffixes), read_outputs(ref_prefix, suffixes)
    differ = [s for s in suffixes if ours[s] != ref[s]]
    if not differ:
        return "byte-identical"
    if any(s.endswith(".gz") for s in differ):
        raise AssertionError(f"{label}: {differ} differ from one shard's")
    reports = [compare.compare_estimate_files(prefix + s, ref_prefix + s, RTOL, ATOL_OUT)
               for s in differ]
    return (f"{', '.join(differ)} not byte-identical, equal under compare.py (max abs "
            f"{max(r['max_abs_diff'] for r in reports):.3e}, max rel "
            f"{max(r['max_rel_diff'] for r in reports):.3e})")


def phase_virtual_main_path(torch, device, cli, bench, work, threads, main_stats, main_counts):
    """Phase 15 (a): phase 4's main path on VIRTUAL_SHARDS virtual shards
    of the card: phase 4's bytes, every EM task through the ragged kernel
    (one launch set per shard), wall and tasks per shard beside phase 4's.
    Returns (stats, counters, phase B's inputs, whether the outputs are
    phase 4's bytes), the last checked by the caller after (a')."""
    from rpvg_tpu_torch.infer import batched_models
    from rpvg_tpu_torch.testing import shard_counts

    captured = []
    score = batched_models.diploid_posteriors_batched

    def capture(inputs, min_rel_likelihood, on):
        captured.append((inputs, min_rel_likelihood))
        return score(inputs, min_rel_likelihood, on)

    prefix = os.path.join(work, "virtual")
    batched_models.diploid_posteriors_batched = capture
    try:
        stats, counts = sharded_cli_run(torch, device, cli, cli_argv(bench, prefix, "cuda", threads),
                                        VIRTUAL_SHARDS)
    finally:
        batched_models.diploid_posteriors_batched = score
    check_routes("haplotype-transcripts", False, stats, counts)
    suffixes = output_suffixes("haplotype-transcripts")
    same = read_outputs(prefix, suffixes) == read_outputs(os.path.join(work, "bench"), suffixes)
    phases = ", ".join(
        f"{k} {v:.3f}s (phase 4: {main_stats['phase_seconds'][k]:.3f}s)"
        for k, v in stats["phase_seconds"].items()
    )
    log(
        f"phase 15 (a): haplotype-transcripts -f on {VIRTUAL_SHARDS} virtual shards of cuda:0: "
        f"{PAIRS} pairs in {stats['wall_seconds']:.2f}s inside the CLI (phase 4: "
        f"{main_stats['wall_seconds']:.2f}s) = {PAIRS / stats['wall_seconds']:.1f} read pairs/s; "
        + "".join(f"{name} {stats[key]:.2f}s (phase 4: {main_stats[key]:.2f}s), " for name, key in (
            ("fragment pass", "fragment_pass_seconds"), ("matrices", "matrix_seconds"),
            ("outputs", "output_seconds")))
        + f"phases {phases}; EM tasks per shard {shard_counts(counts, 'em_tasks')}, pair "
        f"clusters per shard {shard_counts(counts, 'pair_clusters')}; "
        f"{stats['em_tasks']} EM tasks through the ragged kernel in {counts['em.ragged.launches']} "
        f"launches (phase 4: {main_counts['em.ragged.launches']}); .txt and _joint.txt byte-identical "
        f"to phase 4's: {same}; peak {stats['device_peak_mib_max']:.1f} MiB"
    )
    return stats, counts, captured, same


def phase_virtual_pair_scores(torch, device, captured):
    """Phase 15 (a'): the main path's phase B inputs scored in one shard's
    chunks and in VIRTUAL_SHARDS shards' chunks: bitwise, or the largest
    relative difference stated and held to rtol 1e-10 with identical -inf
    and identical selected pairs."""
    import numpy as np

    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.parallel import autoshard

    (inputs, min_rel), = captured
    buckets, _ = posteriors._bucket_plan(inputs)

    def scores(devices):
        out = {}
        for chunk, pair_ll, _ in posteriors._score_chunks(inputs, buckets, devices):
            pair_ll = pair_ll.cpu().numpy()
            for b, idx in enumerate(chunk):
                P = inputs[idx][0].shape[1]
                out[idx] = pair_ll[b, :P, :P]
        return out

    one, many = scores((device,)), scores((device,) * VIRTUAL_SHARDS)
    bitwise = all(np.array_equal(one[i], many[i]) for i in one)
    worst = 0.0
    for i in one:
        a, b = one[i], many[i]
        if not np.array_equal(np.isneginf(a), np.isneginf(b)):
            raise AssertionError(f"pair scores of cluster {i}: -inf differs across shard counts")
        finite = np.isfinite(a)
        rel = np.abs(a[finite] - b[finite]) / np.maximum(np.abs(a[finite]), 1e-300)
        worst = max(worst, float(rel.max(initial=0.0)))
    if worst > 1e-10:
        raise AssertionError(f"pair scores differ across shard counts by rel {worst:.3e}")
    single = posteriors.diploid_posteriors_batched(inputs, min_rel, device)
    with autoshard.virtual_devices(device, VIRTUAL_SHARDS):
        sharded = posteriors.diploid_posteriors_batched(inputs, min_rel, device)
    for (ga, pa), (gb, pb) in zip(single, sharded):
        if ga != gb:
            raise AssertionError("selected pairs differ across shard counts")
        np.testing.assert_allclose(pb, pa, rtol=1e-10, atol=0)
    log(
        f"phase 15 (a'): the main path's {len(one)} phase-B clusters scored in one shard's chunks "
        f"and in {VIRTUAL_SHARDS} shards' chunks: pair scores "
        + ("bitwise equal" if bitwise else f"not bitwise, largest relative difference {worst:.3e}")
        + "; selected pairs identical, posteriors within rtol 1e-10"
    )
    return bitwise, worst


def phase_virtual_configs(torch, device, cli, compare, datasets, work, threads):
    """Phase 15 (b): SHARD_LABELS on VIRTUAL_SHARDS virtual shards against
    phase 3's one-shard cuda runs of the same argv, counters checked."""
    from rpvg_tpu_torch.testing import shard_counts

    cli_configs = {c[0]: c for c in CLI_CONFIGS}
    gibbs_configs = {c[0]: c for c in GIBBS_CONFIGS}
    held = {}
    for label in SHARD_LABELS:
        if label in cli_configs:
            _, model, dataset, extra, qual = cli_configs[label]
            info = model == "haplotype-transcripts"
            name = "small_" + "".join(c if c.isalnum() else "_" for c in label)
            ref_prefix = os.path.join(work, f"{name}_cuda")
            paths = datasets[dataset]
        else:
            _, model, info, extra, _ = gibbs_configs[label]
            qual = False
            ref_prefix = os.path.join(work, f"gibbs_{label.replace(' ', '_')}_cuda")
            paths = datasets["small"]
        prefix = ref_prefix + "_shards"
        argv = cli_argv(paths, prefix, "cuda", threads, model, info, qual) + list(extra)
        stats, counts = sharded_cli_run(torch, device, cli, argv, VIRTUAL_SHARDS)
        ploidy = int(extra[list(extra).index("-y") + 1]) if "-y" in extra else 2
        check_routes(model, False, stats, counts, hap_gibbs="--use-hap-gibbs" in extra,
                     ploidy=ploidy)
        suffixes = output_suffixes(model) + (("_probs.txt.gz",) if "-b" in extra else ()) + (
            ("_gibbs.txt.gz",) if "-n" in extra else ())
        held[label] = hold_sharded_outputs(label, compare, prefix, ref_prefix, suffixes)
        log(f"phase 15 (b): {label}, 5000 pairs, {VIRTUAL_SHARDS} virtual shards vs one: "
            f"{', '.join(suffixes)} {held[label]}; tasks, jobs and clusters per shard "
            f"{shard_counts(counts)}")
    return held


def phase_virtual_giant(torch, device, cli, compare, small, work, threads, limit="4096"):
    """Phase 15 (c): haplotypes under RPVG_TPU_PAIR_TENSOR_LIMIT=``limit``
    on one shard (column blocks) and on VIRTUAL_SHARDS virtual shards (the
    giant-cluster shard route, asserted to have run)."""
    os.environ["RPVG_TPU_PAIR_TENSOR_LIMIT"] = limit
    try:
        ran = {}
        for shards in (1, VIRTUAL_SHARDS):
            prefix = os.path.join(work, f"giant_{shards}")
            _, counts = sharded_cli_run(
                torch, device, cli, cli_argv(small, prefix, "cuda", threads, "haplotypes", False),
                shards)
            ran[shards] = counts["posteriors.sharded_pair_clusters"]
    finally:
        os.environ.pop("RPVG_TPU_PAIR_TENSOR_LIMIT", None)
    if ran[1] or not ran[VIRTUAL_SHARDS]:
        raise AssertionError(f"the giant-cluster shard route ran {ran} times (by shard count)")
    held = hold_sharded_outputs("giant clusters", compare, os.path.join(work, f"giant_{VIRTUAL_SHARDS}"),
                                os.path.join(work, "giant_1"), (".txt",))
    log(f"phase 15 (c): haplotypes, RPVG_TPU_PAIR_TENSOR_LIMIT={limit}: {ran[VIRTUAL_SHARDS]} giant "
        f"clusters scored with their pair rows on {VIRTUAL_SHARDS} virtual shards (none on one "
        f"shard, which scores them in column blocks); .txt {held}")
    return ran[VIRTUAL_SHARDS], held


def phase_virtual_em_step(torch, device):
    """Phase 15 (d): parallel/mesh.sharded_em_step on VIRTUAL_SHARDS
    virtual shards, the multi-bucket kernel on each shard's block, against
    its plain version (rtol 1e-6); its time beside one shard's."""
    import numpy as np

    from rpvg_tpu_torch.entry import _example_batch
    from rpvg_tpu_torch.ops import em_fused_cuda
    from rpvg_tpu_torch.parallel import autoshard, mesh
    from rpvg_tpu_torch.testing import counted

    B, R, C = 256, 64, 16
    probs, counts, col_masks = (torch.from_numpy(a).to(device) for a in _example_batch(B, R, C))
    inv_eff = torch.full((B, C - 1), 1.0 / 100.0, dtype=torch.float64, device=device)
    steps = {}
    for shards in (1, VIRTUAL_SHARDS):
        with autoshard.virtual_devices(device, shards) as devices:
            steps[shards] = mesh.sharded_em_step(mesh.make_mesh(devices), 10000, 1e-3)
    with counted() as counters:
        abund, tpm = steps[VIRTUAL_SHARDS](probs, counts, col_masks, inv_eff)
    torch.cuda.synchronize()
    launches = counters["em.padded.launches"]
    (plain,), _ = em_fused_cuda.em_fixed_point_padded_plain([(probs, counts, col_masks)], 10000, 1e-3)
    plain_tpm = float((plain[:, :-1] * counts.sum(dim=1)[:, None] * inv_eff).sum())
    err = float((abund - plain).abs().max())
    np.testing.assert_allclose(abund.cpu().numpy(), plain.cpu().numpy(), rtol=RTOL, atol=ATOL_EM)
    if abs(float(tpm) - plain_tpm) > RTOL * abs(plain_tpm):
        raise AssertionError(f"sharded TPM {float(tpm)} against plain {plain_tpm}")
    ms = {shards: cuda_ms(lambda s=shards: steps[s](probs, counts, col_masks, inv_eff), 5)
          for shards in (1, VIRTUAL_SHARDS)}
    log(f"phase 15 (d): sharded_em_step on {VIRTUAL_SHARDS} virtual shards, ({B}, {R}, {C}) "
        f"float64: the multi-bucket kernel in {launches} launch(es), max abs {err:.3e} against "
        f"the plain version (rtol {RTOL}), TPM rel "
        f"{abs(float(tpm) - plain_tpm) / abs(plain_tpm):.3e}; {ms[VIRTUAL_SHARDS]:.3f} ms against "
        f"{ms[1]:.3f} ms on one shard")
    return err, ms


def phase_virtual_shards(torch, device, cli, compare, datasets, bench, work, threads,
                         main_stats, main_counts):
    """Phase 15: the shard logic on VIRTUAL_SHARDS virtual shards of the
    card with the real kernels ((a)-(e)), then (f) on real devices where
    the host has more than one."""
    from rpvg_tpu_torch.entry import dryrun_multidevice
    from rpvg_tpu_torch.testing import shard_counts

    t0 = time.perf_counter()
    stats, counts, captured, same = phase_virtual_main_path(torch, device, cli, bench, work,
                                                            threads, main_stats, main_counts)
    pair_bitwise, pair_rel = phase_virtual_pair_scores(torch, device, captured)
    if not same:
        raise AssertionError(f"the main path on {VIRTUAL_SHARDS} virtual shards differs from "
                             f"phase 4's bytes")
    held = phase_virtual_configs(torch, device, cli, compare, datasets, work, threads)
    giant, giant_held = phase_virtual_giant(torch, device, cli, compare, datasets["small"], work,
                                            threads)
    em_err, em_ms = phase_virtual_em_step(torch, device)
    t1 = time.perf_counter()
    report = dryrun_multidevice(VIRTUAL_SHARDS, device, virtual=True)
    log(f"phase 15 (e): dryrun_multidevice({VIRTUAL_SHARDS}, cuda, virtual=True) in "
        f"{time.perf_counter() - t1:.1f}s: the mesh step, the histogram, the batched dispatches and both "
        f"regimes with -n 3 -b: {report}")
    count = torch.cuda.device_count()
    if count > 1:
        prefix = os.path.join(work, "real_shards")
        with_real = cli_argv(bench, prefix, "cuda", threads)
        rc, real_stats = cli.run_cli(with_real)
        real_counts = read_counters()
        if rc != 0 or real_stats["data_shards"] != count:
            raise RuntimeError(f"the main path on {count} devices: rc {rc}")
        check_routes("haplotype-transcripts", False, real_stats, real_counts)
        real_held = hold_sharded_outputs("real devices", compare, prefix,
                                         os.path.join(work, "bench"), (".txt", "_joint.txt"))
        real_report = dryrun_multidevice(min(count, VIRTUAL_SHARDS), "cuda")
        log(f"phase 15 (f): the main path on {count} devices in {real_stats['wall_seconds']:.2f}s, "
            f"tasks, jobs and clusters per shard {shard_counts(real_counts)}, {real_held} against "
            f"phase 4; "
            f"dryrun_multidevice({min(count, VIRTUAL_SHARDS)}, cuda): {real_report}")
    else:
        log(f"phase 15 (f): {count} CUDA device visible: only virtual shards ran (a real "
            f"multi-device run waits for a host with more than one)")
    log(f"phase 15: {time.perf_counter() - t0:.1f}s in all")
    return {"main_stats": stats, "main_counts": counts, "pair_bitwise": pair_bitwise,
            "pair_rel": pair_rel, "configs": held, "giant_clusters": giant,
            "giant_held": giant_held, "em_step_err": em_err, "em_step_ms": em_ms,
            "dryrun": report}


# ------------------------------------------------ phase 16: fused routes

# Every switch of the JAX package's fused routes that phase 16 sets.
FUSED_SWITCHES = (
    "RPVG_TPU_FUSED_NESTED", "RPVG_TPU_FUSED_STRAINS", "RPVG_TPU_EM_BOUND",
    "RPVG_TPU_ESC_MIN_AREA", "RPVG_TPU_DEVICE_SLOT_AREA", "RPVG_TPU_COMPOSE_OUT",
)


def with_switches(switches, fn):
    """``fn()`` with the environment variables ``switches`` set, every
    other fused-route switch unset, and all of them restored after."""
    saved = {name: os.environ.pop(name, None) for name in FUSED_SWITCHES}
    os.environ.update(switches)
    try:
        return fn()
    finally:
        for name in FUSED_SWITCHES:
            os.environ.pop(name, None)
            if saved[name] is not None:
                os.environ[name] = saved[name]


def fused_run(torch, device, cli, check_estimate_file, label, paths, prefix, threads, model,
              info, switches, backend="cuda", extra=(), phase="16"):
    """One CLI run on a fused route (``switches``) at full width, with the
    run's counters read just after: every task of the device legs in an
    EM kernel, every Gibbs job in the read-count kernel, no phase B on the
    card (the C++ call scores the pairs).  Returns (stats, counters, wall)
    after printing a line."""
    if backend == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    rc, stats = with_switches(switches, lambda: cli.run_cli(
        cli_argv(paths, prefix, backend, threads, model, info) + list(extra)))
    wall = time.perf_counter() - t0
    counts = read_counters()
    if rc != 0:
        raise RuntimeError(f"phase {phase} {label} exited {rc}")
    if stats.get("route") != "fused native":
        raise AssertionError(f"phase {phase} {label}: the fused route did not run")
    rows = [check_estimate_file(prefix + s) for s in output_suffixes(model)]
    gibbs_jobs = stats.get("gibbs_jobs", 0)
    if backend == "cuda" and not (
        counts["em.ragged.tasks"] + counts["em.padded.tasks"] == counts["fused.device_em_tasks"]
        and counts["gibbs.readcount.jobs"] == gibbs_jobs
        and (counts["gibbs.readcount.launches"] >= 1) == (gibbs_jobs > 0)
        and counts["posteriors.scored.cuda"] == 0 and counts["posteriors.scored.cpu"] == 0
    ):
        raise AssertionError(f"phase {phase} {label}: device work not all through the kernels: "
                             f"{counts}, stats {stats}")
    legs = {**{key: stats[key] for key in ("em_bound", "gibbs_jobs") if key in stats},
            **{name: n for name, n in counts.items() if name.startswith("fused.")},
            **{name: span["total_s"] for name, span in stats["spans"].items()
               if name.startswith("rpvg.fused.")}}
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in stats["phase_seconds"].items())
    peak = (f"; max_memory_allocated {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB"
            if backend == "cuda" else "")
    log(
        f"phase {phase} {label}: {model}{' -f' if info else ''}{' ' + ' '.join(extra) if extra else ''} "
        f"{' '.join(f'{k}={v}' for k, v in switches.items())} --backend {backend}: {PAIRS} pairs "
        f"in {wall:.2f}s wall = {PAIRS / wall:.1f} read pairs/s; fragment pass "
        f"{stats['fragment_pass_seconds']:.2f}s, matrices {stats['matrix_seconds']:.2f}s, phases "
        f"{phases}, outputs {stats['output_seconds']:.2f}s; {stats['em_tasks']} EM tasks, legs "
        f"{json.dumps(legs)}; kernels: ragged {counts['em.ragged.launches']} launch(es) / "
        f"{counts['em.ragged.tasks']} tasks, multi-bucket {counts['em.padded.launches']} / "
        f"{counts['em.padded.tasks']}, read-count {counts['gibbs.readcount.launches']} / "
        f"{counts['gibbs.readcount.jobs']} jobs; output rows {' + '.join(map(str, rows))}, all finite{peak}"
    )
    return stats, counts, wall


def hold_outputs(label, compare, prefix, ref_prefix, model, byte_identical=False, phase="16"):
    """The estimate files of ``prefix`` against ``ref_prefix``: identical
    rows within rtol 1e-6 / atol 1e-6, or byte for byte."""
    suffixes = output_suffixes(model)
    if byte_identical:
        ours, ref = read_outputs(prefix, suffixes), read_outputs(ref_prefix, suffixes)
        differ = [suffix for suffix in suffixes if ours[suffix] != ref[suffix]]
        if differ:
            raise AssertionError(f"phase {phase} {label}: {differ} not byte-identical")
        log(f"phase {phase} {label}: against {os.path.basename(ref_prefix)}: "
            f"{', '.join(suffixes)} byte-identical")
        return
    reports = []
    for suffix in suffixes:
        rep = compare.compare_estimate_files(prefix + suffix, ref_prefix + suffix, RTOL, ATOL_OUT)
        reports.append(f"{suffix} {rep['rows']} rows, max rel {rep['max_rel_diff']:.3e}, "
                       f"byte-identical {rep['byte_identical']}")
    log(f"phase {phase} {label}: against {os.path.basename(ref_prefix)}: " + "; ".join(reports))


def hold_gibbs(label, compare, prefix, ref_prefix):
    rep = compare.compare_gibbs_files(prefix + "_gibbs.txt.gz", ref_prefix + "_gibbs.txt.gz",
                                      N_SE, same_rows=True)
    log(f"phase 16 {label}: _gibbs.txt.gz against {os.path.basename(ref_prefix)}: "
        f"{rep['rows']} rows, {rep['outside']} outside {N_SE:.0f} se (allowed "
        f"{gibbs_rows_allowed(rep['rows'])}), worst {rep['max_se']:.2f} se")
    if rep["outside"] > gibbs_rows_allowed(rep["rows"]):
        raise AssertionError(f"phase 16 {label}: Gibbs sample means differ")


def routes_in_turns(torch, device, cli, check_estimate_file, label, bench, prefix, threads,
                    model, info, switches):
    """The staged and the fused route on cuda in turns (staged, fused,
    fused, staged), walls on the CLI's clock: the wall, the inference
    phases and the outputs of each run, printed and returned."""
    walls = {"staged": [], "fused": []}
    for k, route in enumerate(("staged", "fused", "fused", "staged")):
        tag = f"turn_{model}_{k}"
        rc, stats = with_switches(switches if route == "fused" else {}, lambda: cli.run_cli(
            cli_argv(bench, prefix(tag), "cuda", threads, model, info)))
        if rc != 0 or (stats.get("route") == "fused native") != (route == "fused"):
            raise RuntimeError(f"phase 16 {label}: {route} turn {k} failed")
        for suffix in output_suffixes(model):
            check_estimate_file(prefix(tag) + suffix)
        walls[route].append((stats["wall_seconds"], sum(stats["phase_seconds"].values()),
                             stats["output_seconds"]))
    log(f"phase 16 {label}: {model} staged / fused in turns (staged, fused, fused, staged), "
        f"seconds on the CLI's clock as (wall, inference phases, outputs): staged "
        + ", ".join(f"({w:.2f}, {p:.3f}, {o:.3f})" for w, p, o in walls["staged"]) + "; fused "
        + ", ".join(f"({w:.2f}, {p:.3f}, {o:.3f})" for w, p, o in walls["fused"]))
    return {f"{route}_{key}": [run[i] for run in walls[route]]
            for route in walls for i, key in enumerate(("wall_s", "phases_s", "outputs_s"))}


def link_numbers(torch, device):
    """(dispatch seconds, host-to-device bytes per second) on the host
    clock: a tiny launch and a synchronize, the mean of 3 after a warm
    call; one 4 MB copy from page-locked memory and a synchronize, after
    a warm copy."""
    x = torch.zeros(1, device=device)

    def tiny():
        x.add_(1)
        torch.cuda.synchronize()

    tiny()
    t0 = time.perf_counter()
    for _ in range(3):
        tiny()
    dispatch_s = (time.perf_counter() - t0) / 3
    host = torch.empty(4 << 20, dtype=torch.uint8).pin_memory()
    dst = torch.empty(host.shape, dtype=host.dtype, device=device)
    dst.copy_(host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    return dispatch_s, host.numel() / (time.perf_counter() - t0)


def captured_blocks_check(torch, captured, label):
    """The multi-bucket kernel on the blocks a run handed it (each call of
    em_fused_cuda.em_fixed_point_padded, captured by the script), re-timed
    with CUDA events and held against its plain version on the same
    blocks (every fraction within rtol RTOL / atol ATOL_EM)."""
    import numpy as np

    from rpvg_tpu_torch.ops import em_fused_cuda

    kernel = em_fused_cuda.em_fixed_point_padded
    plain = em_fused_cuda.em_fixed_point_padded_plain

    def run(solve):
        return [solve(blocks, its, tol) for blocks, its, tol in captured]

    def flat(outs, part):
        return torch.cat([t.reshape(-1) for out in outs for t in out[part]]).cpu().numpy()

    k_outs = run(kernel)
    kernel_ms = cuda_ms(lambda: run(kernel), reps=5)
    p_outs, plain_ms = timed_once(lambda: run(plain))
    k, p = flat(k_outs, 0), flat(p_outs, 0)
    diff = np.abs(k - p)
    n_bad = int((diff > ATOL_EM + RTOL * np.abs(p)).sum())
    iters = flat(k_outs, 1)
    off_by = int((iters != flat(p_outs, 1)).sum())
    blocks = [block for group, _, _ in captured for block in group]
    extents = em_fused_cuda.cluster_extents(blocks)
    in_elems = sum(p.numel() + c.numel() + m.numel() for p, c, m in blocks)
    out_elems = sum(m.numel() for _, _, m in blocks) + iters.size
    # Descriptors (5 int64 per block) and cluster offsets (blocks + 1).
    meta = sum(6 * len(group) + 1 for group, _, _ in captured)
    bound_ms, bound_by = em_bound(
        8 * (in_elems + meta), 8 * out_elems, iters, extents[:, 0], extents[:, 1]
    )
    log(f"phase 16 {label}: the multi-bucket kernel on the run's {len(captured)} launch "
        f"group(s) ({iters.size} clusters, {len(blocks)} blocks, padded shapes "
        f"{sorted({tuple(b[0].shape[1:]) for b in blocks})}) re-timed: {kernel_ms:.3f} ms "
        f"(CUDA events), plain {plain_ms:.1f} ms (one run), bound {bound_ms:.4f} ms "
        f"({bound_by}); vs plain max abs {float(diff.max()):.3e}, {n_bad} out of tolerance "
        f"(rtol {RTOL}, atol {ATOL_EM}), {off_by} clusters with another iteration count")
    if n_bad:
        raise AssertionError(f"phase 16 {label}: multi-bucket kernel disagrees with plain")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": float(diff.max()), "clusters": int(iters.size)}


def phase_fused_routes(torch, device, cli, compare, check_estimate_file, bench, work, threads,
                       staged):
    """Phase 16: the JAX package's fused native routes on phase 4's
    dataset with --backend cuda (``staged``: phase 6's and 9's prefixes
    of the staged runs it is held against): (a) RPVG_TPU_FUSED_NESTED=1
    at the port's defaults (the escalated tail on the ragged kernel,
    re-timed on what it was handed), cuda and cpu, and the staged and
    fused routes on cuda in turns; (b) the tail on the host
    (RPVG_TPU_ESC_MIN_AREA at the JAX package's 10^12); (c) the link's
    numbers and a run with RPVG_TPU_DEVICE_SLOT_AREA at the 16th largest
    slot's area, the multi-bucket kernel re-timed on its blocks; (d) -n
    100 on the fused route, cuda against cpu; (e)
    RPVG_TPU_FUSED_STRAINS=1 plain (in turns with the staged route) and
    with -n 100 against the staged runs; (f) RPVG_TPU_COMPOSE_OUT=0
    against the composer, byte for byte, on (a) and on the staged
    transcripts and strains runs."""
    from rpvg_tpu_torch import native
    from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda

    model = "haplotype-transcripts"
    prefix = lambda tag: os.path.join(work, f"fused_{tag}")  # noqa: E731
    run = lambda label, tag, switches, **kw: fused_run(  # noqa: E731
        torch, device, cli, check_estimate_file, label, bench, prefix(tag), threads,
        kw.pop("model", model), kw.pop("info", True), switches, **kw)
    nested = {"RPVG_TPU_FUSED_NESTED": "1"}
    out = {}

    # (a) the port's defaults: the escalated tail on the ragged kernel,
    # its tasks captured; the slot areas captured for (c).
    areas = []
    infer = native.nested_diploid_infer
    captured = []
    launch = em_cuda.em_fixed_point

    def capture_areas(dense_clusters, *args, **kwargs):
        areas.extend(p.shape[0] * p.shape[1] for p, _, _ in dense_clusters)
        return infer(dense_clusters, *args, **kwargs)

    def capture(tasks, max_em_its, max_rel_em_conv):
        captured.append((tasks, max_em_its, max_rel_em_conv))
        return launch(tasks, max_em_its, max_rel_em_conv)

    native.nested_diploid_infer, em_cuda.em_fixed_point = capture_areas, capture
    try:
        stats_a, counts_a, _ = run("(a)", "a", nested)
    finally:
        native.nested_diploid_infer, em_cuda.em_fixed_point = infer, launch
    if not (counts_a["em.ragged.launches"] >= 1
            and counts_a["em.ragged.tasks"] == counts_a["fused.escalated_on_device"] > 0):
        raise AssertionError(f"phase 16 (a): the escalated tail did not run on the ragged "
                             f"kernel: {counts_a}")
    run("(a)", "a_cpu", nested, backend="cpu")
    hold_outputs("(a) cuda vs cpu", compare, prefix("a"), prefix("a_cpu"), model)
    hold_outputs("(a) fused vs staged", compare, prefix("a"), os.path.join(work, "bench"), model)
    tail = phase_main_path_em(torch, device, captured, phase="16 (a)",
                              run="the escalated tail")
    out["a"] = {"native_s": stats_a["phase_seconds"]["native"],
                "device_s": stats_a["phase_seconds"]["device"],
                "launches": counts_a["em.ragged.launches"], "tasks": counts_a["em.ragged.tasks"],
                "area": counts_a["fused.escalated_area"], **tail,
                **routes_in_turns(torch, device, cli, check_estimate_file, "(a)", bench, prefix,
                                  threads, model, True, nested)}

    # (b) the JAX package's default: the tail rebatched on the host.
    stats_b, counts_b, _ = run("(b)", "b", {**nested, "RPVG_TPU_ESC_MIN_AREA": str(10**12)})
    if counts_b["em.ragged.launches"] or counts_b["fused.escalated_on_device"]:
        raise AssertionError(f"phase 16 (b): the tail went to the card: {counts_b}")
    hold_outputs("(b) host tail, cuda vs cpu", compare, prefix("b"), prefix("a_cpu"), model)
    out["b"] = {"native_s": stats_b["phase_seconds"]["native"],
                "device_s": stats_b["phase_seconds"]["device"],
                "escalated_tasks": counts_b["fused.escalated_tasks"]}
    log(f"phase 16 (b): the escalated tail ({counts_a['fused.escalated_tasks']} tasks, "
        f"{counts_a['fused.escalated_area']} elements): device leg on the ragged kernel "
        f"{out['a']['device_s']:.3f} s in (a) against the host rebatch's "
        f"{out['b']['device_s']:.3f} s here (phase clock)")

    # (c) the link, and the 16 largest slots on the multi-bucket kernel.
    dispatch_s, h2d_bps = link_numbers(torch, device)
    order = sorted(areas, reverse=True)
    cutoff = order[min(15, len(order) - 1)]
    log(f"phase 16 (c): link on {torch.cuda.get_device_name(0)}: dispatch "
        f"{dispatch_s * 1e6:.1f} us (a tiny launch + synchronize, host clock, mean of 3 after "
        f"a warm call), host-to-device {h2d_bps / 1e9:.3f} GB/s (one 4 MB copy from "
        f"page-locked memory + synchronize, after a warm copy); largest slot areas "
        f"{order[:16]} of {len(areas)} slots")
    blocks_in = []
    padded = em_fused_cuda.em_fixed_point_padded

    def capture_blocks(blocks, max_em_its, max_rel_em_conv, extents=None):
        blocks_in.append((blocks, max_em_its, max_rel_em_conv))
        return padded(blocks, max_em_its, max_rel_em_conv, extents)

    em_fused_cuda.em_fixed_point_padded = capture_blocks
    try:
        stats_c, counts_c, _ = run("(c)", "c",
                                   {**nested, "RPVG_TPU_DEVICE_SLOT_AREA": str(cutoff)})
    finally:
        em_fused_cuda.em_fixed_point_padded = padded
    if not (counts_c["em.padded.launches"] >= 1 and counts_c["fused.routed_slots"] >= 1):
        raise AssertionError(f"phase 16 (c): no slot routed to the card: {counts_c}")
    hold_outputs("(c) cuda vs (a) cpu", compare, prefix("c"), prefix("a_cpu"), model)
    slots = captured_blocks_check(torch, blocks_in, "(c)")
    out["c"] = {"dispatch_us": dispatch_s * 1e6, "h2d_gbps": h2d_bps / 1e9, "cutoff": cutoff,
                "routed_slots": counts_c["fused.routed_slots"], "routed_tasks": counts_c["fused.routed_tasks"],
                "launches": counts_c["em.padded.launches"], "tasks": counts_c["em.padded.tasks"],
                "dispatch_s": stats_c["spans"]["rpvg.fused.dispatch"]["total_s"],
                "gather_wait_s": stats_c["spans"]["rpvg.fused.gather_wait"]["total_s"], **slots}

    # (d) -n 100 on the fused route, cuda against cpu (the samples are
    # allocated over the subsets on the host from the C++ call's subset
    # probabilities, so both devices sample the same rows).
    stats_d, counts_d, wall_d = run("(d)", "d", nested, extra=("-n", "100"))
    run("(d)", "d_cpu", nested, backend="cpu", extra=("-n", "100"))
    hold_outputs("(d) -n 100 cuda vs phase 9's staged cpu", compare, prefix("d"),
                 os.path.join(work, "gibbs_main_cpu"), model)
    hold_gibbs("(d) -n 100 cuda vs cpu", compare, prefix("d"), prefix("d_cpu"))
    out["d"] = {"launches": counts_d["gibbs.readcount.launches"], "jobs": counts_d["gibbs.readcount.jobs"],
                "wall_s": wall_d, "D2_s": stats_d["phase_seconds"]["D2"]}

    # (e) the fused strains route, plain and -n 100, against the staged.
    strains = {"RPVG_TPU_FUSED_STRAINS": "1"}
    stats_e, _, _ = run("(e)", "e", strains, model="strains", info=False)
    hold_outputs("(e) fused vs staged", compare, prefix("e"), staged["strains"], "strains")
    turns = routes_in_turns(torch, device, cli, check_estimate_file, "(e)", bench, prefix,
                            threads, "strains", False, strains)
    stats_en, counts_en, _ = run("(e)", "e_n", strains, model="strains", info=False,
                                 extra=("-n", "100"))
    run("(e)", "e_n_cpu", strains, model="strains", info=False, backend="cpu",
        extra=("-n", "100"))
    hold_outputs("(e) -n 100 fused vs staged", compare, prefix("e_n"), staged["strains_n"],
                 "strains")
    hold_gibbs("(e) -n 100 fused, cuda vs cpu", compare, prefix("e_n"), prefix("e_n_cpu"))
    out["e"] = {"native_s": stats_e["phase_seconds"]["native"], **turns,
                "launches": counts_en["gibbs.readcount.launches"], "jobs": counts_en["gibbs.readcount.jobs"]}

    # (f) the composer off against on, byte for byte.
    run("(f)", "f", {**nested, "RPVG_TPU_COMPOSE_OUT": "0"})
    hold_outputs("(f) object writers vs composer", compare, prefix("f"), prefix("a"), model,
                 byte_identical=True)
    for tag, ref in (("transcripts", staged["transcripts"]), ("strains", staged["strains"])):
        rc, _ = with_switches({"RPVG_TPU_COMPOSE_OUT": "0"}, lambda: cli.run_cli(
            cli_argv(bench, prefix(f"f_{tag}"), "cuda", threads, tag, tag == "transcripts")))
        if rc != 0:
            raise RuntimeError(f"phase 16 (f) {tag} exited {rc}")
        hold_outputs(f"(f) staged {tag}, object writers vs composer", compare,
                     prefix(f"f_{tag}"), ref, tag, byte_identical=True)
    return out

# ---------------------------------------- phase 17: the profiler hook

# Chrome-trace categories of the card's work and of the host's.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime")
EM_SYMBOLS = ("warp_team_kernel", "block_team_kernel")


def merged_intervals(spans):
    """The union of (start, end) spans as sorted disjoint [start, end]."""
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def trace_summary(path, top=5, gaps=3):
    """What a torch.profiler Chrome trace (RPVG_TPU_TORCH_PROFILE) says of
    the card: the profiled window (the profiler's own span), the union of kernel, copy and set intervals
    over all streams within it and its share of the window, the ``top``
    device operations by total time with their counts, and the ``gaps``
    longest idle gaps, each with the host event (torch op or CUDA call)
    that overlaps it most, the innermost on a tie.  Times in ms."""
    t0 = time.perf_counter()
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    parse_s = time.perf_counter() - t0
    window = None
    device, host = [], []
    by_name = {}
    for event in events:
        if event.get("ph") != "X":
            continue
        start = float(event["ts"])
        end = start + float(event.get("dur", 0.0))
        cat = event.get("cat", "")
        if cat == "Trace":
            window = (start, end)
        elif cat in DEVICE_CATEGORIES:
            device.append((start, end))
            total, count = by_name.get((event["name"], cat), (0.0, 0))
            by_name[(event["name"], cat)] = (total + end - start, count + 1)
        elif cat in HOST_CATEGORIES:
            host.append((start, end, event["name"]))
    if window is None:
        raise AssertionError(f"{path}: no profiler span")
    lo, hi = window
    busy = merged_intervals((max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi)
    busy_us = sum(b - a for a, b in busy)
    edges = [lo] + [x for span in busy for x in span] + [hi]
    idle = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)),
                  reverse=True)[:gaps]
    longest = []
    for length, start in idle:
        end = start + length
        best = None
        for a, b, name in host:
            overlap = min(b, end) - max(a, start)
            if overlap > 0 and (best is None or (overlap, a - b) > best[:2]):
                best = (overlap, a - b, name)
        longest.append({"at_ms": (start - lo) / 1e3, "ms": length / 1e3,
                        "host": best[2] if best else None,
                        "host_overlap_ms": best[0] / 1e3 if best else 0.0})
    ranked = sorted(by_name.items(), key=lambda item: -item[1][0])
    return {
        "window_ms": (hi - lo) / 1e3, "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / (hi - lo),
        "device_events": len(device), "host_events": len(host),
        "top": [{"name": name, "cat": cat, "ms": total / 1e3, "count": count}
                for (name, cat), (total, count) in ranked[:top]],
        "kernel_names": sorted({name for name, cat in by_name if cat == "kernel"}),
        "gaps": longest, "size_mib": os.path.getsize(path) / 2**20, "parse_s": parse_s,
    }


def phase_profile(torch, device, cli, compare, check_estimate_file, bench, work, threads):
    """Phase 17: phase 4's main path (staged) and phase 16 (a)'s fused
    nested route, each run without the profiler hook and then with
    RPVG_TPU_TORCH_PROFILE (the run's counters read just after each
    run); the hooked run writes the unhooked run's estimate
    bytes and one Chrome trace, whose busy share, top device operations
    and longest idle gaps are printed beside the hook's cost in wall.
    Fails when a trace holds no device activity, or when the main path's
    lacks the ragged EM kernel (A1)."""
    import glob

    from torch.profiler import ProfilerActivity, profile

    # The first session of a process sets the profiler up; timed apart,
    # so that each run's hook cost below is the hook's own.
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"phase 17: the process's first profiler session (CPU and CUDA activity, one op) took "
        f"{setup_s:.2f}s")
    model = "haplotype-transcripts"
    runs = (
        ("staged", "the main path (phase 4's run)", lambda prefix: bench_run(
            torch, device, cli, check_estimate_file, 17, bench, prefix, threads, model, True)),
        ("fused", "the fused nested route (phase 16 (a)'s run)", lambda prefix: fused_run(
            torch, device, cli, check_estimate_file, "(a)", bench, prefix, threads, model, True,
            {"RPVG_TPU_FUSED_NESTED": "1"}, phase="17")),
    )
    for key, label, run in runs:
        trace_dir = os.path.join(work, f"profile_{key}")
        walls = {}
        for hooked in (False, True):
            prefix = os.path.join(work, f"profile_{key}_{'on' if hooked else 'off'}")
            if hooked:
                os.environ["RPVG_TPU_TORCH_PROFILE"] = trace_dir
            t0 = time.perf_counter()
            try:
                run(prefix)
            finally:
                os.environ.pop("RPVG_TPU_TORCH_PROFILE", None)
            walls[hooked] = time.perf_counter() - t0
        hold_outputs(f"{label}, hooked vs not", compare, prefix,
                     os.path.join(work, f"profile_{key}_off"), model, byte_identical=True,
                     phase="17")
        traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"phase 17 {label}: {len(traces)} traces, not one")
        summary = trace_summary(traces[0])
        if summary["device_events"] == 0:
            raise AssertionError(f"phase 17 {label}: the trace holds no CUDA activity")
        em_in_trace = [n for n in summary["kernel_names"] if any(s in n for s in EM_SYMBOLS)]
        if key == "staged" and not em_in_trace:
            raise AssertionError(f"phase 17 {label}: the ragged EM kernel is not in the trace: "
                                 f"{summary['kernel_names']}")
        overhead = walls[True] - walls[False]
        log(
            f"phase 17: {label} under RPVG_TPU_TORCH_PROFILE: trace {summary['size_mib']:.1f} MiB "
            f"({summary['host_events']} host and {summary['device_events']} device events, "
            f"parsed in {summary['parse_s']:.2f}s); window {summary['window_ms']:.1f} ms, card "
            f"busy {summary['busy_ms']:.2f} ms = busy share {summary['busy_share']:.4f} (union of "
            f"kernels, copies and sets over all streams); wall {walls[True]:.2f}s hooked vs "
            f"{walls[False]:.2f}s not (hook cost {overhead:+.2f}s, "
            f"{overhead / walls[False]:+.1%}); the EM kernels in the trace: {em_in_trace}"
        )
        log(f"phase 17: {label}, top device operations: " + "; ".join(
            f"{op['name'][:80]} ({op['cat']}) {op['ms']:.3f} ms x {op['count']}"
            for op in summary["top"]))
        log(f"phase 17: {label}, longest idle gaps: " + "; ".join(
            f"{gap['ms']:.2f} ms at +{gap['at_ms']:.2f} ms, host "
            + (f"{gap['host'][:60]} ({gap['host_overlap_ms']:.2f} ms of it)" if gap["host"]
               else "no torch op or CUDA call (numpy or C++ host code)")
            for gap in summary["gaps"]))


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

    from rpvg_tpu_torch import alignments, cli, compare, native, sim
    from rpvg_tpu_torch.compare import check_estimate_file, compare_estimate_files
    from rpvg_tpu_torch.io import rpa
    from rpvg_tpu_torch.ops import (
        build, em_cuda, em_fused_cuda, gibbs_cuda, group_scores_cuda, posterior_gibbs_cuda,
        posterior_gibbs_k_cuda,
    )
    from rpvg_tpu_torch.testing import shard_counts

    t0 = time.perf_counter()
    if native.load_library() is None:
        raise RuntimeError("the native host library did not build")
    log(f"phase 0: native host library ready in {time.perf_counter() - t0:.1f}s")

    # Phase 1: build all six kernels from the checkout's sources, one nvcc
    # each, and beside them a one-log probe whose SASS counts the FP64
    # instructions of a log (the group-score and k-slot bounds).
    names = (em_cuda.KERNEL_NAME, em_fused_cuda.KERNEL_NAME, gibbs_cuda.KERNEL_NAME,
             posterior_gibbs_cuda.KERNEL_NAME, group_scores_cuda.KERNEL_NAME,
             posterior_gibbs_k_cuda.KERNEL_NAME)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool, \
            tempfile.TemporaryDirectory(prefix="rpvg_probe_") as probe_dir:
        probe = pool.submit(fp64_log_instructions, probe_dir)
        table_probe = pool.submit(fp64_log_instructions, probe_dir, TABLE_LOG_PROBE)
        builds = list(pool.map(lambda name: build.build_library(name, force=True), names))
        per_log, log_ops = probe.result()
        table_per_log, table_log_ops = table_probe.result()
    build_s = time.perf_counter() - t0
    for name, (lib_path, ptxas) in zip(names, builds):
        ptxas_lines = [ln.strip() for ln in ptxas.splitlines() if ln.strip()]
        log(
            f"phase 1: built {os.path.relpath(lib_path)} from "
            f"{os.path.relpath(build.source_path(name))} with nvcc "
            f"{' '.join(build.NVCC_FLAGS)} ({len(names)} builds in parallel, "
            f"{build_s:.1f}s); ptxas: " + " | ".join(ptxas_lines)
        )
    log(f"phase 1: one float64 log is {per_log} FP64 instructions in the SASS of a one-log "
        f"kernel built for sm_90a ({log_ops}); the group scorer's own log (csrc/log_f64.cuh) "
        f"{table_per_log} ({table_log_ops})")

    # Phase 2: ragged kernel vs plain version.
    em = phase_kernel(torch, device)

    threads = min(8, os.cpu_count() or 1)
    with tempfile.TemporaryDirectory(prefix="rpvg_smoke_") as work:
        # Phase 3: every model and configuration agrees with itself across
        # devices.
        small = write_dataset(sim, rpa, alignments, work,
                              num_genes=60, num_pairs=5000, seed_panel=23, seed_reads=29)
        datasets = {
            "small": small,
            "qual": write_dataset(sim, rpa, alignments, work, num_genes=60, num_pairs=5000,
                                  seed_panel=23, seed_reads=31, with_errors=True, tag="qual_"),
            "single_end": write_single_end_dataset(sim, work, num_genes=60, num_reads=5000,
                                                   seed_panel=23, seed_reads=37),
            "long_reads": write_single_end_dataset(sim, work, num_genes=60, num_reads=2000,
                                                   seed_panel=23, seed_reads=41,
                                                   read_length=400, tag="lr_"),
            "three_isoforms": write_dataset(sim, rpa, alignments, work, num_genes=60,
                                            num_pairs=5000, seed_panel=23, seed_reads=29,
                                            tag="iso3_", isoforms=3),
        }
        phase_cli_configs(cli, compare_estimate_files, datasets, work, threads)
        phase_gibbs_cli(cli, compare, small, work, threads)

        # Phase 4: the main path at bench scale.
        t0 = time.perf_counter()
        bench = write_dataset(sim, rpa, alignments, work,
                              num_genes=1286, num_pairs=PAIRS, seed_panel=5, seed_reads=17,
                              tag="bench_")
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
            main_stats, counts = bench_run(torch, device, cli, check_estimate_file, 4, bench,
                                           os.path.join(work, "bench"), threads,
                                           "haplotype-transcripts", info=True)
        finally:
            em_cuda.em_fixed_point = launch
        main_counts = counts
        ragged_launches = main_path_launches = counts["em.ragged.launches"]
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
                fused_launches = counts["em.padded.launches"]
                fused_route_tasks = counts["em.padded.tasks"]
            else:
                ragged_launches += counts["em.ragged.launches"]
        rep = compare_estimate_files(
            prefixes[("transcripts", True)] + ".txt", prefixes[("transcripts", False)] + ".txt",
            RTOL, ATOL_OUT,
        )
        log(f"phase 6: transcripts -f, multi-bucket vs ragged route: rows identical, "
            f"{rep['rows']} rows, max abs {rep['max_abs_diff']:.3e}, max rel "
            f"{rep['max_rel_diff']:.3e}, byte-identical {rep['byte_identical']}")

        # Phase 9 (before 7 and 8, which re-time the samplers on what it
        # captures): the Gibbs configurations at full width.
        gibbs_captured, posterior_captured = [], []
        sample, sample_posterior = gibbs_cuda.gibbs_read_counts, posterior_gibbs_cuda.posterior_gibbs

        def capture_gibbs(jobs, thin_its, gamma):
            gibbs_captured.append((jobs, thin_its, gamma))
            return sample(jobs, thin_its, gamma)

        def capture_posterior(jobs):
            posterior_captured.append(jobs)
            return sample_posterior(jobs)

        runs = {}
        for key, model, info, extra in (
            ("main", "haplotype-transcripts", True, ("-n", "100")),
            ("transcripts", "transcripts", True, ("-n", "100")),
            ("strains", "strains", False, ("-n", "100")),
            ("haplotypes", "haplotypes", False, ("--use-hap-gibbs",)),
        ):
            gibbs_cuda.gibbs_read_counts = capture_gibbs if key == "main" else sample
            posterior_gibbs_cuda.posterior_gibbs = (
                capture_posterior if key == "haplotypes" else sample_posterior
            )
            try:
                runs[key] = bench_run(torch, device, cli, check_estimate_file, 9, bench,
                                      os.path.join(work, f"gibbs_{key}"), threads, model, info,
                                      extra=extra)
            finally:
                gibbs_cuda.gibbs_read_counts = sample
                posterior_gibbs_cuda.posterior_gibbs = sample_posterior
        t0 = time.perf_counter()
        rc, cpu_stats = cli.run_cli(
            cli_argv(bench, os.path.join(work, "gibbs_main_cpu"), "cpu", threads) + ["-n", "100"]
        )
        cpu_wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"-n 100 main path on cpu exited {rc}")
        log(
            f"phase 9: haplotype-transcripts -f -n 100 on cpu (native samplers): {PAIRS} pairs in "
            f"{cpu_wall:.2f}s wall; phases "
            + ", ".join(f"{k} {v:.3f}s" for k, v in cpu_stats["phase_seconds"].items())
            + f", outputs {cpu_stats['output_seconds']:.2f}s; {cpu_stats['gibbs_jobs']} Gibbs "
            f"jobs; _gibbs.txt.gz writer {gibbs_writer_seconds(cpu_stats)}"
        )
        rep = compare_estimate_files(os.path.join(work, "gibbs_main.txt"),
                                     os.path.join(work, "gibbs_main_cpu.txt"), RTOL, ATOL_OUT)
        gibbs_rep = hold_gibbs_rows(compare, os.path.join(work, "gibbs_main_gibbs.txt.gz"),
                                    os.path.join(work, "gibbs_main_cpu_gibbs.txt.gz"))
        log(f"phase 9: -n 100 main path, cuda vs cpu: .txt {rep['rows']} rows within rtol {RTOL}; "
            + gibbs_rows_text(gibbs_rep))
        if not gibbs_rep["ok"]:
            raise AssertionError("-n 100 main path: Gibbs samples differ across devices")
        gibbs_launches = runs["main"][1]["gibbs.readcount.launches"]
        posterior_launches = runs["haplotypes"][1]["gibbs.pair.launches"]

        # Phase 10: ploidy 3 at full width on phase 4's dataset.
        scores_captured, over_captured, k_captured, group_launches, k_launches = phase_full_width_ploidy(
            torch, device, cli, check_estimate_file, bench, work, threads
        )

        # Phase 13: --ind-hap-inference at full width; phase 14: the main
        # path with --multiprocess 4.
        _, ind_counts, ind_em = phase_independent(
            torch, device, cli, check_estimate_file, bench, work, threads
        )
        phase_multiprocess(bench, work, threads, main_stats, os.path.join(work, "bench"))

        # Phase 15: the shard logic on virtual shards of the card.
        virtual = phase_virtual_shards(torch, device, cli, compare, datasets, bench, work,
                                       threads, main_stats, main_counts)

        # Phase 16: the JAX package's fused native routes and their legs.
        fused_routes = phase_fused_routes(
            torch, device, cli, compare, check_estimate_file, bench, work, threads,
            {"transcripts": os.path.join(work, "bench_transcripts"),
             "strains": os.path.join(work, "bench_strains"),
             "strains_n": os.path.join(work, "gibbs_strains")},
        )

        # Phase 17: the profiler hook on the main path and the fused route.
        phase_profile(torch, device, cli, compare, check_estimate_file, bench, work, threads)

    # Phases 7 and 8: the two Gibbs samplers; 11 and 12: the ploidy-k kernels.
    gibbs = phase_gibbs_kernel(torch, device, gibbs_captured)
    posterior = phase_posterior_kernel(torch, device, posterior_captured)
    scores = phase_group_scores_kernel(torch, device, scores_captured, over_captured, per_log,
                                       table_per_log)
    k_slot = phase_posterior_k_kernel(torch, device, k_captured, per_log)


    kernels = [
        {
            "name": em_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/em_fixed_point.cu",
            "replaces": "rpvg_tpu/ops/em_pallas.py:46",
            "launches": main_path_launches,
            "max_abs_err": max(em["max_abs_err"], main_em["max_abs_err"],
                               fused_routes["a"]["max_abs_err"]),
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
            "virtual_shards": VIRTUAL_SHARDS,
            "virtual_shards_main_path_launches": virtual["main_counts"]["em.ragged.launches"],
            "virtual_shards_main_path_tasks_per_shard": shard_counts(virtual["main_counts"],
                                                                     "em_tasks"),
            **{f"fused_route_escalated_{key}": fused_routes["a"][key] for key in (
                "launches", "tasks", "area", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "slowest_task_ms")},
        },
        {
            "name": em_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/em_fixed_point.cu",
            "replaces": "rpvg_tpu/ops/em_pallas.py:46",
            "launches": ind_counts["em.ragged.launches"],
            "max_abs_err": ind_em["max_abs_err"],
            "ms": ind_em["ms"],
            "plain_ms": ind_em["plain_ms"],
            "bound_ms": ind_em["bound_ms"],
            "bound_by": ind_em["bound_by"],
            "library_ms": None,
            "main_path_run": "haplotype-transcripts -f --ind-hap-inference",
            "tasks": ind_em["tasks"],
            "sample_tasks": ind_em.get("sample_tasks"),
            "all_tasks_ms": ind_em.get("all_tasks_ms"),
            "all_tasks_bound_ms": ind_em.get("all_tasks_bound_ms"),
            "slowest_task_ms": ind_em["slowest_task_ms"],
        },
        {
            "name": em_fused_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/em_fused.cu",
            "replaces": "rpvg_tpu/ops/em_pallas.py:182",
            "launches": fused_launches,
            "max_abs_err": max(fused_em["max_abs_err"], fused_routes["c"]["max_abs_err"]),
            "ms": fused_em["ms"],
            "plain_ms": fused_em["plain_ms"],
            "bound_ms": fused_em["bound_ms"],
            "bound_by": fused_em["bound_by"],
            "library_ms": None,
            "launches_per_main_path_run": fused_launches,
            "main_path_run": f"transcripts -f, RPVG_TPU_FUSE_EM=1 ({fused_route_tasks} tasks)",
            "slowest_task_ms": fused_em["slowest_task_ms"],
            "sharded_em_step_max_abs_err": virtual["em_step_err"],
            "sharded_em_step_ms": virtual["em_step_ms"],
            **{f"fused_route_slots_{key}": fused_routes["c"][key] for key in (
                "routed_slots", "routed_tasks", "launches", "tasks", "clusters", "ms",
                "plain_ms", "bound_ms", "bound_by", "max_abs_err", "dispatch_s",
                "gather_wait_s")},
        },
        {
            "name": gibbs_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/gibbs_readcount.cu",
            "replaces": "rpvg_tpu/infer/readcount_gibbs.py:79",
            "launches": gibbs_launches,
            "max_abs_err": gibbs["max_abs_err"],
            "ms": gibbs["ms"],
            "plain_ms": gibbs["plain_ms"],
            "bound_ms": gibbs["bound_ms"],
            "bound_by": gibbs["bound_by"],
            "library_ms": None,
            "launches_per_main_path_run": gibbs_launches,
            "main_path_run": "haplotype-transcripts -f -n 100",
            "diverged_jobs": gibbs["diverged_jobs"],
            "main_path_jobs": gibbs["main_path_jobs"],
            "main_path_diverged_jobs": gibbs["main_path_diverged_jobs"],
            "main_path_jobs_ms": gibbs["main_path_jobs_ms"],
            "main_path_jobs_bound_ms": gibbs["main_path_jobs_bound_ms"],
            "main_path_slowest_job_ms": gibbs["main_path_slowest_job_ms"],
            "main_path_slowest_job_cycles_per_iteration":
                gibbs["main_path_slowest_job_cycles_per_iteration"],
            "iteration_minimum_us": gibbs["iteration_minimum_us"],
            "main_path_slowest_job_floor_ms": gibbs["main_path_slowest_job_floor_ms"],
            "fused_route_launches": fused_routes["d"]["launches"],
            "fused_route_jobs": fused_routes["d"]["jobs"],
            "fused_strains_launches": fused_routes["e"]["launches"],
            "fused_strains_jobs": fused_routes["e"]["jobs"],
        },
        {
            "name": posterior_gibbs_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/gibbs_posterior.cu",
            "replaces": "rpvg_tpu/infer/posteriors.py:661",
            "launches": posterior_launches,
            "max_abs_err": posterior["max_abs_err"],
            "ms": posterior["ms"],
            "plain_ms": posterior["plain_ms"],
            "bound_ms": posterior["bound_ms"],
            "bound_by": posterior["bound_by"],
            "library_ms": None,
            "launches_per_main_path_run": posterior_launches,
            "main_path_run": "haplotypes --use-hap-gibbs",
            "diverged_clusters": posterior["diverged_clusters"],
            "main_path_clusters": posterior["main_path_clusters"],
            "main_path_diverged_clusters": posterior["main_path_diverged_clusters"],
            "main_path_clusters_ms": posterior["main_path_clusters_ms"],
            "main_path_clusters_bound_ms": posterior["main_path_clusters_bound_ms"],
            "step_minimum_us": posterior["step_minimum_us"],
            "main_path_slowest_cluster_floor_ms": posterior["main_path_slowest_cluster_floor_ms"],
        },
        {
            "name": group_scores_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/group_scores.cu",
            "replaces": "rpvg_tpu/infer/posteriors.py:901",
            "launches": group_launches,
            "max_abs_err": scores["max_abs_err"],
            "ms": scores["ms"],
            "plain_ms": scores["plain_ms"],
            "bound_ms": scores["bound_ms"],
            "bound_by": scores["bound_by"],
            "library_ms": None,
            "launches_per_main_path_run": group_launches,
            "main_path_run": "haplotypes -y 3",
            "fp64_instructions_per_log": table_per_log,
            "fp64_instructions_per_libdevice_log": per_log,
            "bound_rg_ms": scores["bound_rg_ms"],
            "blocks_per_sm": scores["blocks_per_sm"],
            "main_path_clusters": scores["haplotypes_clusters"],
            "main_path_clusters_ms": scores["haplotypes_ms"],
            **{f"main_path_clusters_{key}": scores[f"haplotypes_{key}"] for key in (
                "bound_ms", "bound_rg_ms", "logs", "logs_rg", "lanes_busy", "zero_share")},
            "nested_run_clusters_ms": scores["haplotype-transcripts_ms"],
            "over_limit_clusters": scores["over_limit_clusters"],
            "over_limit_clusters_ms": scores["over_limit_ms"],
            "over_limit_clusters_plain_ms": scores["over_limit_plain_ms"],
            "over_limit_clusters_bound_ms": scores["over_limit_bound_ms"],
        },
        {
            "name": posterior_gibbs_k_cuda.KERNEL_NAME,
            "route": "cuda",
            "source": "rpvg_tpu_torch/csrc/gibbs_posterior_k.cu",
            "replaces": "rpvg_tpu/infer/posteriors.py:661",
            "launches": k_launches,
            "max_abs_err": k_slot["max_abs_err"],
            "ms": k_slot["ms"],
            "plain_ms": k_slot["plain_ms"],
            "bound_ms": k_slot["bound_ms"],
            "bound_by": k_slot["bound_by"],
            "library_ms": None,
            "launches_per_main_path_run": k_launches,
            "main_path_run": "haplotypes -y 3 --use-hap-gibbs",
            "diverged_clusters": {k: v for k, v in k_slot.items() if k.startswith("diverged")},
            "main_path_clusters": k_slot["main_path_clusters"],
            "main_path_diverged_clusters": k_slot["main_path_diverged_clusters"],
            "main_path_clusters_ms": k_slot["main_path_clusters_ms"],
            "main_path_clusters_bound_ms": k_slot["main_path_clusters_bound_ms"],
            **{key: k_slot[f"main_path_{key}"] for key in (
                "zero_share", "tile_share", "logs", "logs_per_entry", "slowest_chain_ms",
                "slowest_chain_shape", "slowest_chain_cycles_per_slot_step",
                "slowest_chain_floor_ms")},
            "slot_step_minimum_us": k_slot["slot_step_minimum_us"],
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
