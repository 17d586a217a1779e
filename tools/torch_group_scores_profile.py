#!/usr/bin/env python3
"""Where the multiset group scorer (rpvg_tpu_torch/csrc/group_scores.cu)
and the ploidy-2 pair Gibbs sampler (rpvg_tpu_torch/csrc/gibbs_posterior.cu)
of the PyTorch port spend their time on one NVIDIA GPU.

Run from the repository root, on a machine with CUDA and nvcc:

    python3 tools/torch_group_scores_profile.py [--repo DIR]

``--repo`` profiles the package and kernels of another checkout (for
example an earlier commit unpacked with ``git archive``) with this
script, so two versions are measured the same way in one session.  Only
the kernels' public entry points are called.

It synthesises chip_smoke.py's 100k-pair dataset, runs the port's
`haplotypes -y 3` and `haplotypes --use-hap-gibbs` on the card, captures
what phase B hands the group scorer, the host enumeration engine (the
clusters over the enumeration limit) and the pair sampler, then prints:

1. the group scorer's clusters: the share of zero probabilities, the
   logs of one per (row, group) (R x G) and of the factored design
   (R x P for the last slot's logs, plus for every group the rows U where
   a path of its first k - 1 slots has a nonzero probability, or the
   noise is not positive), the share of U, and the share of a warp's
   lanes busy when a warp scores 32 consecutive groups and walks the
   union of its lanes' rows word by word;
2. the group scorer on those clusters, on chip_smoke.py's 256 seeded
   clusters at k = 3 and on the clusters the host engine took (CUDA
   events), against the plain version on the last, and the SM cycles per
   (row, group) (milliseconds x SM clock x SMs over R x G);
3. the pair sampler on the `--use-hap-gibbs` run's clusters and on
   chip_smoke.py's 257 seeded clusters; its slowest cluster (most chain
   steps, then most paths) alone, and with no steps (the CDFs and the
   start only); cycles per chain step, that difference over the steps;
   the time of a step with no work (a one-path cluster's one chain at
   two lengths) and the slowest cluster's dependent-chain floor, its
   steps times that time.

The cycles are at the card's maximum SM clock (nvidia-smi
clocks.max.sm).  Build outputs go to rpvg_tpu_torch/build/ of the
profiled checkout (git-ignored).
"""

import argparse
import os
import subprocess
import sys
import tempfile
from itertools import combinations_with_replacement

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def popcount(words: np.ndarray) -> np.ndarray:
    """Set bits of every uint32 of ``words``, same shape."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return _POP8[words.view(np.uint8)].reshape(words.shape + (4,)).sum(axis=-1)


def row_words(mask: np.ndarray) -> np.ndarray:
    """(..., R) bool as (..., ceil(R / 32)) uint32, row r at bit r % 32 of
    word r // 32."""
    R = mask.shape[-1]
    W = -(-R // 32)
    padded = np.zeros(mask.shape[:-1] + (W * 32,), dtype=np.uint64)
    padded[..., :R] = mask
    bits = padded.reshape(mask.shape[:-1] + (W, 32)) << np.arange(32, dtype=np.uint64)
    return bits.sum(axis=-1).astype(np.uint32)


def factored_rows(probs, noise, counts, k):
    """Per group of ``combinations_with_replacement(range(P), k)``, in its
    order, the words of the rows U that the factored design scores with a
    log of its own: rows of non-positive noise, and rows of nonzero count
    where a path of the group's first k - 1 slots has a nonzero
    probability.  Returns (G, ceil(R / 32)) uint32."""
    R, P = probs.shape
    bad = ~(noise > 0)
    live = (probs != 0) & ((counts != 0) | bad)[:, None]
    nz = row_words(live.T)                       # (P, W)
    bad_words = row_words(bad)                   # (W,)
    if k == 1:
        return np.broadcast_to(bad_words, (P, bad_words.size))
    prefixes = np.asarray(list(combinations_with_replacement(range(P), k - 1)), dtype=np.int64)
    words = np.bitwise_or.reduce(nz[prefixes], axis=1) | bad_words
    return np.repeat(words, P - prefixes[:, -1], axis=0)


def factored_logs(clusters, k):
    """(R x G logs, factored logs R x P + sum |U|, lane-busy share of a
    warp of 32 consecutive groups walking the union of its lanes' rows
    word by word) over ``clusters`` of (probs (R, P), noise (R,), counts
    (R,))."""
    dense = factored = busy = walked = 0
    for probs, noise, counts in clusters:
        R, P = probs.shape
        per_word = popcount(factored_rows(probs, noise, counts, k))
        G = per_word.shape[0]
        dense += R * G
        factored += R * P + int(per_word.sum())
        padded = np.zeros((-(-G // 32) * 32, per_word.shape[1]), dtype=np.int64)
        padded[:G] = per_word
        busy += int(per_word.sum())
        walked += 32 * int(padded.reshape(-1, 32, per_word.shape[1]).max(axis=1).sum())
    return dense, factored, busy / max(walked, 1)


def zero_share(clusters):
    cells = sum(p.size for p, _, _ in clusters)
    return sum(int((p == 0).sum()) for p, _, _ in clusters) / max(cells, 1)


def card_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split()
    return float(out[0]) if out else float("nan")


def host_inputs(packed):
    """(probs, noise, counts) per cluster of captured GroupClusters."""
    h = packed.host
    probs, noise, counts = (t.cpu().numpy() for t in (packed.probs, packed.noise, packed.counts))
    out = []
    for c in range(packed.n_clusters):
        R, P = int(h["n_rows"][c]), int(h["n_cols"][c])
        m0, r0 = int(h["mat_offsets"][c]), int(h["row_offsets"][c])
        out.append((probs[m0:m0 + R * P].reshape(R, P), noise[r0:r0 + R], counts[r0:r0 + R]))
    return out


def group_section(torch, cs, device, packed, over, clock, sms):
    """Sections 1 and 2 of the module docstring."""
    from rpvg_tpu_torch.ops import group_scores_cuda
    from rpvg_tpu_torch.testing import enumeration_cluster_set

    k = packed.group_size
    inputs = host_inputs(packed)
    dense, factored, busy = factored_logs(inputs, k)
    over_dense, over_factored, over_busy = factored_logs(over, k)
    print(f"group scorer, -y 3 run: {packed.n_clusters} clusters (P median "
          f"{int(np.median(packed.host['n_cols']))} max {int(packed.host['n_cols'].max())}, "
          f"{int(packed.host['out_offsets'][-1])} groups); zero probabilities "
          f"{zero_share(inputs):.4f}; logs R x G {dense}, factored {factored} (share "
          f"{factored / dense:.4f}); warp lanes busy {busy:.4f}")
    print(f"group scorer, the {len(over)} clusters on the host engine (P "
          f"{sorted(p.shape[1] for p, _, _ in over)}, R {sorted(p.shape[0] for p, _, _ in over)}): "
          f"zero probabilities {zero_share(over):.4f}; logs R x G {over_dense}, factored "
          f"{over_factored} (share {over_factored / max(over_dense, 1):.4f}); warp lanes busy "
          f"{over_busy:.4f}")

    def timed(label, clusters, rg):
        ms = cs.cuda_ms(lambda: group_scores_cuda.group_scores(clusters), reps=5)
        cycles = ms * 1e-3 * clock * 1e6 * sms / max(rg, 1)
        print(f"group scorer, {label}: {ms:.4f} ms (CUDA events), {cycles:.2f} SM cycles per "
              f"(row, group)")
        return ms

    timed(f"the -y 3 run's {packed.n_clusters} clusters", packed, dense)
    seeded = group_scores_cuda.make_clusters(
        [c[:3] for c in enumeration_cluster_set(256, seed=83, group_size=3)], 3, device)
    timed("chip_smoke.py's 256 seeded clusters at k = 3", seeded,
          factored_logs(host_inputs(seeded), 3)[0])
    if over:
        big = group_scores_cuda.make_clusters(over, k, device)
        timed(f"the {len(over)} host-engine clusters", big, over_dense)
        kernel = group_scores_cuda.group_scores(big).cpu().numpy()
        plain, plain_ms = cs.timed_once(lambda: group_scores_cuda.group_scores_ragged_plain(big))
        max_abs, max_rel, bad = cs.compare_scores(kernel, plain.cpu().numpy())
        print(f"group scorer, the host-engine clusters against the plain version: max abs "
              f"{max_abs:.3e} max rel {max_rel:.3e}, {bad} out of rtol 1e-10 or -inf; plain "
              f"{plain_ms:.1f} ms")


def pair_section(torch, cs, device, jobs, clock):
    """Section 3 of the module docstring."""
    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.ops import posterior_gibbs_cuda as pg
    from rpvg_tpu_torch.testing import posterior_cluster_set, posterior_wide_cluster

    h = jobs.host
    steps = h["n_burn"] + h["n_its"]
    slow = int(np.lexsort((h["n_cols"], steps))[-1])
    P = int(h["n_cols"][slow])
    all_ms = cs.cuda_ms(lambda: pg.posterior_gibbs(jobs), reps=5)
    print(f"pair sampler, the --use-hap-gibbs run's {jobs.n_clusters} clusters (P median "
          f"{int(np.median(h['n_cols']))} max {int(h['n_cols'].max())}, "
          f"{int(h['n_chains'].sum())} chains): {all_ms:.4f} ms (CUDA events)")
    clusters = posterior_cluster_set(256, seed=71, max_paths=120) + [posterior_wide_cluster(200, 73)]
    keys = prng.split(prng.prng_key(72), len(clusters))
    seeded = posteriors.posterior_gibbs_jobs(clusters, keys, device)
    print(f"pair sampler, chip_smoke.py's {seeded.n_clusters} seeded clusters: "
          f"{cs.cuda_ms(lambda: pg.posterior_gibbs(seeded), reps=5):.4f} ms")

    def alone(sizing, b=slow):
        return pg.make_jobs(jobs.scores, h["score_offsets"][b:b + 1], h["strides"][b:b + 1],
                            h["n_cols"][b:b + 1], [sizing],
                            [int(jobs.seeds[b].item()) & 0xFFFFFFFFFFFFFFFF])

    chains, burn, its = (int(h[name][slow]) for name in ("n_chains", "n_burn", "n_its"))
    full, start = alone((chains, burn, its)), alone((chains, 0, 0))
    full_ms = cs.cuda_ms(lambda: pg.posterior_gibbs(full), reps=10)
    start_ms = cs.cuda_ms(lambda: pg.posterior_gibbs(start), reps=10)
    per_step = (full_ms - start_ms) / (burn + its)
    print(f"pair sampler, its slowest cluster (P {P}, {chains} chains of {burn} + {its} steps) "
          f"alone {full_ms:.4f} ms, with no steps {start_ms:.4f} ms: {per_step * 1e3:.3f} us = "
          f"{per_step * 1e-3 * clock * 1e6:.0f} cycles per chain step")
    one = torch.zeros(1, dtype=torch.float64, device=device)

    def tiny(n):
        small = pg.make_jobs(one, [0], [1], [1], [(1, n // 2, n - n // 2)], [1])
        return cs.cuda_ms(lambda: pg.posterior_gibbs(small), reps=10)

    minimum = (tiny(4000) - tiny(2000)) / 2000
    print(f"pair sampler, a step with no work (P = 1, one chain, 4,000 less 2,000 steps) "
          f"{minimum * 1e3:.4f} us = {minimum * 1e-3 * clock * 1e6:.0f} cycles; the slowest "
          f"cluster's dependent-chain floor {burn + its} x {minimum * 1e3:.4f} us = "
          f"{(burn + its) * minimum:.5f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO, help="checkout whose package and kernels to profile")
    args = parser.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import torch

    import chip_smoke as cs
    from rpvg_tpu_torch import alignments, cli, sim
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.io import rpa
    from rpvg_tpu_torch.ops import build, group_scores_cuda, posterior_gibbs_cuda

    if not torch.cuda.is_available():
        print("torch_group_scores_profile: CUDA is required", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"profiling the package at {repo}")
    device = torch.device("cuda", 0)
    for module in (group_scores_cuda, posterior_gibbs_cuda):
        _, ptxas = build.build_library(module.KERNEL_NAME, force=True)
        print(f"{module.KERNEL_NAME}: ptxas " + " | ".join(
            ln.strip() for ln in ptxas.splitlines() if ln.strip()))
    clock = card_clock_mhz()
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    scored, over, pairs = [], [], []
    score, host_engine = group_scores_cuda.group_scores, posteriors.path_group_posteriors_full
    sample = posterior_gibbs_cuda.posterior_gibbs

    def capture_scores(clusters):
        scored.append(clusters)
        return score(clusters)

    def capture_over(probs, noise, counts, path_counts, group_size):
        over.append((probs, noise, counts))
        return host_engine(probs, noise, counts, path_counts, group_size)

    def capture_pairs(jobs):
        pairs.append(jobs)
        return sample(jobs)

    with tempfile.TemporaryDirectory(prefix="rpvg_group_profile_") as work:
        bench = cs.write_dataset(sim, rpa, alignments, work, num_genes=1286,
                                 num_pairs=cs.PAIRS, seed_panel=5, seed_reads=17)
        group_scores_cuda.group_scores = capture_scores
        posteriors.path_group_posteriors_full = capture_over
        posterior_gibbs_cuda.posterior_gibbs = capture_pairs
        try:
            for extra in (("-y", "3"), ("--use-hap-gibbs",)):
                rc, stats = cli.run_cli(cs.cli_argv(bench, os.path.join(work, "run"), "cuda", 8,
                                                    "haplotypes", False) + list(extra))
                if rc != 0:
                    raise RuntimeError(f"haplotypes {' '.join(extra)} exited {rc}")
                print(f"haplotypes {' '.join(extra)}: phase B {stats['phase_seconds']['B']:.3f}s")
        finally:
            group_scores_cuda.group_scores = score
            posteriors.path_group_posteriors_full = host_engine
            posterior_gibbs_cuda.posterior_gibbs = sample
    group_section(torch, cs, device, scored[0], over, clock, sms)
    pair_section(torch, cs, device, pairs[0], clock)
    return 0


if __name__ == "__main__":
    sys.exit(main())
