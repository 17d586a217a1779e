#!/usr/bin/env python3
"""Where the two hand-written Gibbs samplers of the PyTorch port spend
their time on one NVIDIA GPU: the read-count sampler
(rpvg_tpu_torch/csrc/gibbs_readcount.cu) and the k-slot posterior sampler
(rpvg_tpu_torch/csrc/gibbs_posterior_k.cu).

Run from the repository root, on a machine with CUDA and nvcc:

    python3 tools/torch_gibbs_profile.py [--repo DIR]

``--repo`` profiles the package and kernels of another checkout (for
example an earlier commit unpacked with ``git archive``) with this
script, so two versions are measured the same way in one session.  Only
the samplers' public entry points are called.

It synthesises chip_smoke.py's 100k-pair dataset, runs the port's
`haplotype-transcripts -f -n 100`, `haplotypes --use-hap-gibbs` and
`haplotypes -y 3 --use-hap-gibbs` on the card, captures what phase D2
hands the read-count sampler and what phase B hands the two posterior
samplers, then prints:

1. the read counts of the heaviest D2 jobs' rows;
2. the read-count kernel on those jobs, on their slowest job alone and on
   chip_smoke.py's 261 seeded jobs, with teams capped at 256 and at 512
   threads (in the order 256, 512, 512, 256; CUDA events), and whether
   every output is bitwise the same across team sizes;
3. a copy of the read-count kernel with clock64() read by thread 0 at
   the marks of an iteration, run on the slowest job: cycles per
   iteration between marks (a kernel without marks gets one after each
   block barrier of its iteration loop), the same with the Gamma step
   drawn twice (a draw at another counter first: the second finds the
   step's code and data at hand), and the per-iteration minimum: the
   time of a 1 x 1 job at 2,000 iterations less at 1,000, over 1,000;
4. cycles per call of the kernels' primitives (Philox, the math library,
   Gamma and binomial draws, and the CDF steps the kernel source has),
   one thread chaining 2,000 calls each, and a Gamma draw of every lane
   of a warp at once with equal and with mixed counts (the lanes of the
   kernel's Gamma step draw mixed counts);
5. both read-count and k = 2 posterior kernels built with -fmad=false and
   with nvcc's default (the port's build), in the order false, true,
   true, false: times and how far the outputs lie apart;
6. the k-slot sampler on the `-y 3 --use-hap-gibbs` run's clusters: the
   share of zero probabilities and of (32-path, row) tiles that hold a
   nonzero, the logs per slot step R x P and R + nonzeros; the time of
   all clusters, of the largest-work cluster alone and of one of its
   chains alone, and on chip_smoke.py's 65 seeded clusters at k = 3; a
   clock64 copy run on that one chain (cycles per slot step between
   marks, as in 3) and the per-slot-step minimum (a 1-row, 1-path
   cluster's chain at two lengths); the slowest chain's dependent-chain
   floor, its slot steps times that minimum.

Build outputs go to rpvg_tpu_torch/build/ of the profiled checkout
(git-ignored).
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The per-thread primitives, one thread chaining n calls of each; the CDF
# steps are compiled in only where the kernel source defines them.
MICRO = r'''
#include "gibbs_readcount.cu"
#include <cstdio>

__global__ void micro(long long* out, double* sink, int n) {
  __shared__ double row[64];
  __shared__ double fr[64];
  __shared__ double cdf[64];
  for (int c = threadIdx.x; c < 64; c += blockDim.x) {
    row[c] = 0.01 + 0.001 * c; fr[c] = 1.0 / 64; cdf[c] = 0.001 * (c + 1);
  }
  __syncthreads();
  if (threadIdx.x) return;
  double x = 0.3, y = 0.0;
  uint32_t w = 1;
  long long t[16];
  int k = 0;
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) { philox::Words ws = philox::philox4x32_10(i, w, 3, 4, 5, 6); w ^= ws.w0 + ws.w3; }
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) { philox::Uniforms u = philox::draw(w, i, 1, 2, 3); x += u.u0; w += (uint32_t)(u.u1 * 4.0); }
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) x = log(x + 1.5);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) x = cos(6.283185307179586 * (x + 0.7));
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) x = cospi(2.0 * (x * 0.1 + 0.7));
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) x = sqrt(x + 1.1);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) x = 1.0 / (x + 1.3);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) x = exp(-x);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) y += gibbs_rc::gamma_draw(50.0 + (x > 2.0), 1.0, 77 + i, i, 3);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) y += gibbs_rc::gamma_draw(2.0 + (x > 2.0), 1.0, 77 + i, i, 3);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) y += lgamma(y * 1e-9 + 30.5 + i % 5);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) y += (double)gibbs_rc::binomial(40 + (x > 5.0), 0.1, 77 + i, i, 2, 3);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) y += (double)gibbs_rc::binomial(600, 0.3, 77 + i, i, 2, 3);
  t[k++] = clock64();
#ifdef HAS_ROW_CDF
  for (int i = 0; i < n; ++i) { gibbs_rc::row_cdf(row, fr, 61 + (x > 5.0), 1, cdf); y += cdf[60]; }
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) y += (double)gibbs_rc::upper_bound(cdf, 1, 61, 0.0001 + (x > 5.0 ? 1.0 : 0.5) * (i % 7) * 0.008);
  t[k++] = clock64();
#endif
#ifdef HAS_WALK
  for (int i = 0; i < n; ++i) y += (double)gibbs_rc::walk(row, fr, 61, 0.0001 + (x > 5.0 ? 1.0 : 0.5) * (i % 7) * 0.05);
  t[k++] = clock64();
  for (int i = 0; i < n; ++i) y += gibbs_rc::row_mass(row, fr, 61 + (x > 5.0));
  t[k++] = clock64();
#endif
  for (int j = 0; j + 1 < k; ++j) out[j] = (t[j + 1] - t[j]) / n;
  out[15] = k - 1;
  *sink = x + y + w;
}

// Gamma draws of a whole warp, lane l drawing column l: every lane's count
// 50, every lane's 2, and mixed (a third of the lanes at 2-3, the rest
// 10-41), as the columns of a job mix them; gamma a run-time 1.0.
__global__ void micro_warp(long long* out, double* sink, int n, double gamma) {
  const int lane = threadIdx.x;
  double y = 0.0;
  for (int kind = 0; kind < 3; ++kind) {
    const double count = kind == 0 ? 50.0 : kind == 1 ? 2.0
                         : (lane % 3 == 0 ? 2.0 + lane % 2 : 10.0 + lane);
    __syncwarp();
    const long long t0 = clock64();
    for (int i = 0; i < n; ++i) y += gibbs_rc::gamma_draw(count + (y > 1e300), gamma, 77 + i, i, lane);
    __syncwarp();
    const long long t1 = clock64();
    if (lane == 0) out[kind] = (t1 - t0) / n;
  }
  sink[lane] = y;
}

int main() {
  long long* d;
  double* s;
  long long h[16];
  cudaMalloc(&d, sizeof(h));
  cudaMalloc(&s, 32 * 8);
  micro_warp<<<1, 32>>>(d, s, 200, 1.0);
  micro_warp<<<1, 32>>>(d, s, 2000, 1.0);
  long long warp[3];
  cudaMemcpy(warp, d, sizeof(warp), cudaMemcpyDeviceToHost);
  printf("primitive gamma_draw over a warp, counts all 50      %lld cycles\n", warp[0]);
  printf("primitive gamma_draw over a warp, counts all 2       %lld cycles\n", warp[1]);
  printf("primitive gamma_draw over a warp, counts mixed       %lld cycles\n", warp[2]);
  micro<<<1, 64>>>(d, s, 200);
  micro<<<1, 64>>>(d, s, 2000);
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  const char* names[] = {"philox4x32_10", "philox draw (two uniforms)",
                         "log", "cos(2 pi x)",
                         "cospi(2 x)", "sqrt", "divide", "exp", "gamma_draw, count 50",
                         "gamma_draw, count 2", "lgamma", "binomial n 40 p 0.1 (inversion)",
                         "binomial n 600 p 0.3 (BTRS)",
#ifdef HAS_ROW_CDF
                         "row_cdf of 61 columns", "upper_bound in 61 columns",
#endif
#ifdef HAS_WALK
                         "walk of 61 columns", "row_mass of 61 columns",
#endif
                         ""};
  for (int j = 0; j < h[15]; ++j) printf("primitive %-34s %lld cycles\n", names[j], h[j]);
  return cudaGetLastError() != cudaSuccess;
}
'''

PROFILE_READERS = '''
extern "C" int rpvg_prof_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, n * sizeof(long long));
}
extern "C" int rpvg_prof_reset() {
  static long long zeros[8];
  return (int)cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
}
'''

MARK_MACROS = '''
__device__ long long g_prof[8];
#define PROF_START long long prof_t = clock64()
#define PROF_MARK(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  const long long prof_now = clock64(); g_prof[i] += prof_now - prof_t; prof_t = prof_now; } } while (0)
'''

# The loop whose body one profiled pass covers: an iteration of the
# read-count sampler, a slot step of the k-slot sampler.
LOOP_HEADS = {
    "gibbs_readcount": "for (int64_t it = 0; it < iterations; ++it) {",
    "gibbs_posterior_k": "for (int j = 0; j < k; ++j) {",
}


def profiled_source(src: str, name: str):
    """(source, extra nvcc flags, mark count) of a kernel whose thread 0
    of block 0 adds the cycles between consecutive marks of one pass of
    its loop into g_prof.  A source with PROF_MARK probes builds with
    -DRPVG_GIBBS_PROFILE; in one without them a mark follows each block
    barrier of the loop body."""
    if "PROF_MARK(" in src:
        marks = len(set(re.findall(r"PROF_MARK\((\d+)\)", src)))
        return src + PROFILE_READERS, ("-DRPVG_GIBBS_PROFILE",), marks
    head, loop = src.split(LOOP_HEADS[name], 1)
    # The loop body ends at the brace that closes it.
    depth, end = 1, 0
    for end, ch in enumerate(loop):
        depth += ch == "{"
        depth -= ch == "}"
        if depth == 0:
            break
    body, tail = loop[:end], loop[end:]
    parts = body.split("__syncthreads();")
    out = ""
    for i, part in enumerate(parts[:-1]):
        out += part + f"__syncthreads();\n      PROF_MARK({i});"
    out += parts[-1]
    src = head + LOOP_HEADS[name] + "\n      PROF_START;" + out + tail
    src = src.replace("#include <cstdint>", "#include <cstdint>\n" + MARK_MACROS, 1)
    return src + PROFILE_READERS, (), len(parts) - 1


def nvcc(build, src_path, out_path, shared=True, flags=()):
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", build.CSRC_DIR, "-o", out_path, src_path]
    if not shared:
        cmd = [c for c in cmd if c not in ("-shared", "-Xcompiler", "-fPIC")]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(result.stderr)
    return result.stderr


def sass_instructions(build, so_path):
    """Instructions per kernel function in the SASS of a built library."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    return counts


def profiled_library(build, module):
    """(ctypes library, mark count) of ``module``'s kernel with clock64
    marks; its entry point is given the wrapper's signature."""
    with open(build.source_path(module.KERNEL_NAME)) as handle:
        src, flags, marks = profiled_source(handle.read(), module.KERNEL_NAME)
    path = os.path.join(build.BUILD_DIR, f"{module.KERNEL_NAME}_profiled.cu")
    with open(path, "w") as handle:
        handle.write(src)
    so = os.path.join(build.BUILD_DIR, f"lib{module.KERNEL_NAME}_profiled.so")
    nvcc(build, path, so, flags=flags)
    return ctypes.CDLL(so), marks


GAMMA_CALL = ("draw = gamma_draw(static_cast<double>(n), jobs.gamma, seed, t, "
              "static_cast<uint32_t>(c));")


def gamma_twice_library(build, module):
    """The profiled read-count kernel with its Gamma step drawn twice: a
    draw at another counter first (mark 6), then the kernel's own (mark
    3), whose value it keeps, so that the second runs with the first's
    code and data at hand; None where the source has no such call."""
    with open(build.source_path(module.KERNEL_NAME)) as handle:
        src, flags, _ = profiled_source(handle.read(), module.KERNEL_NAME)
    if GAMMA_CALL not in src:
        return None
    src = src.replace(GAMMA_CALL, (
        "draw = gamma_draw(static_cast<double>(n), jobs.gamma, seed, t ^ 0x80000000u,\n"
        "                          static_cast<uint32_t>(c));\n"
        "        PROF_MARK(6);\n"
        "        draw = 0.0 * draw + gamma_draw(static_cast<double>(n), jobs.gamma, seed, t,\n"
        "                                       static_cast<uint32_t>(c));"))
    path = os.path.join(build.BUILD_DIR, f"{module.KERNEL_NAME}_gamma_twice.cu")
    with open(path, "w") as handle:
        handle.write(src)
    so = os.path.join(build.BUILD_DIR, f"lib{module.KERNEL_NAME}_gamma_twice.so")
    nvcc(build, path, so, flags=flags)
    return ctypes.CDLL(so)


def run_profiled(module, lib, marks, call):
    """Per-mark cycles of one ``call()`` with the profiled kernel, and
    whether its output equals the port's build bitwise."""
    import torch

    kernel = module._kernel_fn()
    fn = getattr(lib, kernel.__name__)
    fn.restype, fn.argtypes = kernel.restype, kernel.argtypes
    module._fn = fn
    try:
        lib.rpvg_prof_reset()
        profiled = call()
        torch.cuda.synchronize()
    finally:
        module._fn = kernel
    same = torch.equal(profiled, call())
    cycles = (ctypes.c_longlong * 8)()
    lib.rpvg_prof_read(cycles, 8)
    return list(cycles)[:marks], same


FMAD_BUILDS = (("-fmad=false", ("-fmad=false",)), ("-fmad=true", ()))


def fmad_ab(build, module, call):
    """(outputs, milliseconds) of ``call`` with ``module``'s kernel built
    each way of FMAD_BUILDS, timed in the order false, true, true, false."""
    import chip_smoke as cs

    kernel = module._kernel_fn()
    fns = {}
    for label, flags in FMAD_BUILDS:
        so = os.path.join(build.BUILD_DIR, f"lib{module.KERNEL_NAME}_{label[1:].replace('=', '_')}.so")
        nvcc(build, build.source_path(module.KERNEL_NAME), so, flags=flags)
        fn = getattr(ctypes.CDLL(so), kernel.__name__)
        fn.restype, fn.argtypes = kernel.restype, kernel.argtypes
        fns[label] = fn
    outs, times = {}, {}
    try:
        for label in ("-fmad=false", "-fmad=true", "-fmad=true", "-fmad=false"):
            module._fn = fns[label]
            outs.setdefault(label, call())
            times.setdefault(label, []).append(cs.cuda_ms(call, reps=3))
    finally:
        module._fn = kernel
    return outs, times


def report_fmad(build, gibbs_cuda, posterior_gibbs_cuda, readcount_runs, posterior_runs):
    """Section 5 of the module docstring."""
    import numpy as np

    import chip_smoke as cs

    for label, jobs, thin, gamma in readcount_runs:
        outs, times = fmad_ab(build, gibbs_cuda, lambda: gibbs_cuda.gibbs_read_counts(jobs, thin, gamma))
        a = cs.gibbs_job_slices(jobs, outs["-fmad=false"])
        b = cs.gibbs_job_slices(jobs, outs["-fmad=true"])
        same = sum(np.array_equal(x, y) for x, y in zip(a, b))
        close = [np.allclose(x, y, rtol=1e-9, atol=0.0) for x, y in zip(a, b)]
        rel = max((float(np.max(np.abs(x - y) / np.abs(x))) for x, y, c in zip(a, b, close)
                   if c and x.size), default=0.0)
        print(f"read-count kernel, {label} ({jobs.n_jobs} jobs): -fmad=false "
              f"{' / '.join(f'{t:.3f}' for t in times['-fmad=false'])} ms, -fmad=true "
              f"{' / '.join(f'{t:.3f}' for t in times['-fmad=true'])} ms (CUDA events); jobs "
              f"bitwise equal {same}, within rtol 1e-9 {sum(close)} (max rel {rel:.3e}), "
              f"diverged {len(close) - sum(close)}")
    for label, jobs in posterior_runs:
        outs, times = fmad_ab(build, posterior_gibbs_cuda,
                              lambda: posterior_gibbs_cuda.posterior_gibbs(jobs))
        diverged = cs.diverged_clusters(jobs, outs["-fmad=false"].cpu().numpy(),
                                        outs["-fmad=true"].cpu().numpy())
        print(f"posterior kernel, {label} ({jobs.n_clusters} clusters): -fmad=false "
              f"{' / '.join(f'{t:.3f}' for t in times['-fmad=false'])} ms, -fmad=true "
              f"{' / '.join(f'{t:.3f}' for t in times['-fmad=true'])} ms (CUDA events); clusters "
              f"with every pair equal {jobs.n_clusters - len(diverged)}")


def sparsity(inputs):
    """(share of zero probabilities, share of (32-path, row) tiles with a
    nonzero, R x P, R + nonzeros) over k-slot clusters' host inputs."""
    import numpy as np

    cells = zeros = tiles = live = dense = sparse = 0
    for probs in inputs:
        R, P = probs.shape
        nz = probs != 0
        cells += R * P
        zeros += R * P - int(nz.sum())
        pad = -(-P // 32) * 32
        padded = np.zeros((R, pad), dtype=bool)
        padded[:, :P] = nz
        per_tile = padded.reshape(R, pad // 32, 32).any(axis=2)
        tiles += per_tile.size
        live += int(per_tile.sum())
        dense += R * P
        sparse += R + int(nz.sum())
    return zeros / max(cells, 1), live / max(tiles, 1), dense, sparse


def cluster_inputs(jobs):
    """Per cluster of captured KSlotJobs: (probs, noise, counts, log
    frequencies) as host arrays, read back from the card."""
    h = jobs.host
    probs, noise = jobs.probs.cpu().numpy(), jobs.noise.cpu().numpy()
    counts, lf = jobs.counts.cpu().numpy(), jobs.log_freqs.cpu().numpy()
    out = []
    for b in range(jobs.n_clusters):
        R, P = int(h["n_rows"][b]), int(h["n_cols"][b])
        m0, r0, c0 = (int(h[name][b]) for name in ("mat_offsets", "row_offsets", "col_offsets"))
        out.append((probs[m0:m0 + R * P].reshape(R, P), noise[r0:r0 + R], counts[r0:r0 + R],
                    lf[c0:c0 + P]))
    return out


def k_slot_section(build, posterior_gibbs_k_cuda, main, device, lib_marks):
    """Section 6 of the module docstring."""
    import numpy as np

    import chip_smoke as cs
    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.infer import posteriors
    from rpvg_tpu_torch.testing import posterior_cluster_set, posterior_wide_cluster

    k = main.group_size
    h = main.host
    inputs = cluster_inputs(main)
    zero_share, tile_share, dense, sparse = sparsity([item[0] for item in inputs])
    print(f"k-slot: the -y 3 --use-hap-gibbs run's {main.n_clusters} clusters: {zero_share:.4f} of "
          f"the probabilities are zero; {tile_share:.4f} of the (32-path, row) tiles hold a "
          f"nonzero; logs per slot step over all clusters R x P {dense}, R + nonzeros {sparse}")
    steps = h["n_burn"] + h["n_its"]
    nonzeros = np.array([np.count_nonzero(item[0]) for item in inputs])
    work = h["n_chains"] * steps * (h["n_rows"] + nonzeros)
    chain_work = steps * (h["n_rows"] * h["n_cols"])
    slow = int(np.argmax(steps * (h["n_rows"] + nonzeros)))
    sample = posterior_gibbs_k_cuda.posterior_gibbs_k
    all_ms = cs.cuda_ms(lambda: sample(main), reps=3)
    seed = int(main.seeds[slow].item()) & 0xFFFFFFFFFFFFFFFF
    sizing = (int(h["n_chains"][slow]), int(h["n_burn"][slow]), int(h["n_its"][slow]))
    alone = posterior_gibbs_k_cuda.make_jobs([inputs[slow]], k, [sizing], [seed], device)
    one_chain = posterior_gibbs_k_cuda.make_jobs([inputs[slow]], k, [(1,) + sizing[1:]], [seed],
                                                 device)
    alone_ms = cs.cuda_ms(lambda: sample(alone), reps=3)
    chain_ms = cs.cuda_ms(lambda: sample(one_chain), reps=3)
    R, P = inputs[slow][0].shape
    slot_steps = k * int(steps[slow])
    print(f"k-slot: all {main.n_clusters} clusters ({int(h['n_chains'].sum())} chains) "
          f"{all_ms:.3f} ms; the largest-work cluster ({R} x {P}, {int(nonzeros[slow])} nonzeros, "
          f"{sizing[0]} chains of {sizing[1]} + {sizing[2]} iterations = {slot_steps} slot steps) "
          f"alone {alone_ms:.3f} ms, one of its chains alone {chain_ms:.3f} ms "
          f"({chain_ms / slot_steps * 1e3:.2f} us per slot step); the most R x P x steps "
          f"per chain: cluster {int(np.argmax(chain_work))}, the most work in all: cluster "
          f"{int(np.argmax(work))}")
    seeded_clusters = posterior_cluster_set(64, seed=91, max_paths=120) + [
        posterior_wide_cluster(200, 93, n_rows=150)]
    keys = prng.split(prng.prng_key(97), len(seeded_clusters))
    seeded = posteriors.posterior_gibbs_k_jobs(seeded_clusters, 3, keys, device)
    print(f"k-slot: chip_smoke.py's {seeded.n_clusters} seeded clusters at k = 3 "
          f"{cs.cuda_ms(lambda: sample(seeded), reps=5):.3f} ms")

    lib, marks = lib_marks
    cycles, same = run_profiled(posterior_gibbs_k_cuda, lib, marks, lambda: sample(one_chain))
    per_step = [round(c / slot_steps) for c in cycles]
    print(f"k-slot: that chain alone, cycles per slot step between marks {per_step} (sum "
          f"{sum(per_step)}; profiled copy bitwise equal: {same})")
    tiny = (np.ones((1, 1)), np.full(1, 0.01), np.ones(1), np.zeros(1))
    short = posterior_gibbs_k_cuda.make_jobs([tiny], k, [(1, 500, 500)], [1], device)
    long = posterior_gibbs_k_cuda.make_jobs([tiny], k, [(1, 1000, 1000)], [1], device)
    minimum_us = (cs.cuda_ms(lambda: sample(long), reps=5)
                  - cs.cuda_ms(lambda: sample(short), reps=5)) / (1000 * k) * 1e3
    cycles, same = run_profiled(posterior_gibbs_k_cuda, lib, marks, lambda: sample(long))
    print(f"k-slot: the 1 x 1 cluster's chain, cycles per slot step between marks "
          f"{[round(c / (2000 * k)) for c in cycles]}")
    print(f"k-slot: per-slot-step minimum (a 1 x 1 cluster's chain, 2,000 less 1,000 "
          f"iterations) {minimum_us:.3f} us; the slowest chain's dependent-chain floor "
          f"{slot_steps} x {minimum_us:.3f} us = {slot_steps * minimum_us / 1e3:.3f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=REPO, help="checkout whose package and kernels to profile")
    args = parser.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import numpy as np
    import torch

    import chip_smoke as cs
    from rpvg_tpu_torch import alignments, cli, sim
    from rpvg_tpu_torch.io import rpa
    from rpvg_tpu_torch.ops import build, gibbs_cuda, posterior_gibbs_cuda, posterior_gibbs_k_cuda
    from rpvg_tpu_torch.testing import gibbs_job_set, gibbs_jobs_on

    if not torch.cuda.is_available():
        print("torch_gibbs_profile: CUDA is required", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"profiling the package at {repo}")
    device = torch.device("cuda", 0)
    for module in (gibbs_cuda, posterior_gibbs_k_cuda):
        so, _ = build.build_library(module.KERNEL_NAME, force=True)
        print(f"{module.KERNEL_NAME}: SASS instructions per function {sass_instructions(build, so)}")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    readcount_prof = profiled_library(build, gibbs_cuda)
    k_slot_prof = profiled_library(build, posterior_gibbs_k_cuda)
    with open(build.source_path(gibbs_cuda.KERNEL_NAME)) as handle:
        src = handle.read()
    defines = [f"-D{name}" for name, fn in (("HAS_ROW_CDF", "row_cdf("), ("HAS_WALK", "walk("))
               if fn in src]
    micro_src = os.path.join(build.BUILD_DIR, "gibbs_micro.cu")
    with open(micro_src, "w") as handle:
        handle.write(MICRO)
    micro_bin = os.path.join(build.BUILD_DIR, "gibbs_micro")
    nvcc(build, micro_src, micro_bin, shared=False, flags=defines)

    captured, clusters_captured, k_captured = [], [], []
    with tempfile.TemporaryDirectory(prefix="rpvg_gibbs_profile_") as work:
        bench = cs.write_dataset(sim, rpa, alignments, work, num_genes=1286,
                                 num_pairs=cs.PAIRS, seed_panel=5, seed_reads=17)
        wrapped = (
            (gibbs_cuda, "gibbs_read_counts", captured, ("-n", "100"), "haplotype-transcripts", True),
            (posterior_gibbs_cuda, "posterior_gibbs", clusters_captured, ("--use-hap-gibbs",),
             "haplotypes", False),
            (posterior_gibbs_k_cuda, "posterior_gibbs_k", k_captured,
             ("-y", "3", "--use-hap-gibbs"), "haplotypes", False),
        )
        for module, name, sink, extra, model, info in wrapped:
            original = getattr(module, name)

            def capture(*call_args, _original=original, _sink=sink):
                _sink.append(call_args)
                return _original(*call_args)

            setattr(module, name, capture)
            try:
                rc, stats = cli.run_cli(cs.cli_argv(bench, os.path.join(work, name), "cuda", 8,
                                                    model, info) + list(extra))
            finally:
                setattr(module, name, original)
            if rc != 0:
                raise RuntimeError(f"the {model} {' '.join(extra)} run exited {rc}")
            print(f"{model} {' '.join(extra)}: phases",
                  {k: round(v, 4) for k, v in stats["phase_seconds"].items()})
    jobs, thin, gamma = captured[0]

    shapes = jobs.shapes
    work_ = jobs.host_samples * shapes[:, 0] * shapes[:, 1]
    counts_all = jobs.tasks.counts.cpu().numpy()
    probs_all = jobs.tasks.probs.cpu().numpy()
    for j in np.argsort(-work_)[:4]:
        task = int(jobs.host_task_ids[j])
        R, C = map(int, jobs.tasks.shapes[task])
        ro, mo = int(jobs.tasks.row_offsets[task]), int(jobs.tasks.mat_offsets[task])
        counts = counts_all[ro:ro + R]
        nonzero = (probs_all[mo:mo + R * C].reshape(R, C) > 0).sum(axis=1)
        print(f"job {j}: {R} x {C}, {jobs.host_samples[j]} samples; rows over 4 reads "
              f"{int((counts > 4).sum())}, largest count {counts.max():.0f}, reads {counts.sum():.0f}; "
              f"nonzero columns per row median {np.median(nonzero):.0f} max {nonzero.max()}")

    slow = int(np.argmax(work_))

    def one_job(samples):
        return gibbs_cuda.make_jobs(
            jobs.tasks, [int(jobs.host_task_ids[slow])],
            [jobs.init_fracs[jobs.frac_offsets[slow]:jobs.frac_offsets[slow + 1]].cpu().numpy()],
            [int(jobs.seeds[slow].item()) & 0xFFFFFFFFFFFFFFFF], [samples],
        )

    one = one_job(int(jobs.host_samples[slow]))
    inputs = gibbs_job_set(256, seed=61)
    seeded = gibbs_jobs_on(inputs, device, [8] * len(inputs), seed=62)
    teams = gibbs_cuda._TEAMS
    first = None
    for cap in (256, 512, 512, 256):
        gibbs_cuda._TEAMS = tuple(t for t in teams if t <= cap)
        outs = (gibbs_cuda.gibbs_read_counts(jobs, thin, gamma),
                gibbs_cuda.gibbs_read_counts(seeded, cs.GIBBS_THIN, 1.0))
        first = first or outs
        same = all(torch.equal(a, b) for a, b in zip(first, outs))
        t_all = cs.cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(jobs, thin, gamma), reps=3)
        t_one = cs.cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(one, thin, gamma), reps=3)
        t_seeded = cs.cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(seeded, cs.GIBBS_THIN, 1.0), reps=5)
        print(f"teams up to {cap}: {jobs.n_jobs} D2 jobs {t_all:.3f} ms, slowest job "
              f"{tuple(map(int, shapes[slow]))} alone {t_one:.3f} ms, {len(inputs)} seeded jobs "
              f"{t_seeded:.3f} ms; outputs bitwise equal to the first setting: {same}")
    gibbs_cuda._TEAMS = teams

    lib, marks = readcount_prof
    cycles, same = run_profiled(gibbs_cuda, lib, marks,
                                lambda: gibbs_cuda.gibbs_read_counts(one, thin, gamma))
    iterations = int(one.host_samples[0]) * thin
    per_it = [round(c / iterations) for c in cycles]
    print(f"slowest job, cycles per iteration between marks {per_it} (sum {sum(per_it)}; "
          f"profiled copy bitwise equal: {same})")
    twice = gamma_twice_library(build, gibbs_cuda)
    if twice is not None:
        cycles, same = run_profiled(gibbs_cuda, twice, 7,
                                    lambda: gibbs_cuda.gibbs_read_counts(one, thin, gamma))
        print(f"slowest job, Gamma step drawn twice: first draw {round(cycles[6] / iterations)} "
              f"cycles, second {round(cycles[3] / iterations)} per iteration (output bitwise "
              f"equal: {same})")
    from rpvg_tpu_torch.infer.batching import pack_ragged

    tiny = pack_ragged([(np.ones((1, 1)), np.ones(1))], device)

    def tiny_call(samples):
        tiny_jobs = gibbs_cuda.make_jobs(tiny, [0], [np.ones(1)], [1], [samples])
        return cs.cuda_ms(lambda: gibbs_cuda.gibbs_read_counts(tiny_jobs, 10, 1.0), reps=5)

    minimum_us = (tiny_call(200) - tiny_call(100)) / 1000 * 1e3
    print(f"read-count: per-iteration minimum (a 1 x 1 job, 2,000 less 1,000 iterations) "
          f"{minimum_us:.3f} us; the slowest job's dependent-chain floor {iterations} x "
          f"{minimum_us:.3f} us = {iterations * minimum_us / 1e3:.3f} ms")
    micro = subprocess.run([micro_bin], capture_output=True, text=True)
    print(micro.stdout.strip())
    report_fmad(build, gibbs_cuda, posterior_gibbs_cuda,
                [("the -n 100 run's D2 jobs", jobs, thin, gamma),
                 (f"{len(inputs)} seeded jobs", seeded, cs.GIBBS_THIN, 1.0)],
                [("the haplotypes --use-hap-gibbs run's clusters", clusters_captured[0][0])])
    k_slot_section(build, posterior_gibbs_k_cuda, k_captured[0][0], device, k_slot_prof)
    return micro.returncode


if __name__ == "__main__":
    sys.exit(main())
