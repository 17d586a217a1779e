#!/usr/bin/env python3
"""Where the read-count Gibbs kernel (rpvg_tpu_torch/csrc/gibbs_readcount.cu)
spends its time on one NVIDIA GPU.

Run from the repository root, on a machine with CUDA and nvcc:

    python3 tools/torch_gibbs_profile.py

It synthesises chip_smoke.py's 100k-pair dataset, runs the port's
`haplotype-transcripts -f -n 100` main path on the card and captures the
jobs its phase D2 hands the kernel, then prints:

1. the read counts of the heaviest jobs' rows (how many rows draw more
   than 4 reads, the largest count, nonzero columns per row);
2. the kernel on those jobs, on their slowest job alone and on
   chip_smoke.py's 261 seeded jobs, with teams capped at 256 and at 512
   threads (in the order 256, 512, 512, 256; CUDA events), and whether
   every output is bitwise the same across team sizes;
3. a copy of the kernel with clock64() read by thread 0 after each of an
   iteration's four barriers, run on the slowest job: cycles per
   iteration in step 2 (the row splits), step 4 (the Gamma draws), the
   sum and the normalisation;
4. cycles per call of the kernel's primitives (Philox, the math library,
   a walk, a row's mass, Gamma and binomial draws), one thread chaining
   2,000 calls each;
5. both Gibbs kernels built with -fmad=false and with nvcc's default
   (multiply-adds fused; the port's build), in the order false, true,
   true, false: the
   read-count kernel on the D2 jobs and the 261 seeded jobs, the
   posterior kernel on the clusters of a `haplotypes --use-hap-gibbs` run
   (captured likewise); CUDA events, and how far the two builds' outputs
   lie apart (jobs bitwise equal, within rtol 1e-9, diverged; clusters
   with every pair equal).

Build outputs go to rpvg_tpu_torch/build/ (git-ignored).
"""

import ctypes
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MICRO = r'''
#include "gibbs_readcount.cu"
#include <cstdio>

__global__ void micro(long long* out, double* sink, int n) {
  __shared__ double row[64];
  __shared__ double fr[64];
  for (int c = threadIdx.x; c < 64; c += blockDim.x) { row[c] = 0.01 + 0.001 * c; fr[c] = 1.0 / 64; }
  __syncthreads();
  if (threadIdx.x) return;
  double x = 0.3, y = 0.0;
  uint32_t w = 1;
  long long t[15];
  t[0] = clock64();
  for (int i = 0; i < n; ++i) { philox::Words ws = philox::philox4x32_10(i, w, 3, 4, 5, 6); w ^= ws.w0 + ws.w3; }
  t[1] = clock64();
  for (int i = 0; i < n; ++i) { philox::Uniforms u = philox::draw(w, i, 1, 2, 3); x += u.u0; w += (uint32_t)(u.u1 * 4.0); }
  t[2] = clock64();
  for (int i = 0; i < n; ++i) x = log(x + 1.5);
  t[3] = clock64();
  for (int i = 0; i < n; ++i) x = cos(x + 0.7);
  t[4] = clock64();
  for (int i = 0; i < n; ++i) x = sqrt(x + 1.1);
  t[5] = clock64();
  for (int i = 0; i < n; ++i) x = 1.0 / (x + 1.3);
  t[6] = clock64();
  for (int i = 0; i < n; ++i) x = exp(-x);
  t[7] = clock64();
  for (int i = 0; i < n; ++i) y += gibbs_rc::gamma_draw(50.0 + (x > 2.0), 1.0, 77 + i, i, 3);
  t[8] = clock64();
  for (int i = 0; i < n; ++i) y += gibbs_rc::gamma_draw(2.0 + (x > 2.0), 1.0, 77 + i, i, 3);
  t[9] = clock64();
  for (int i = 0; i < n; ++i) y += (double)gibbs_rc::walk(row, fr, 61, 0.0001 + (x > 5.0 ? 1.0 : 0.5) * (i % 7) * 0.05);
  t[10] = clock64();
  for (int i = 0; i < n; ++i) y += gibbs_rc::row_mass(row, fr, 61 + (x > 5.0));
  t[11] = clock64();
  for (int i = 0; i < n; ++i) y += lgamma(y * 1e-9 + 30.5 + i % 5);
  t[12] = clock64();
  for (int i = 0; i < n; ++i) y += (double)gibbs_rc::binomial(40 + (x > 5.0), 0.1, 77 + i, i, 2, 3);
  t[13] = clock64();
  for (int i = 0; i < n; ++i) y += (double)gibbs_rc::binomial(600, 0.3, 77 + i, i, 2, 3);
  t[14] = clock64();
  for (int k = 0; k < 14; ++k) out[k] = (t[k + 1] - t[k]) / n;
  *sink = x + y + w;
}

int main() {
  long long* d;
  double* s;
  long long h[14];
  cudaMalloc(&d, sizeof(h));
  cudaMalloc(&s, 8);
  micro<<<1, 64>>>(d, s, 200);
  micro<<<1, 64>>>(d, s, 2000);
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  const char* names[] = {"philox4x32_10", "philox draw (two uniforms)", "log", "cos", "sqrt",
                         "divide", "exp", "gamma_draw, count 50", "gamma_draw, count 2",
                         "walk of 61 columns", "row_mass of 61 columns", "lgamma",
                         "binomial n 40 p 0.1 (inversion)", "binomial n 600 p 0.3 (BTRS)"};
  for (int k = 0; k < 14; ++k) printf("primitive %-34s %lld cycles\n", names[k], h[k]);
  return cudaGetLastError() != cudaSuccess;
}
'''

PROFILE_READERS = '''
extern "C" int rpvg_prof_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, n * sizeof(long long));
}
extern "C" int rpvg_prof_reset() {
  static long long zeros[4];
  return (int)cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros));
}
'''


def profiled_source(src: str) -> str:
    """The kernel source with thread 0 adding each of an iteration's four
    barrier-to-barrier cycle counts of block 0 into g_prof."""
    head, loop = src.split("for (int64_t it = 0; it < iterations; ++it) {", 1)
    parts = loop.split("    __syncthreads();\n")
    out = head + "for (int64_t it = 0; it < iterations; ++it) {\n    long long t_prev = clock64();\n"
    for i, part in enumerate(parts[:-1]):
        out += part + "    __syncthreads();\n"
        if i < 4:
            out += (f"    if (tid == 0 && blockIdx.x == 0) {{ const long long t_now = clock64(); "
                    f"g_prof[{i}] += t_now - t_prev; t_prev = t_now; }}\n")
    out += parts[-1]
    out = out.replace("namespace gibbs_rc {", "__device__ long long g_prof[4];\nnamespace gibbs_rc {", 1)
    return out + PROFILE_READERS


def nvcc(build, src_path, out_path, shared=True, flags=()):
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", build.CSRC_DIR, "-o", out_path, src_path]
    if not shared:
        cmd = [c for c in cmd if c not in ("-shared", "-Xcompiler", "-fPIC")]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(result.stderr)


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


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from rpvg_tpu_torch import alignments, cli, sim
    from rpvg_tpu_torch.io import rpa
    from rpvg_tpu_torch.ops import build, gibbs_cuda, posterior_gibbs_cuda
    from rpvg_tpu_torch.testing import gibbs_job_set, gibbs_jobs_on

    if not torch.cuda.is_available():
        print("torch_gibbs_profile: CUDA is required", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    device = torch.device("cuda", 0)
    build.build_library(gibbs_cuda.KERNEL_NAME, force=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with open(build.source_path(gibbs_cuda.KERNEL_NAME)) as handle:
        src = handle.read()
    prof_src = os.path.join(build.BUILD_DIR, "gibbs_readcount_profiled.cu")
    with open(prof_src, "w") as handle:
        handle.write(profiled_source(src))
    prof_so = os.path.join(build.BUILD_DIR, "libgibbs_readcount_profiled.so")
    nvcc(build, prof_src, prof_so)
    micro_src = os.path.join(build.BUILD_DIR, "gibbs_micro.cu")
    with open(micro_src, "w") as handle:
        handle.write(MICRO)
    micro_bin = os.path.join(build.BUILD_DIR, "gibbs_micro")
    nvcc(build, micro_src, micro_bin, shared=False)

    with tempfile.TemporaryDirectory(prefix="rpvg_gibbs_profile_") as work:
        bench = cs.write_dataset(sim, rpa, alignments, work, num_genes=1286,
                                 num_pairs=cs.PAIRS, seed_panel=5, seed_reads=17)
        captured = []
        sample = gibbs_cuda.gibbs_read_counts

        def capture(jobs, thin_its, gamma):
            captured.append((jobs, thin_its, gamma))
            return sample(jobs, thin_its, gamma)

        gibbs_cuda.gibbs_read_counts = capture
        try:
            rc, stats = cli.run_cli(cs.cli_argv(bench, os.path.join(work, "main"), "cuda", 8)
                                    + ["-n", "100"])
        finally:
            gibbs_cuda.gibbs_read_counts = sample
        if rc != 0:
            raise RuntimeError(f"the -n 100 main path exited {rc}")
        clusters_captured = []
        sample_posterior = posterior_gibbs_cuda.posterior_gibbs

        def capture_posterior(jobs):
            clusters_captured.append(jobs)
            return sample_posterior(jobs)

        posterior_gibbs_cuda.posterior_gibbs = capture_posterior
        try:
            rc, _ = cli.run_cli(cs.cli_argv(bench, os.path.join(work, "hap"), "cuda", 8, "haplotypes", False)
                                + ["--use-hap-gibbs"])
        finally:
            posterior_gibbs_cuda.posterior_gibbs = sample_posterior
        if rc != 0:
            raise RuntimeError(f"the haplotypes --use-hap-gibbs run exited {rc}")
    jobs, thin, gamma = captured[0]
    print("phases", {k: round(v, 4) for k, v in stats["phase_seconds"].items()})

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
    one = gibbs_cuda.make_jobs(
        jobs.tasks, [int(jobs.host_task_ids[slow])],
        [jobs.init_fracs[jobs.frac_offsets[slow]:jobs.frac_offsets[slow + 1]].cpu().numpy()],
        [int(jobs.seeds[slow].item()) & 0xFFFFFFFFFFFFFFFF], [int(jobs.host_samples[slow])],
    )
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

    lib = ctypes.CDLL(prof_so)
    fn = lib.rpvg_gibbs_readcount_f64
    kernel = gibbs_cuda._kernel_fn()
    fn.restype, fn.argtypes = kernel.restype, kernel.argtypes
    gibbs_cuda._fn = fn
    try:
        lib.rpvg_prof_reset()
        profiled = gibbs_cuda.gibbs_read_counts(one, thin, gamma)
        torch.cuda.synchronize()
    finally:
        gibbs_cuda._fn = kernel
    same = torch.equal(profiled, gibbs_cuda.gibbs_read_counts(one, thin, gamma))
    cycles = (ctypes.c_longlong * 4)()
    lib.rpvg_prof_read(cycles, 4)
    iterations = int(one.host_samples[0]) * thin
    print("slowest job, cycles per iteration: row splits {}, Gamma draws {}, sum {}, "
          "normalisation {} (profiled copy bitwise equal: {})".format(
              *[round(c / iterations) for c in cycles], same))
    micro = subprocess.run([micro_bin], capture_output=True, text=True)
    print(micro.stdout.strip())
    report_fmad(build, gibbs_cuda, posterior_gibbs_cuda,
                [("the -n 100 run's D2 jobs", jobs, thin, gamma),
                 (f"{len(inputs)} seeded jobs", seeded, cs.GIBBS_THIN, 1.0)],
                [("the haplotypes --use-hap-gibbs run's clusters", clusters_captured[0])])
    return micro.returncode


if __name__ == "__main__":
    sys.exit(main())
