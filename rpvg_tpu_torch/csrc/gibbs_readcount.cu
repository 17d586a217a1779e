// Read-count Gibbs sampler over a ragged set of jobs, float64.
//
// Replaces the XLA device function
// rpvg_tpu/infer/readcount_gibbs.py::_gibbs_read_counts_vmapped (core
// _gibbs_read_counts_masked, multinomial _multinomial_rows; reference
// gibbsReadCountSampler, src/path_abundance_estimator.cpp:116-212).  A job
// is one EM task after its fixed point: P (R, C) noise-normalised with
// the noise column last, read counts (R,), and the EM fractions (C,) that
// start the chain.  One iteration:
//
//   1. each row r: post[c] = P[r, c] * fracs[c] and its sum (columns in
//      order); a row whose sum is not positive is skipped;
//   2. the row's count n splits over the columns as a multinomial of
//      post / sum: n <= 256 as n categorical draws, each a walk of the
//      prefix sums (the native sampler's shortcut for n <= 4,
//      rpvg_native.cpp rpvg_gibbs_ragged); n > 256 as binomial splits
//      column by column (remaining count over remaining mass), each
//      binomial by inversion when n min(p, 1 - p) < 10 and by BTRS
//      (Hoermann 1993) above;
//   3. the integer draws add into per-column path counts in shared memory
//      (atomics of integer-valued doubles, a warp's trials of one column
//      in one atomic: neither order nor grouping can change the sum);
//   4. each column draws Gamma(path count + gamma): a sum of count + 1
//      exponentials (one log of a product of uniforms) for gamma = 1 and a
//      count of at most 3, else Marsaglia-Tsang (with the shape + 1 boost
//      below shape 1);
//   5. warp 0 sums the draws (lane l over columns l, l + 32, ... in order,
//      then a fixed xor butterfly), and the fractions are draws / sum.
// Every thin_its-th iteration's fractions are written out, n_samples[j]
// of them for job j.
//
// Random bits: Philox4x32-10 (philox.cuh) keyed by the job's 64-bit seed,
// at counters (iteration, row or column, index, tag | attempt); see
// kTag* below.  rpvg_tpu_torch/ops/gibbs_cuda.py gibbs_read_counts_plain
// repeats this arithmetic step by step in PyTorch on the same counters.
// nvcc fuses multiply-adds here that the plain version rounds twice, so
// the two differ in the last bits of a fraction, and a job leaves the
// plain version's chain only where such a difference flips one draw's
// comparison (none in chip_smoke.py phase 7's 3,771 jobs).  Building with
// -fmad=false makes them bitwise equal and the kernel 7 % slower on an
// H100 (tools/torch_gibbs_profile.py).
//
// Layout: one block per job, threads over rows (step 2) and columns
// (steps 4-5).  A lane draws its own row's trials when they are at most
// 4; the trials of its warp's rows of 5-256 reads are spread over the 32
// lanes, one row after another, so that no lane walks a long chain alone
// (a row of 106 reads drawn by binomial splits alone set a whole job's
// time).  P is staged in shared memory when it fits, else read from
// global memory.  What bounds it on an H100: the chain of S x thin
// dependent iterations per job (2,500 at -n 100), each a few serial
// chains of Philox rounds, walks and FP64 transcendentals (on the main
// path's slowest job about 84k cycles for step 2 and 37k for step 4 per
// iteration); the bytes and operations are far below a millisecond
// (chip_smoke.py phase 7).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace gibbs_rc {

// Counter word 3: what is drawn (high byte) and the attempt (low 24 bits).
constexpr uint32_t kTagCategorical = 0u << 24;  // (t, row, trial)
constexpr uint32_t kTagBinomial = 1u << 24;     // (t, row, column) | attempt
constexpr uint32_t kTagExponential = 2u << 24;  // (t, column, factor / 2)
constexpr uint32_t kTagNormal = 3u << 24;       // (t, column, attempt)
constexpr uint32_t kTagAccept = 4u << 24;       // (t, column, attempt)
constexpr uint32_t kTagBoost = 5u << 24;        // (t, column, 0)
constexpr uint32_t kMaxAttempts = 1u << 20;
// Rows of at most kLaneTrials reads: their lane draws each trial; up to
// kMaxTrials: their warp draws the trials together; above: binomial splits.
constexpr int64_t kLaneTrials = 4;
constexpr int64_t kMaxTrials = 256;

__device__ int64_t binomial_inversion(int64_t n, double p, uint64_t seed, uint32_t t,
                                      uint32_t r, uint32_t c) {
  const double nd = static_cast<double>(n);
  const double q = 1.0 - p;
  const double qn = exp(nd * log(q));
  const double np = nd * p;
  const double bound = fmin(nd, np + 10.0 * sqrt(np * q + 1.0));
  uint32_t attempt = 0;
  double u = philox::draw(seed, t, r, c, kTagBinomial).u0;
  double x = 0.0;
  double px = qn;
  while (u > px) {
    x += 1.0;
    if (x > bound) {
      if (++attempt >= kMaxAttempts) return static_cast<int64_t>(floor(np));
      x = 0.0;
      px = qn;
      u = philox::draw(seed, t, r, c, kTagBinomial | attempt).u0;
    } else {
      u -= px;
      px = ((nd - x + 1.0) * p * px) / (x * q);
    }
  }
  return static_cast<int64_t>(x);
}

__device__ int64_t binomial_btrs(int64_t n, double p, uint64_t seed, uint32_t t, uint32_t r,
                                 uint32_t c) {
  const double nd = static_cast<double>(n);
  const double q = 1.0 - p;
  const double spq = sqrt(nd * p * q);
  const double b = 1.15 + 2.53 * spq;
  const double a = -0.0873 + 0.0248 * b + 0.01 * p;
  const double cc = nd * p + 0.5;
  const double vr = 0.92 - 4.2 / b;
  const double alpha = (2.83 + 5.1 / b) * spq;
  const double lpq = log(p / q);
  const double m = floor((nd + 1.0) * p);
  const double h = lgamma(m + 1.0) + lgamma(nd - m + 1.0);
  for (uint32_t attempt = 0; attempt < kMaxAttempts; ++attempt) {
    const philox::Uniforms uv = philox::draw(seed, t, r, c, kTagBinomial | attempt);
    const double u = uv.u0 - 0.5;
    const double us = 0.5 - fabs(u);
    const double k = floor((2.0 * a / us + b) * u + cc);
    if (k < 0.0 || k > nd) continue;
    if (us >= 0.07 && uv.u1 <= vr) return static_cast<int64_t>(k);
    const double v = log(uv.u1 * alpha / (a / (us * us) + b));
    if (v <= h - lgamma(k + 1.0) - lgamma(nd - k + 1.0) + (k - m) * lpq) {
      return static_cast<int64_t>(k);
    }
  }
  return static_cast<int64_t>(m);
}

// Binomial(n, p) for n >= 1 and 0 < p < 1.
__device__ int64_t binomial(int64_t n, double p, uint64_t seed, uint32_t t, uint32_t r,
                            uint32_t c) {
  const bool flip = p > 0.5;
  const double pp = flip ? 1.0 - p : p;
  const int64_t x = static_cast<double>(n) * pp < 10.0
                        ? binomial_inversion(n, pp, seed, t, r, c)
                        : binomial_btrs(n, pp, seed, t, r, c);
  return flip ? n - x : x;
}

// Gamma(shape) for shape >= 1, Marsaglia and Tsang (2000).
__device__ double gamma_mt(double shape, uint64_t seed, uint32_t t, uint32_t c) {
  const double d = shape - 1.0 / 3.0;
  const double cm = 1.0 / sqrt(9.0 * d);
  for (uint32_t attempt = 0; attempt < kMaxAttempts; ++attempt) {
    const philox::Uniforms g = philox::draw(seed, t, c, attempt, kTagNormal);
    const double x = sqrt(-2.0 * log(g.u0)) * cos(6.283185307179586 * g.u1);
    double v = 1.0 + cm * x;
    if (v <= 0.0) continue;
    v = v * v * v;
    const double u = philox::draw(seed, t, c, attempt, kTagAccept).u0;
    const double x2 = x * x;
    if (u < 1.0 - 0.0331 * (x2 * x2)) return d * v;
    if (log(u) < 0.5 * x2 + d * (1.0 - v + log(v))) return d * v;
  }
  return d;
}

__device__ double gamma_draw(double count, double gamma, uint64_t seed, uint32_t t,
                             uint32_t c) {
  if (gamma == 1.0 && count <= 3.0) {
    const int k = static_cast<int>(count) + 1;
    double prod = 1.0;
    for (int i = 0; i < k; ++i) {
      const philox::Uniforms w = philox::draw(seed, t, c, static_cast<uint32_t>(i >> 1),
                                              kTagExponential);
      prod *= (i & 1) ? w.u1 : w.u0;
    }
    return -log(prod);
  }
  const double shape = count + gamma;
  if (shape >= 1.0) return gamma_mt(shape, seed, t, c);
  const double u = philox::draw(seed, t, c, 0, kTagBoost).u0;
  return gamma_mt(shape + 1.0, seed, t, c) * exp(log(u) / shape);
}

// The row's mass: the sum of P[r, c] * fracs[c] in column order.
__device__ double row_mass(const double* __restrict__ row, const double* fracs, int64_t C) {
  double row_sum = 0.0;
  for (int64_t c = 0; c < C; ++c) row_sum += row[c] * fracs[c];
  return row_sum;
}

// A categorical trial's column: the first whose prefix sum of
// P[r, c] * fracs[c] exceeds x (the last column when rounding leaves none).
// Four products are loaded ahead of their adds, which stay in column order.
__device__ int64_t walk(const double* __restrict__ row, const double* fracs, int64_t C,
                        double x) {
  double acc = 0.0;
  int64_t c = 0;
  for (; c + 4 <= C; c += 4) {
    const double p0 = row[c] * fracs[c];
    const double p1 = row[c + 1] * fracs[c + 1];
    const double p2 = row[c + 2] * fracs[c + 2];
    const double p3 = row[c + 3] * fracs[c + 3];
    acc += p0;
    if (x < acc) return c;
    acc += p1;
    if (x < acc) return c + 1;
    acc += p2;
    if (x < acc) return c + 2;
    acc += p3;
    if (x < acc) return c + 3;
  }
  for (; c < C; ++c) {
    acc += row[c] * fracs[c];
    if (x < acc) return c;
  }
  return C - 1;
}

// Trial k of row r: a uniform times the row's mass, walked to a column.
__device__ int64_t trial_column(const double* __restrict__ row, const double* fracs, int64_t C,
                                double row_sum, uint64_t seed, uint32_t t, uint32_t r,
                                uint32_t k) {
  const double x = philox::draw(seed, t, r, k, kTagCategorical).u0 * row_sum;
  return walk(row, fracs, C, x);
}

// One more read in path_counts[column] for every lane whose column is not
// negative: the lanes of a column add their number in one atomic (integer-
// valued doubles, so the grouping cannot change the sum).
__device__ void add_reads(double* path_counts, int64_t column) {
  const unsigned peers = __match_any_sync(0xffffffffu, static_cast<long long>(column));
  if (column >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(path_counts + column, static_cast<double>(__popc(peers)));
  }
}

// A row's count n > kMaxTrials split column by column, added to path_counts.
__device__ void binomial_split(const double* __restrict__ row, const double* fracs, int64_t C,
                               int64_t n, double row_sum, double* path_counts, uint64_t seed,
                               uint32_t t, uint32_t r) {
  int64_t remaining = n;
  double remaining_p = row_sum;
  for (int64_t c = 0; c < C && remaining > 0; ++c) {
    const double post = row[c] * fracs[c];
    double ratio = remaining_p > 0.0 ? post / remaining_p : 0.0;
    ratio = fmin(1.0, fmax(0.0, ratio));
    int64_t draw = 0;
    if (c == C - 1 || ratio >= 1.0) {
      draw = remaining;
    } else if (ratio > 0.0) {
      draw = binomial(remaining, ratio, seed, t, r, static_cast<uint32_t>(c));
    }
    if (draw) atomicAdd(path_counts + c, static_cast<double>(draw));
    remaining -= draw;
    remaining_p -= post;
  }
}

// Step 2 for the rows base .. base + 31 of one warp (every lane calls it).
__device__ void split_rows(const double* __restrict__ P, const double* counts, const double* fracs,
                           int64_t R, int64_t C, int64_t base, double* path_counts,
                           uint64_t seed, uint32_t t) {
  const int lane = threadIdx.x & 31;
  const int64_t r = base + lane;
  const double* row = P + r * C;
  double row_sum = 0.0;
  int64_t n = 0;
  if (r < R) {
    row_sum = row_mass(row, fracs, C);
    if (row_sum > 0.0) n = static_cast<int64_t>(counts[r]);
  }
  if (n > kMaxTrials) {
    binomial_split(row, fracs, C, n, row_sum, path_counts, seed, t, static_cast<uint32_t>(r));
  }
  const bool own = n > 0 && n <= kLaneTrials;
  for (int64_t k = 0; __any_sync(0xffffffffu, own && k < n); ++k) {
    add_reads(path_counts, own && k < n
                               ? trial_column(row, fracs, C, row_sum, seed, t,
                                              static_cast<uint32_t>(r), static_cast<uint32_t>(k))
                               : -1);
  }
  unsigned shared_rows = __ballot_sync(0xffffffffu, n > kLaneTrials && n <= kMaxTrials);
  while (shared_rows) {
    const int src = __ffs(shared_rows) - 1;
    shared_rows &= shared_rows - 1;
    const long long src_n = __shfl_sync(0xffffffffu, static_cast<long long>(n), src);
    const double src_sum = __shfl_sync(0xffffffffu, row_sum, src);
    const int64_t src_r = base + src;
    for (long long k0 = 0; k0 < src_n; k0 += 32) {
      const long long k = k0 + lane;
      add_reads(path_counts, k < src_n
                                 ? trial_column(P + src_r * C, fracs, C, src_sum, seed, t,
                                                static_cast<uint32_t>(src_r),
                                                static_cast<uint32_t>(k))
                                 : -1);
    }
  }
}

struct Jobs {
  const double* probs;
  const double* counts;
  const double* init_fracs;
  const int64_t* seeds;
  const int64_t* mat_offsets;
  const int64_t* row_offsets;
  const int64_t* n_rows;
  const int64_t* n_cols;
  const int64_t* task_ids;    // job -> task (matrix, counts)
  const int64_t* frac_offsets;
  const int64_t* out_offsets;
  const int64_t* n_samples;
  const int64_t* job_ids;     // this launch's jobs
  int64_t thin_its;
  double gamma;
  int staged;
  double* out;
};

__global__ void __launch_bounds__(512) gibbs_kernel(Jobs jobs) {
  extern __shared__ double smem[];
  const int64_t job = jobs.job_ids[blockIdx.x];
  const int64_t task = jobs.task_ids[job];
  const int64_t R = jobs.n_rows[task];
  const int64_t C = jobs.n_cols[task];
  const double* counts = jobs.counts + jobs.row_offsets[task];
  const uint64_t seed = static_cast<uint64_t>(jobs.seeds[job]);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  double* fracs = smem;              // C
  double* acc = smem + C;            // C: path counts, then Gamma draws
  double* total = smem + 2 * C;      // 1
  const double* P = jobs.probs + jobs.mat_offsets[task];
  if (jobs.staged) {
    double* staged = smem + 2 * C + 1;
    for (int64_t i = tid; i < R * C; i += nthreads) staged[i] = P[i];
    P = staged;
  }
  for (int64_t c = tid; c < C; c += nthreads) {
    fracs[c] = jobs.init_fracs[jobs.frac_offsets[job] + c];
    acc[c] = 0.0;
  }
  __syncthreads();

  const int64_t iterations = jobs.n_samples[job] * jobs.thin_its;
  double* out = jobs.out + jobs.out_offsets[job];
  for (int64_t it = 0; it < iterations; ++it) {
    const uint32_t t = static_cast<uint32_t>(it);
    for (int64_t base = tid & ~31; base < R; base += nthreads) {
      split_rows(P, counts, fracs, R, C, base, acc, seed, t);
    }
    __syncthreads();
    for (int64_t c = tid; c < C; c += nthreads) {
      acc[c] = gamma_draw(acc[c], jobs.gamma, seed, t, static_cast<uint32_t>(c));
    }
    __syncthreads();
    if (tid < 32) {
      double lane = 0.0;
      for (int64_t c = tid; c < C; c += 32) lane += acc[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lane += __shfl_xor_sync(0xffffffffu, lane, off);
      if (tid == 0) *total = lane;
    }
    __syncthreads();
    const bool keep = (it + 1) % jobs.thin_its == 0;
    const double sum = *total;
    for (int64_t c = tid; c < C; c += nthreads) {
      const double f = acc[c] / sum;
      fracs[c] = f;
      acc[c] = 0.0;
      if (keep) out[((it + 1) / jobs.thin_its - 1) * C + c] = f;
    }
    __syncthreads();
  }
}

}  // namespace gibbs_rc

// One launch over the n_jobs jobs listed in job_ids (int64, on the
// device), one block of `threads` threads (a multiple of 32, at most 512)
// each, with P staged in smem_bytes of shared memory per block (staged =
// 1) or read from global memory (staged = 0), on `stream`.  Job j samples
// task task_ids[j] of the ragged set (probs/counts by mat_offsets and
// row_offsets, shape n_rows x n_cols), from init_fracs at frac_offsets[j],
// with the Philox stream keyed by seeds[j], and writes n_samples[j] x C
// fractions at out_offsets[j] of out.  Returns cudaGetLastError().
extern "C" int rpvg_gibbs_readcount_f64(
    const void* probs, const void* counts, const void* init_fracs, const void* seeds,
    const void* mat_offsets, const void* row_offsets, const void* n_rows, const void* n_cols,
    const void* task_ids, const void* frac_offsets, const void* out_offsets,
    const void* n_samples, const void* job_ids, int64_t n_jobs, int64_t thin_its,
    double gamma, int64_t threads, int64_t staged, int64_t smem_bytes, void* out,
    void* stream) {
  if (n_jobs <= 0) return 0;
  const gibbs_rc::Jobs jobs{
      static_cast<const double*>(probs),       static_cast<const double*>(counts),
      static_cast<const double*>(init_fracs),  static_cast<const int64_t*>(seeds),
      static_cast<const int64_t*>(mat_offsets), static_cast<const int64_t*>(row_offsets),
      static_cast<const int64_t*>(n_rows),     static_cast<const int64_t*>(n_cols),
      static_cast<const int64_t*>(task_ids),   static_cast<const int64_t*>(frac_offsets),
      static_cast<const int64_t*>(out_offsets), static_cast<const int64_t*>(n_samples),
      static_cast<const int64_t*>(job_ids),    thin_its,
      gamma,                                   static_cast<int>(staged),
      static_cast<double*>(out)};
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(gibbs_rc::gibbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gibbs_rc::gibbs_kernel<<<dim3(static_cast<unsigned>(n_jobs)),
                           dim3(static_cast<unsigned>(threads)),
                           static_cast<size_t>(smem_bytes),
                           static_cast<cudaStream_t>(stream)>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}
