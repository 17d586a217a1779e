// Read-count Gibbs sampler over a ragged set of jobs, float64.
//
// Replaces the XLA device function
// rpvg_tpu/infer/readcount_gibbs.py::_gibbs_read_counts_vmapped (core
// _gibbs_read_counts_masked, multinomial _multinomial_rows; reference
// gibbsReadCountSampler, src/path_abundance_estimator.cpp:116-212).  A job
// is one EM task after its fixed point: P (R, C) noise-normalised with
// the noise column last, read counts (R,), and the EM fractions (C,) that
// start the chain.  An iteration draws from weights w (the last
// iteration's Gamma draws; the EM fractions at first; the categorical
// draws do not depend on their scale):
//
//   1. each row r: its CDF, the running sum of P[r, c] * w[c] in column
//      order; its mass is the last; a row whose mass is not positive is
//      skipped;
//   2. the row's count n splits over the columns as a multinomial of its
//      CDF: n <= kMaxTrials as n categorical trials, each the first
//      column whose CDF exceeds a uniform times the mass (a binary
//      search); n > kMaxTrials as binomial splits column by column
//      (remaining count over remaining mass), each binomial by inversion
//      when n min(p, 1 - p) < 10 and by BTRS (Hoermann 1993) above;
//   3. the integer draws add into per-column path counts in shared memory
//      (integer atomics, a warp's trials of one column in one atomic:
//      neither order nor grouping can change the sum);
//   4. each column draws w[c] = Gamma(path count + gamma): a sum of
//      count + 1 exponentials (one log of a product of uniforms) for
//      gamma = 1 and a count of at most 3, else Marsaglia-Tsang (the
//      normal by Box-Muller with cospi, with the shape + 1 boost below
//      shape 1);
//   5. the sum of the draws: each block of 32 columns by a xor butterfly
//      (lane 0's value), the blocks in order; the fractions are w / sum.
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
// comparison.  Nothing in a job's arithmetic depends on the team or the
// CTAs that run it.
//
// Layout: one block (or cluster) per job, two barriers per iteration.  The trials of
// the job's rows of 1..kMaxTrials reads are numbered once (a prefix over
// the rows, computed when the block starts) and cut into one equal
// segment per warp; a warp builds the CDFs of the rows its segment
// touches (a lane per row), then draws its segment's trials 32 at a time
// (a lane finds its trial's row, then its column, by binary search), and
// its share of the rows over kMaxTrials reads (one lane per row);
// barrier; threads over columns draw the Gamma variates and each warp
// sums its blocks of 32; barrier; the kept fractions are written.  The
// CDFs and P live in shared memory: a job too large for one CTA's splits
// its rows over a thread-block cluster of up to 8 CTAs, each with its
// rows' CDFs, P and trials, whose Gamma steps all draw the same variates
// from the cluster's summed counts (read through distributed shared
// memory).  A job too large for that keeps its CDFs and a transposed P in
// a global scratch.  What bounds it on an H100: the chain of S x thin
// dependent iterations per job (2,500 at -n 100), each a few serial chains (a
// row's C multiply-adds, a trial's Philox rounds and two binary searches,
// a Gamma draw's transcendentals); the bytes and operations are far below
// a millisecond (chip_smoke.py phase 7).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

// Cycle probes for tools/torch_gibbs_profile.py: a build with
// -DRPVG_GIBBS_PROFILE adds, in thread 0 of block 0, the cycles between
// consecutive marks of an iteration into g_prof.
#ifdef RPVG_GIBBS_PROFILE
__device__ long long g_prof[8];
#define PROF_START long long prof_t = clock64()
#define PROF_MARK(i)                                                 \
  do {                                                               \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                       \
      const long long prof_now = clock64();                          \
      g_prof[i] += prof_now - prof_t;                                \
      prof_t = prof_now;                                             \
    }                                                                \
  } while (0)
#else
#define PROF_START
#define PROF_MARK(i)
#endif

namespace gibbs_rc {

namespace cg = cooperative_groups;

// Counter word 3: what is drawn (high byte) and the attempt (low 24 bits).
constexpr uint32_t kTagCategorical = 0u << 24;  // (t, row, trial)
constexpr uint32_t kTagBinomial = 1u << 24;     // (t, row, column) | attempt
constexpr uint32_t kTagExponential = 2u << 24;  // (t, column, factor / 2)
constexpr uint32_t kTagNormal = 3u << 24;       // (t, column, attempt)
constexpr uint32_t kTagAccept = 4u << 24;       // (t, column, attempt)
constexpr uint32_t kTagBoost = 5u << 24;        // (t, column, 0)
constexpr uint32_t kMaxAttempts = 1u << 20;
// Rows of at most kMaxTrials reads draw one categorical trial per read;
// larger rows split by binomials.
constexpr int64_t kMaxTrials = 16384;

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// The binomial draws run only for rows over kMaxTrials reads: kept out of
// line, so that the iteration's hot code stays small.
__device__ __noinline__ int64_t binomial_inversion(int64_t n, double p, uint64_t seed,
                                                   uint32_t t, uint32_t r, uint32_t c) {
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

__device__ __noinline__ int64_t binomial_btrs(int64_t n, double p, uint64_t seed, uint32_t t,
                                              uint32_t r, uint32_t c) {
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

// Gamma(shape) for shape >= 1, Marsaglia and Tsang (2000), from its
// attempt `first` on.
__device__ __noinline__ double gamma_mt(double shape, uint64_t seed, uint32_t t, uint32_t c,
                                        uint32_t first) {
  const double d = shape - 1.0 / 3.0;
  const double cm = 1.0 / sqrt(9.0 * d);
  for (uint32_t attempt = first; attempt < kMaxAttempts; ++attempt) {
    const philox::Uniforms g = philox::draw(seed, t, c, attempt, kTagNormal);
    const double x = sqrt(-2.0 * log(g.u0)) * cospi(2.0 * g.u1);
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

// Gamma(count + gamma): for gamma = 1 and a count of at most 3 the sum of
// count + 1 exponentials, else Marsaglia-Tsang (shape + 1 and a boost
// below shape 1).  The lanes of a warp draw different counts, and a
// branch per method would run them one group after another: so every lane
// computes the exponentials and Marsaglia-Tsang's first attempt in
// straight-line code (independent draws, their latencies overlapping) and
// keeps its method's value; only a rejected first attempt loops.  The
// numbers are those of the two methods written as branches.
__device__ double gamma_draw(double count, double gamma, uint64_t seed, uint32_t t,
                             uint32_t c) {
  const bool small = gamma == 1.0 && count <= 3.0;
  const double shape0 = count + gamma;
  const bool boost = shape0 < 1.0;
  const double shape = boost ? shape0 + 1.0 : shape0;
  const philox::Uniforms e0 = philox::draw(seed, t, c, 0, kTagExponential);
  const philox::Uniforms e1 = philox::draw(seed, t, c, 1, kTagExponential);
  const philox::Uniforms g = philox::draw(seed, t, c, 0, kTagNormal);
  const double u = philox::draw(seed, t, c, 0, kTagAccept).u0;
  const double ub = philox::draw(seed, t, c, 0, kTagBoost).u0;
  // The exponentials: the product of the first count + 1 uniforms.
  const int k = small ? static_cast<int>(count) + 1 : 1;
  double prod = e0.u0;
  prod = k > 1 ? prod * e0.u1 : prod;
  prod = k > 2 ? prod * e1.u0 : prod;
  prod = k > 3 ? prod * e1.u1 : prod;
  const double exponentials = -log(prod);
  // Marsaglia-Tsang, attempt 0.
  const double d = shape - 1.0 / 3.0;
  const double cm = 1.0 / sqrt(9.0 * d);
  const double x = sqrt(-2.0 * log(g.u0)) * cospi(2.0 * g.u1);
  const double v1 = 1.0 + cm * x;
  const double v = v1 * v1 * v1;
  const double x2 = x * x;
  const bool accept = v1 > 0.0 && (u < 1.0 - 0.0331 * (x2 * x2) ||
                                   log(u) < 0.5 * x2 + d * (1.0 - v + log(v)));
  if (small) return exponentials;
  double draw = accept ? d * v : gamma_mt(shape, seed, t, c, 1);
  if (boost) draw *= exp(log(ub) / shape0);
  return draw;
}

// The row's CDF: the running sum of P[r, c] * w[c] in column order, the
// row's entry c at row[c * stride] and its CDF at cdf[c * stride].  P and
// the CDFs are held transposed (stride R), so that the lanes of a warp, a
// row each, touch consecutive words: one line in global memory, no bank
// conflict in shared memory.  Eight entries are loaded ahead of their
// multiply-adds, so that a load's latency is paid once per eight.
__device__ void row_cdf(const double* __restrict__ row, const double* __restrict__ w, int64_t C,
                        int64_t stride, double* __restrict__ cdf) {
  double acc = 0.0;
  int64_t c = 0;
  for (; c + 8 <= C; c += 8) {
    double p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = row[(c + i) * stride];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc += p[i] * w[c + i];
      cdf[(c + i) * stride] = acc;
    }
  }
  for (; c < C; ++c) {
    acc += row[c * stride] * w[c];
    cdf[c * stride] = acc;
  }
}

// How many of the first n entries v[0], v[stride], ... of a
// non-decreasing sequence are <= x: a binary search in power-of-two
// steps, no data-dependent loop bound.
template <typename T>
__device__ __forceinline__ int64_t count_at_most(const T* v, int64_t stride, int64_t n, T x) {
  int64_t pos = 0;
  for (int64_t step = n > 0 ? int64_t{1} << (63 - __clzll(n)) : 0; step > 0; step >>= 1) {
    if (pos + step <= n && !(x < v[(pos + step - 1) * stride])) pos += step;
  }
  return pos;
}

// The first index in [0, n) whose value v[index * stride] exceeds x (n
// when none).
__device__ __forceinline__ int64_t upper_bound(const double* v, int64_t stride, int64_t n,
                                               double x) {
  return count_at_most(v, stride, n, x);
}

// The last row r in [lo, hi] with start[r] <= i (start[lo] <= i): the row
// whose trials hold trial i.
__device__ __forceinline__ int64_t row_of(const int32_t* start, int64_t lo, int64_t hi,
                                          int64_t i) {
  return lo + count_at_most(start + lo, 1, hi - lo + 1, static_cast<int32_t>(i)) - 1;
}

// One more read in path_counts[column] for every lane whose column is not
// negative: the lanes of a column add their number in one atomic (integer
// counts, a native shared-memory add where a double add would be a
// compare-and-swap loop; neither order nor grouping changes the sum).
__device__ void add_reads(int* path_counts, int64_t column) {
  const unsigned peers = __match_any_sync(0xffffffffu, static_cast<long long>(column));
  if (column >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(path_counts + column, __popc(peers));
  }
}

// A row's count n > kMaxTrials split column by column, added to path_counts.
__device__ __noinline__ void binomial_split(const double* __restrict__ row, const double* w,
                                            int64_t C, int64_t n, int* path_counts,
                                            uint64_t seed, uint32_t t, uint32_t r) {
  double row_sum = 0.0;
  for (int64_t c = 0; c < C; ++c) row_sum += row[c] * w[c];
  if (!(row_sum > 0.0)) return;
  int64_t remaining = n;
  double remaining_p = row_sum;
  for (int64_t c = 0; c < C && remaining > 0; ++c) {
    const double post = row[c] * w[c];
    double ratio = remaining_p > 0.0 ? post / remaining_p : 0.0;
    ratio = fmin(1.0, fmax(0.0, ratio));
    int64_t draw = 0;
    if (c == C - 1 || ratio >= 1.0) {
      draw = remaining;
    } else if (ratio > 0.0) {
      draw = binomial(remaining, ratio, seed, t, r, static_cast<uint32_t>(c));
    }
    if (draw) atomicAdd(path_counts + c, static_cast<int>(draw));
    remaining -= draw;
    remaining_p -= post;
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
  const int64_t* job_scratch; // job -> its scratch (unstaged)
  double* scratch;
  int64_t thin_its;
  double gamma;
  int staged;                 // CDFs and P in shared memory, else in the scratch
  int ctas;                   // CTAs per job (a cluster; staged only when above 1)
  double* out;
};

__global__ void __launch_bounds__(512) gibbs_kernel(Jobs jobs) {
  extern __shared__ double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = jobs.ctas;
  const int rank = ctas > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int64_t job = jobs.job_ids[blockIdx.x / ctas];
  const int64_t task = jobs.task_ids[job];
  const int64_t R_all = jobs.n_rows[task];
  const int64_t C = jobs.n_cols[task];
  const uint64_t seed = static_cast<uint64_t>(jobs.seeds[job]);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nthreads >> 5;
  const int64_t blocks = (C + 31) / 32;
  // This CTA's rows [r0, r0 + R) of the job's R_all.
  const int64_t rows_per = (R_all + ctas - 1) / ctas;
  const int64_t r0 = lmin(R_all, rank * rows_per);
  const int64_t R = lmin(R_all, r0 + rows_per) - r0;
  const double* counts = jobs.counts + jobs.row_offsets[task] + r0;
  const double* P = jobs.probs + jobs.mat_offsets[task] + r0 * C;

  // Shared memory: w, the path counts (int, two buffers), the blocks'
  // sums, then when staged the CDFs, P transposed, and as int32 the trial
  // starts (R + 1), the number of rows over kMaxTrials reads and those
  // rows (at most R).  Unstaged, the CDFs, the int32 arrays and P
  // transposed (written before the block's first barrier, which makes it
  // visible to the block) are the job's scratch.  A job split over a
  // cluster of CTAs (staged only) gives each CTA a slice of its rows.
  double* w = smem;                               // C
  int* acc = reinterpret_cast<int*>(w + C);       // 2 x C path counts, in C doubles' room
  double* part = w + 2 * C;                       // blocks
  double* next = part + blocks;
  double* scratch = jobs.scratch + jobs.job_scratch[job];
  // P transposed, pt[c * R + r] = P[r, c], and the CDFs laid out alike:
  // in shared memory when staged, else in the scratch.
  double* cdf = jobs.staged ? next : scratch;
  double* pt = jobs.staged ? next + R * C : scratch + R * C + R + 1;
  int32_t* start = reinterpret_cast<int32_t*>(jobs.staged ? next + 2 * R * C : scratch + R * C);
  for (int64_t i = tid; i < R * C; i += nthreads) pt[(i % C) * R + i / C] = P[i];
  int32_t* big = start + R + 2;
  for (int64_t c = tid; c < C; c += nthreads) {
    w[c] = jobs.init_fracs[jobs.frac_offsets[job] + c];
    acc[c] = 0;
    acc[C + c] = 0;
  }
  if (tid == 0) {
    int32_t at = 0, m = 0;
    for (int64_t r = 0; r < R; ++r) {
      const int64_t n = static_cast<int64_t>(counts[r]);
      start[r] = at;
      if (n > kMaxTrials) {
        big[m++] = static_cast<int32_t>(r);
      } else if (n > 0) {
        at += static_cast<int32_t>(n);
      }
    }
    start[R] = at;
    start[R + 1] = m;
  }
  // The whole cluster has started before any CTA reads another's counts.
  if (ctas > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  // This warp's segment of the trials, and the rows it touches.
  const int64_t n_trials = start[R];
  const int32_t n_big = start[R + 1];
  const int64_t seg = (n_trials + n_warps - 1) / n_warps;
  const int64_t t0 = lmin(n_trials, warp * seg);
  const int64_t t1 = lmin(n_trials, t0 + seg);
  const int64_t ra = t1 > t0 ? row_of(start, 0, R - 1, t0) : 0;
  const int64_t rb = t1 > t0 ? row_of(start, ra, R - 1, t1 - 1) : -1;

  const int64_t iterations = jobs.n_samples[job] * jobs.thin_its;
  double* out = jobs.out + jobs.out_offsets[job];
  for (int64_t it = 0; it < iterations; ++it) {
    const uint32_t t = static_cast<uint32_t>(it);
    // This iteration's counts; the other buffer was read by the cluster's
    // Gamma steps of the last iteration, all done once the barrier below
    // is passed, and is zeroed for the next.
    int* count = acc + (it & 1) * C;
    int* other = acc + ((it + 1) & 1) * C;
    PROF_START;
    // 1-3. This warp's rows' CDFs, then its trials and its share of the
    // rows over kMaxTrials reads.
    for (int64_t r = ra + lane; r <= rb; r += 32) {
      if (start[r + 1] > start[r]) row_cdf(pt + r, w, C, R, cdf + r);
    }
    __syncwarp();
    PROF_MARK(0);
    for (int64_t i0 = t0; i0 < t1; i0 += 32) {
      const int64_t i = i0 + lane;
      int64_t column = -1;
      if (i < t1) {
        const int64_t r = row_of(start, ra, rb, i);
        const double* row = cdf + r;
        const double mass = row[(C - 1) * R];
        if (mass > 0.0) {
          const double x = philox::draw(seed, t, static_cast<uint32_t>(r0 + r),
                                        static_cast<uint32_t>(i - start[r]), kTagCategorical)
                               .u0 *
                           mass;
          column = lmin(upper_bound(row, R, C, x), C - 1);
        }
      }
      add_reads(count, column);
    }
    for (int32_t m = warp * 32 + lane; m < n_big; m += nthreads) {
      const int32_t r = big[m];
      binomial_split(P + r * C, w, C, static_cast<int64_t>(counts[r]), count, seed, t,
                     static_cast<uint32_t>(r0 + r));
    }
    PROF_MARK(1);
    if (ctas > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    PROF_MARK(2);
    // 4-5. The Gamma draws, from every CTA's counts (each CTA of a cluster
    // draws the same), and each block of 32 columns' sum.
    for (int64_t c0 = warp * 32; c0 < C; c0 += nthreads) {
      const int64_t c = c0 + lane;
      double draw = 0.0;
      if (c < C) {
        int n = count[c];
        for (int k = 0; k < ctas; ++k) {
          if (k != rank) n += cluster.map_shared_rank(count, k)[c];
        }
        draw = gamma_draw(static_cast<double>(n), jobs.gamma, seed, t, static_cast<uint32_t>(c));
        w[c] = draw;
        other[c] = 0;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) draw += __shfl_xor_sync(0xffffffffu, draw, off);
      if (lane == 0) part[c0 / 32] = draw;
    }
    PROF_MARK(3);
    __syncthreads();
    PROF_MARK(4);
    if (rank == 0 && (it + 1) % jobs.thin_its == 0) {
      double* kept = out + ((it + 1) / jobs.thin_its - 1) * C;
      for (int64_t c = tid; c < C; c += nthreads) {
        double sum = 0.0;
        for (int64_t b = 0; b < blocks; ++b) sum += part[b];
        kept[c] = w[c] / sum;
      }
    }
    PROF_MARK(5);
  }
  // No CTA leaves while another may still read its counts.
  if (ctas > 1) cluster.sync();
}

}  // namespace gibbs_rc

// One launch over the n_jobs jobs listed in job_ids (int64, on the
// device), each a cluster of `ctas` CTAs (1, or up to 8 when staged) of
// `threads` threads (a multiple of 32, at most 512), with smem_bytes of
// shared memory per CTA, on `stream`.  staged = 1 keeps each CTA's rows'
// CDFs and P in shared memory; staged = 0 keeps the CDFs, the row tables
// and a transposed P at scratch + job_scratch[j] (2 R x C + R + 1
// doubles).  Job j samples task task_ids[j] of the ragged set
// (probs/counts by mat_offsets and row_offsets, shape n_rows x n_cols),
// from init_fracs at frac_offsets[j], with the Philox stream keyed by
// seeds[j], and writes n_samples[j] x C fractions at out_offsets[j] of
// out.  Returns the launch's CUDA error.
extern "C" int rpvg_gibbs_readcount_f64(
    const void* probs, const void* counts, const void* init_fracs, const void* seeds,
    const void* mat_offsets, const void* row_offsets, const void* n_rows, const void* n_cols,
    const void* task_ids, const void* frac_offsets, const void* out_offsets,
    const void* n_samples, const void* job_ids, const void* job_scratch, void* scratch,
    int64_t n_jobs, int64_t thin_its, double gamma, int64_t threads, int64_t staged, int64_t ctas,
    int64_t smem_bytes, void* out, void* stream) {
  if (n_jobs <= 0) return 0;
  const gibbs_rc::Jobs jobs{
      static_cast<const double*>(probs),        static_cast<const double*>(counts),
      static_cast<const double*>(init_fracs),   static_cast<const int64_t*>(seeds),
      static_cast<const int64_t*>(mat_offsets), static_cast<const int64_t*>(row_offsets),
      static_cast<const int64_t*>(n_rows),      static_cast<const int64_t*>(n_cols),
      static_cast<const int64_t*>(task_ids),    static_cast<const int64_t*>(frac_offsets),
      static_cast<const int64_t*>(out_offsets), static_cast<const int64_t*>(n_samples),
      static_cast<const int64_t*>(job_ids),     static_cast<const int64_t*>(job_scratch),
      static_cast<double*>(scratch),            thin_its,
      gamma,                                    static_cast<int>(staged),
      static_cast<int>(ctas),                   static_cast<double*>(out)};
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(gibbs_rc::gibbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_jobs * ctas));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = ctas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, gibbs_rc::gibbs_kernel, jobs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
