// Collapsed Gibbs sampler of diploid haplotype pairs, float64 scores,
// several clusters per block.
//
// Replaces the XLA device function
// rpvg_tpu/infer/posteriors.py::_gibbs_chains_vmapped (core
// _gibbs_chains_core; reference sampler src/path_estimator.cpp:475-589).
// At ploidy 2 the conditional of one slot given the other slot's path o
// is a categorical over row o of the (P, P) pair log-likelihood matrix
// (the + lf[o] term is the same for every candidate and cancels), so the
// conditionals never change: the native twin rpvg_posterior_gibbs_ragged
// (csrc/host/rpvg_native.cpp) caches each row's CDF, and so does this
// kernel, for every row at once:
//
//   1. a warp per row o (a block's warps over its clusters' rows): the
//      row read coalesced into registers, its maximum m by a butterfly,
//      the terms exp(score[o, p] - m) (1 for a row with no finite
//      maximum), their inclusive prefix sums by a warp scan per 32
//      columns (Hillis-Steele: lane i adds lane i - d for d = 1, 2, 4, 8,
//      16; then a running maximum the same way, since lanes that sum in
//      other orders may round 1 ulp apart; then the previous columns'
//      total), each times one reciprocal of the row's total;
//   2. a lane per chain: the two slots start uniform over the P paths,
//      then burn + its steps each draw slot 0 given slot 1 and slot 1
//      given the new slot 0, by a branch-free binary search for the first
//      CDF entry not below the step's uniform; the next step's Philox draw
//      (it depends on the counter alone) is computed beside this step's
//      searches; the pairs after burn-in are written out.
//
// Measured and not kept (PERF.md): a guide table per row (bucket
// floor(u P) -> first column of its bucket, then a walk or a search
// between two buckets), slower than the branch-free search at these
// sizes (its lanes' probe counts differ, and a warp waits for the
// longest); every step's uniforms drawn first by all the block's threads
// into a global scratch, no faster than drawing them beside the searches.
//
// Random bits: Philox4x32-10 (philox.cuh) keyed by the cluster's 64-bit
// seed, at counter (chain, step, 0, tag): each chain is its own stream.
// rpvg_tpu_torch/ops/posterior_gibbs_cuda.py posterior_gibbs_plain
// repeats this arithmetic in PyTorch on the same counters (the same scan
// order and reciprocal); its exponentials may differ from the kernel's in
// the last bit, so a chain leaves the plain version's only where that
// flips a search.
//
// Packing (posterior_gibbs_cuda.plan_launches): a block of 8 warps holds
// several clusters, as many as 48 KB of shared memory, 256 chains and 256
// rows allow (a cluster whose CDFs need more has a block of its own).  Its warps build the rows of all of them (warp w the rows w,
// w + 8, ... of their concatenation), then after one block barrier its
// threads run all their chains (thread t the chains t, t + 256, ...), so
// a warp's lanes carry the chains of two or three small clusters at once
// instead of one cluster's ten.  A cluster's CDFs (8 P^2 bytes) are
// staged at its offset of the block's shared memory, or, past
// a block's shared memory, in a global scratch of the same layout (a
// launch of its own).  What bounds it on an H100: the serial steps of one
// chain (burn + its, 150 + 0.15 P), a Philox draw and two dependent draws
// each; bytes and operations are far below a millisecond at the main
// path's sizes (chip_smoke.py phase 8).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "philox.cuh"

namespace gibbs_post {

constexpr uint32_t kTagInit = 0u << 24;  // (chain, 0, 0)
constexpr uint32_t kTagStep = 1u << 24;  // (chain, step, 0)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Clusters {
  const double* scores;
  const int64_t* score_offsets;  // cluster -> first score
  const int64_t* strides;        // cluster -> row stride of its scores
  const int64_t* n_cols;
  const int64_t* n_chains;
  const int64_t* n_burn;
  const int64_t* n_its;
  const int64_t* seeds;
  const int64_t* table_offsets;  // cluster -> byte offset of its tables in its block's shared
                                 // memory (staged) or in the scratch
  const int64_t* out_offsets;    // cluster -> first int32 of its pairs
  const int64_t* block_clusters; // this launch's clusters, block by block
  const int64_t* block_starts;   // this launch's blocks -> first of their clusters (n + 1)
  unsigned char* scratch;
  int32_t* out;
};

// Row o's CDF (normalised prefix sums of exp(score - max)), by one warp,
// the row in registers: kChunks chunks of 32 columns, at least
// ceil(P / 32).
template <int kChunks>
__device__ __forceinline__ void build_row(const double* row, int P, double* cdf) {
  const int lane = threadIdx.x & 31;
  double x[kChunks];
  double m = -CUDART_INF;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = 32 * c + lane;
    x[c] = p < P ? row[p] : -CUDART_INF;
    m = fmax(m, x[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_xor_sync(kFull, m, off));
  const bool finite = isfinite(m);
  // Each chunk's inclusive scan, then its running maximum (lanes sum the
  // same terms in other orders, which may round 1 ulp apart; the maximum
  // is exact and keeps the row nondecreasing), chunks side by side; then
  // the previous chunks' total added in order (a sum rounded after the
  // maximum equals the maximum of the sums rounded: rounding is
  // monotone).
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = 32 * c + lane;
    x[c] = p < P ? (finite ? exp(x[c] - m) : 1.0) : 0.0;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const double y = __shfl_up_sync(kFull, x[c], d);
      if (lane >= d) x[c] += y;
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const double y = __shfl_up_sync(kFull, x[c], d);
      if (lane >= d) x[c] = fmax(x[c], y);
    }
  }
  double carry = 0.0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    x[c] += carry;
    carry = __shfl_sync(kFull, x[c], 31);
  }
  const double rinv = 1.0 / carry;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p = 32 * c + lane;
    if (p < P) cdf[p] = x[c] * rinv;
  }
}

// A row of any P: chunks of 32 columns, the row read twice.
__device__ __forceinline__ void build_wide_row(const double* row, int P, double* cdf) {
  const int lane = threadIdx.x & 31;
  double m = -CUDART_INF;
  for (int p = lane; p < P; p += 32) m = fmax(m, row[p]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_xor_sync(kFull, m, off));
  const bool finite = isfinite(m);
  double carry = 0.0;
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    double x = p < P ? (finite ? exp(row[p] - m) : 1.0) : 0.0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = fmax(x, y);
    }
    x += carry;
    if (p < P) cdf[p] = x;
    carry = __shfl_sync(kFull, x, 31);
  }
  const double rinv = 1.0 / carry;
  for (int p = lane; p < P; p += 32) cdf[p] = cdf[p] * rinv;
}

// The first column whose CDF entry is not below u, or P - 1 (lower_bound
// clamped), by halving without branches: every lane of one P takes the
// same ceil(log2 P) + 1 probes.
template <typename Index>
__device__ __forceinline__ int search(const double* cdf, int P, double u) {
  int base = 0;
  for (int n = P; n > 1;) {
    const int half = n >> 1;
    base = cdf[static_cast<Index>(base) + half] < u ? base + half : base;
    n -= half;
  }
  base += cdf[static_cast<Index>(base)] < u;
  return base < P ? base : P - 1;
}

// kStaged: the block's clusters' CDFs in its shared memory (32-bit
// offsets), else in the global scratch.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) posterior_gibbs_kernel(Clusters cl) {
  using Index = typename std::conditional<kStaged, int, int64_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tables = kStaged ? smem : cl.scratch;
  const int warp = threadIdx.x >> 5;
  const int64_t begin = cl.block_starts[blockIdx.x];
  const int64_t end = cl.block_starts[blockIdx.x + 1];

  int row0 = 0;
  for (int64_t q = begin; q < end; ++q) {
    const int64_t b = cl.block_clusters[q];
    const int P = static_cast<int>(cl.n_cols[b]);
    const int64_t stride = cl.strides[b];
    const double* scores = cl.scores + cl.score_offsets[b];
    double* cdf = reinterpret_cast<double*>(tables + cl.table_offsets[b]);
    for (int o = (warp - row0 + kWarps) % kWarps; o < P; o += kWarps) {
      const double* from = scores + o * stride;
      double* to = cdf + static_cast<Index>(o) * P;
      if (P <= 32) {
        build_row<1>(from, P, to);
      } else if (P <= 64) {
        build_row<2>(from, P, to);
      } else if (P <= 128) {
        build_row<4>(from, P, to);
      } else if (P <= 256) {
        build_row<8>(from, P, to);
      } else {
        build_wide_row(from, P, to);
      }
    }
    row0 = (row0 + P) % kWarps;
  }
  __syncthreads();

  // Thread t runs the chains t, t + kThreads, ... of the concatenation of
  // the block's clusters' chains: it finds its cluster first, so that the
  // lanes of a warp step their chains together whatever their clusters.
  for (int g = threadIdx.x;; g += kThreads) {
    int64_t b = -1;
    int chain = g;
    for (int64_t q = begin; q < end; ++q) {
      const int n = static_cast<int>(cl.n_chains[cl.block_clusters[q]]);
      if (chain < n) {
        b = cl.block_clusters[q];
        break;
      }
      chain -= n;
    }
    if (b < 0) break;
    const int P = static_cast<int>(cl.n_cols[b]);
    const double Pd = static_cast<double>(P);
    const double* cdf = reinterpret_cast<const double*>(tables + cl.table_offsets[b]);
    const uint64_t seed = static_cast<uint64_t>(cl.seeds[b]);
    const int burn = static_cast<int>(cl.n_burn[b]);
    const int its = static_cast<int>(cl.n_its[b]);
    const philox::Uniforms init =
        philox::draw(seed, static_cast<uint32_t>(chain), 0, 0, kTagInit);
    int g0 = static_cast<int>(floor(init.u0 * Pd));
    int g1 = static_cast<int>(floor(init.u1 * Pd));
    g0 = g0 < P ? g0 : P - 1;
    g1 = g1 < P ? g1 : P - 1;
    int2* pairs = reinterpret_cast<int2*>(cl.out + cl.out_offsets[b]) +
                  static_cast<int64_t>(chain) * its;
    // Two steps a pass, the Philox draw of the next step computed beside
    // this step's searches (it depends on the counter alone, and the
    // searches are branch-free, so the two interleave).
    auto step = [&](int it, const philox::Uniforms& d) {
      g0 = search<Index>(cdf + static_cast<Index>(g1) * P, P, d.u0);
      g1 = search<Index>(cdf + static_cast<Index>(g0) * P, P, d.u1);
      if (it >= burn) pairs[it - burn] = make_int2(g0, g1);
    };
    const uint32_t ch = static_cast<uint32_t>(chain);
    philox::Uniforms even = philox::draw(seed, ch, 0, 0, kTagStep);
    for (int it = 0; it < burn + its; it += 2) {
      const philox::Uniforms odd =
          philox::draw(seed, ch, static_cast<uint32_t>(it + 1), 0, kTagStep);
      step(it, even);
      if (it + 1 < burn + its) {
        even = philox::draw(seed, ch, static_cast<uint32_t>(it + 2), 0, kTagStep);
        step(it + 1, odd);
      }
    }
  }
}

}  // namespace gibbs_post

// One launch of n_blocks blocks of 8 warps on `stream`: block i runs the
// clusters block_clusters[block_starts[i] .. block_starts[i + 1] - 1]
// (int64, on the device), their CDFs staged in smem_bytes of dynamic
// shared memory (staged = 1) or in scratch (staged = 0) at
// table_offsets.  Cluster b's (P, P) scores start at score_offsets[b] with
// row stride strides[b]; its CDFs take 8 P^2 bytes; it runs n_chains[b]
// chains of n_burn[b] + n_its[b] steps with the Philox stream keyed by
// seeds[b], and writes
// n_chains[b] x n_its[b] int32 pairs at out_offsets[b] of out.  Returns
// cudaGetLastError().
extern "C" int rpvg_gibbs_posterior_f64(
    const void* scores, const void* score_offsets, const void* strides, const void* n_cols,
    const void* n_chains, const void* n_burn, const void* n_its, const void* seeds,
    const void* table_offsets, const void* out_offsets, const void* block_clusters,
    const void* block_starts, int64_t n_blocks, int64_t staged, int64_t smem_bytes, void* scratch,
    void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  const gibbs_post::Clusters cl{
      static_cast<const double*>(scores),          static_cast<const int64_t*>(score_offsets),
      static_cast<const int64_t*>(strides),        static_cast<const int64_t*>(n_cols),
      static_cast<const int64_t*>(n_chains),       static_cast<const int64_t*>(n_burn),
      static_cast<const int64_t*>(n_its),          static_cast<const int64_t*>(seeds),
      static_cast<const int64_t*>(table_offsets),  static_cast<const int64_t*>(out_offsets),
      static_cast<const int64_t*>(block_clusters), static_cast<const int64_t*>(block_starts),
      static_cast<unsigned char*>(scratch),        static_cast<int32_t*>(out)};
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const dim3 block(gibbs_post::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(gibbs_post::posterior_gibbs_kernel<true>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gibbs_post::posterior_gibbs_kernel<true><<<grid, block, static_cast<size_t>(smem_bytes), s>>>(cl);
  } else {
    gibbs_post::posterior_gibbs_kernel<false><<<grid, block, 0, s>>>(cl);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the staged kernel resident on one SM at smem_bytes of dynamic
// shared memory (the occupancy API); -1 on error.
extern "C" int rpvg_gibbs_posterior_blocks_per_sm(int64_t smem_bytes) {
  if (smem_bytes > 48 * 1024 &&
      cudaFuncSetAttribute(gibbs_post::posterior_gibbs_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes)) != cudaSuccess) {
    return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gibbs_post::posterior_gibbs_kernel<true>,
                                                    gibbs_post::kThreads,
                                                    static_cast<size_t>(smem_bytes)) != cudaSuccess) {
    return -1;
  }
  return blocks;
}
