// Multiset group log-likelihoods of the full enumeration, float64, over
// ragged clusters.
//
// Replaces the XLA device function
// rpvg_tpu/infer/posteriors.py::_group_scores_chunk (under
// full_posteriors_batched; the reference's enumeration loop,
// src/path_posterior_estimator.cpp).  For cluster c (R rows, P paths,
// group size k) and group g, whose k path indices are row g of the
// cluster's (G, k) table (combinations_with_replacement(range(P), k)):
//
//   S[g] = sum_r counts[r] * log(noise[r] + (probs[r, i_0] + ... + probs[r, i_{k-1}]) / k)
//
// with -inf where the argument is <= 0.  The JAX function writes a
// (B, R, G) intermediate at each of its k gathers, its log and its
// contraction; here nothing but the (G,) scores leaves the chip.
//
// What bounds it on an H100: the FP64 log.  The H100 has no FP64 log
// instruction: libdevice's log is a sequence of FP64 fused multiply-adds
// and adds on the FP64 pipe (34 TFLOP/s without tensor cores), so the
// design computes as few logs as the sum allows and keeps the FP64 pipe
// fed.  A group's last slot l = i_{k-1} is factored out.  With
//
//   L[r, l] = log(noise[r] + probs[r, l] / k)             (R x P logs)
//   U(g)    = rows of non-positive noise, and rows of nonzero count where
//             a path of the group's first k - 1 slots has a nonzero
//             probability,
//
// every row outside U(g) adds exactly counts[r] * L[r, l] (its slot sum
// is probs[r, l]: adding zeros is exact), so
//
//   S[g] = sum_r' counts[r'] L[r', l]  +  sum_{r in U(g)} counts[r] (log(...) - L[r, l])
//
// (r' over rows of positive noise; a row of non-positive noise adds its
// own term, -inf or NaN exactly where the plain version has them).  Two
// grids on one stream:
//
//   1. prepare: a block per word of 32 rows of a cluster computes the
//      word's L, stored beside the probabilities as (p, L) pairs and the
//      rows as (noise, count) pairs (one 16-byte load each), per path the
//      word's sum of counts x L and the bits of the rows that a nonzero
//      probability of that path puts in U (a ballot), and the bits of its
//      rows of non-positive noise;
//   2. score: a block of 8 warps per 256 / S consecutive groups of one
//      cluster, a lane per group: the S warps of a tile of 32 groups each
//      walk 1 / S of the cluster's row words, and their sums are added in
//      a fixed order through shared memory (S = 1-8 by the rows, so that
//      the largest clusters' warps are not the run's tail).  Groups of one
//      prefix (i_0 .. i_{k-2}) are consecutive in the table's order, so the
//      lanes of a warp mostly share their row words, and a lane walks each
//      word's rows by its bits (two rows a pass: two independent log chains
//      in flight).  The loads are the same address for the lanes of a
//      prefix (bit words, rows, the prefix's probabilities) or consecutive
//      (the (p, L) pairs over consecutive l), read through L1: staging a
//      cluster in shared memory measured slower (fewer blocks per SM).
//
// No division per (row, group): the slot sum is scaled by 1 / k, and the
// log is log_f64.cuh's, a third of libdevice's FP64 instructions.  Every
// sum runs in a fixed order (rows by word, then by bit), so the scores
// are bitwise the same from run to run.
//
// rpvg_tpu_torch/ops/group_scores_cuda.py group_scores_plain repeats the
// arithmetic of the JAX function in PyTorch (the same slot order of the
// k-term sum, the division by k) and group_scores_factored_plain this
// factoring; sums over r differ in order, so they agree to rounding.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "log_f64.cuh"

namespace group_scores {

// Group sizes up to this keep a lane's prefix indices in registers (in a
// build for k <= 4, the main path's, and one for k <= 8).
constexpr int kRegSlots = 8;
// Warps per block of the scoring grid, and the blocks per SM its registers
// are held to (32 warps to hide the FP64 log chains' latency).
constexpr int kWarps = 8;
constexpr int kMinBlocks = 4;
constexpr int kPrepareThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Clusters {
  const double* probs;
  const double* noise;
  const double* counts;
  const int32_t* table;
  const int64_t* mat_offsets;    // cluster -> first probability (and (p, L) pair)
  const int64_t* row_offsets;    // cluster -> first row
  const int64_t* n_rows;
  const int64_t* n_cols;
  const int64_t* table_offsets;  // cluster -> first int32 of its (G, k) table
  const int64_t* n_groups;
  const int64_t* out_offsets;    // cluster -> first score
  const int64_t* word_offsets;   // cluster -> its first word of 32 rows
  const int64_t* word_cluster;   // word -> cluster
  const int64_t* part_offsets;   // cluster -> its ceil(R / 32) x P word sums
  const int64_t* mask_offsets;   // cluster -> its ceil(R / 32) x (P + 1) bit words
  const int64_t* row_splits;     // cluster -> warps S per tile of 32 groups
  const int64_t* block_cluster;  // block -> cluster
  const int64_t* block_first;    // block -> its first group
  int group_size;
  double inv_k;
  double2* pairs;                // per (row, path): (probs, L)
  double2* rows;                 // per row: (noise, count)
  double* partials;              // per word and path: sum of counts x L
  uint32_t* masks;               // per word: P path words, then the noise word
  const double2* log_table;      // log_f64.cuh's table
  double* out;
};

// noise + slot sum / k as the plain version computes it on the card (the
// quotient by a scalar a product with its reciprocal, each rounded: no
// fused multiply-add), and its log, -inf where it is not positive.
__device__ __forceinline__ double log_term(double noise, double slot_sum, double inv_k,
                                           const double2* table) {
  const double v = __dadd_rn(noise, __dmul_rn(slot_sum, inv_k));
  return v > 0.0 ? log_f64::log_pos(v, table) : -CUDART_INF;
}

__device__ __forceinline__ void stage_log_table(const double2* from, double2* to) {
  for (int i = threadIdx.x; i < log_f64::kTableSize; i += blockDim.x) to[i] = from[i];
}

__global__ void __launch_bounds__(kPrepareThreads) prepare_kernel(Clusters cl) {
  __shared__ double2 table[log_f64::kTableSize];
  stage_log_table(cl.log_table, table);
  __syncthreads();
  const int64_t word = blockIdx.x;
  const int64_t c = cl.word_cluster[word];
  const int64_t w = word - cl.word_offsets[c];
  const int64_t R = cl.n_rows[c];
  const int64_t P = cl.n_cols[c];
  const int64_t r0 = 32 * w;
  const int n = static_cast<int>(R - r0 < 32 ? R - r0 : 32);
  const double* probs = cl.probs + cl.mat_offsets[c] + r0 * P;
  const double* noise = cl.noise + cl.row_offsets[c] + r0;
  const double* counts = cl.counts + cl.row_offsets[c] + r0;
  double2* pairs = cl.pairs + cl.mat_offsets[c] + r0 * P;

  for (int64_t e = threadIdx.x; e < n * P; e += blockDim.x) {
    const double nr = noise[e / P];
    const double p = probs[e];
    pairs[e] = make_double2(p, nr > 0.0 ? log_term(nr, p, cl.inv_k, table) : 0.0);
  }
  if (threadIdx.x < n) {
    cl.rows[cl.row_offsets[c] + r0 + threadIdx.x] =
        make_double2(noise[threadIdx.x], counts[threadIdx.x]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const bool row = lane < n;
  const double nr = row ? noise[lane] : 1.0;
  const double cr = row ? counts[lane] : 0.0;
  const bool bad = row && !(nr > 0.0);
  const bool live = row && (cr != 0.0 || bad);
  uint32_t* masks = cl.masks + cl.mask_offsets[c] + w * (P + 1);
  double* part = cl.partials + cl.part_offsets[c] + w * P;
  for (int64_t p = threadIdx.x >> 5; p < P; p += blockDim.x >> 5) {
    const double2 pr = row ? pairs[lane * P + p] : make_double2(0.0, 0.0);
    const uint32_t bits = __ballot_sync(kFull, live && pr.x != 0.0);
    double t = row && !bad ? cr * pr.y : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
    if (lane == 0) {
      masks[p] = bits;
      part[p] = t;
    }
  }
  if (threadIdx.x < 32) {
    const uint32_t bits = __ballot_sync(kFull, bad);
    if (lane == 0) masks[P] = bits;
  }
}

// kPrefix > 0: the group's first k - 1 path indices in registers
// (k - 1 <= kPrefix); kPrefix == 0: read from the table for every row.
template <int kPrefix>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) score_kernel(Clusters cl) {
  __shared__ double2 table[log_f64::kTableSize];
  __shared__ double sums[kWarps][32];
  stage_log_table(cl.log_table, table);
  __syncthreads();
  const int64_t c = cl.block_cluster[blockIdx.x];
  const int split = static_cast<int>(cl.row_splits[c]);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = warp % split;
  const int64_t g = cl.block_first[blockIdx.x] + 32 * (warp / split) + lane;
  const bool live = g < cl.n_groups[c];
  const int k = cl.group_size;
  const int R = static_cast<int>(cl.n_rows[c]);
  const int P = static_cast<int>(cl.n_cols[c]);
  const int words = (R + 31) >> 5;
  const int per = (words + split - 1) / split;
  const int w1 = min(words, (slice + 1) * per);
  const double2* pairs = cl.pairs + cl.mat_offsets[c];
  const double2* rows = cl.rows + cl.row_offsets[c];
  const double* part = cl.partials + cl.part_offsets[c];
  const uint32_t* masks = cl.masks + cl.mask_offsets[c];
  const double inv_k = cl.inv_k;
  const int32_t* idx = cl.table + cl.table_offsets[c] + (live ? g : 0) * k;

  constexpr int kSlots = kPrefix > 0 ? kPrefix : 1;
  int cols[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) cols[j] = kPrefix > 0 && j < k - 1 ? idx[j] : 0;
  const int last = idx[k - 1];

  // The row's term beyond counts[r] L[r, l]: the slot sum in slot order
  // (the prefix, then the last slot), its log, less L unless the noise is
  // not positive; times the count.
  auto term = [&](int r) {
    const double2* row = pairs + static_cast<int64_t>(r) * P;
    double s = 0.0;
    if (k > 1) {
      if (kPrefix > 0) {
        s = row[cols[0]].x;
#pragma unroll
        for (int j = 1; j < kSlots; ++j) {
          if (j < k - 1) s += row[cols[j]].x;
        }
      } else {
        s = row[idx[0]].x;
        for (int j = 1; j < k - 1; ++j) s += row[idx[j]].x;
      }
    }
    const double2 pl = row[last];
    s = k > 1 ? s + pl.x : pl.x;
    const double2 nc = rows[r];
    const double full = log_term(nc.x, s, inv_k, table);
    return nc.y * (nc.x > 0.0 ? full - pl.y : full);
  };

  double acc = 0.0;
  for (int w = live ? slice * per : w1; w < w1; ++w) {
    const uint32_t* mw = masks + static_cast<int64_t>(w) * (P + 1);
    acc += part[static_cast<int64_t>(w) * P + last];
    uint32_t m = mw[P];
    if (kPrefix > 0) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (j < k - 1) m |= mw[cols[j]];
      }
    } else {
      for (int j = 0; j < k - 1; ++j) m |= mw[idx[j]];
    }
    const int base = 32 * w;
    while (m) {
      const int r0 = base + __ffs(m) - 1;
      m &= m - 1;
      const bool two = m != 0;
      const int r1 = two ? base + __ffs(m) - 1 : r0;
      m &= m - 1;
      const double t0 = term(r0);
      const double t1 = term(r1);
      acc += t0;
      if (two) acc += t1;
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (live && slice == 0) {
    for (int j = 1; j < split; ++j) acc += sums[warp + j][lane];
    cl.out[cl.out_offsets[c] + g] = acc;
  }
}

template <typename Kernel>
int occupancy(Kernel kernel) {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * kWarps, 0) ==
                 cudaSuccess
             ? blocks
             : -1;
}

}  // namespace group_scores

// Two grids on `stream`: prepare over the n_words words of 32 rows
// (word_cluster), then score over the n_blocks blocks (block b: groups
// block_first[b] .. + 256 / S - 1 of cluster block_cluster[b], S =
// row_splits of it).  pairs (as many double2 as probs), rows (one double2
// a row), partials and masks are the caller's scratch at part_offsets /
// mask_offsets; log_table is log_f64.cuh's table (91 double2, on the
// device); cluster c writes n_groups[c] float64 scores at out_offsets[c]
// of out.  Returns the first failed launch's cudaGetLastError().
extern "C" int rpvg_group_scores_f64(
    const void* probs, const void* noise, const void* counts, const void* table,
    const void* mat_offsets, const void* row_offsets, const void* n_rows, const void* n_cols,
    const void* table_offsets, const void* n_groups, const void* out_offsets,
    const void* word_offsets, const void* word_cluster, const void* part_offsets,
    const void* mask_offsets, const void* row_splits, const void* block_cluster,
    const void* block_first, int64_t n_words, int64_t n_blocks, int64_t group_size, void* pairs,
    void* rows, void* partials, void* masks, const void* log_table, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  const group_scores::Clusters cl{
      static_cast<const double*>(probs),          static_cast<const double*>(noise),
      static_cast<const double*>(counts),         static_cast<const int32_t*>(table),
      static_cast<const int64_t*>(mat_offsets),   static_cast<const int64_t*>(row_offsets),
      static_cast<const int64_t*>(n_rows),        static_cast<const int64_t*>(n_cols),
      static_cast<const int64_t*>(table_offsets), static_cast<const int64_t*>(n_groups),
      static_cast<const int64_t*>(out_offsets),   static_cast<const int64_t*>(word_offsets),
      static_cast<const int64_t*>(word_cluster),  static_cast<const int64_t*>(part_offsets),
      static_cast<const int64_t*>(mask_offsets),  static_cast<const int64_t*>(row_splits),
      static_cast<const int64_t*>(block_cluster), static_cast<const int64_t*>(block_first),
      static_cast<int>(group_size),               1.0 / static_cast<double>(group_size),
      static_cast<double2*>(pairs),               static_cast<double2*>(rows),
      static_cast<double*>(partials),             static_cast<uint32_t*>(masks),
      static_cast<const double2*>(log_table),     static_cast<double*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_words > 0) {
    group_scores::prepare_kernel<<<dim3(static_cast<unsigned>(n_words)),
                                   dim3(group_scores::kPrepareThreads), 0, s>>>(cl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const dim3 block(32 * group_scores::kWarps);
  if (group_size <= 4) {
    group_scores::score_kernel<3><<<grid, block, 0, s>>>(cl);
  } else if (group_size <= group_scores::kRegSlots) {
    group_scores::score_kernel<group_scores::kRegSlots - 1><<<grid, block, 0, s>>>(cl);
  } else {
    group_scores::score_kernel<0><<<grid, block, 0, s>>>(cl);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the scoring grid resident on one SM at group size k (the
// occupancy API); -1 on error.
extern "C" int rpvg_group_scores_blocks_per_sm(int64_t group_size) {
  if (group_size <= 4) return group_scores::occupancy(group_scores::score_kernel<3>);
  if (group_size <= group_scores::kRegSlots) {
    return group_scores::occupancy(group_scores::score_kernel<group_scores::kRegSlots - 1>);
  }
  return group_scores::occupancy(group_scores::score_kernel<0>);
}
