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
// with -inf where the argument is <= 0, summed over r in row order.  The
// JAX function writes a (B, R, G) intermediate at each of its k gathers,
// its log and its contraction; here nothing but the (G,) scores leaves
// the chip.
//
// Design (the first, simple one): one block per (cluster, tile of 128
// groups), one thread per group.  A thread keeps its k column indices in
// registers (k <= kRegSlots; larger k reads them from the table through
// the cache) and walks the rows in order.  The cluster's probability
// rows are staged in shared memory, as many rows a pass as fit the
// block's dynamic shared memory; a cluster whose single row of P doubles
// does not fit reads them from global memory (staged = 0).  Noise and
// counts are the same address for every thread of a row: broadcast loads.
// The reads probs[r, i_j] of a warp's 32 groups hit scattered columns of
// one row, so they may conflict on shared-memory banks; that is measured
// (chip_smoke.py phase 11), not yet avoided.
//
// What bounds it on an H100: the FP64 log.  The H100 has no FP64 log
// instruction: libdevice's log is a sequence of FP64 fused multiply-adds
// and adds on the FP64 pipe (34 TFLOP/s without tensor cores).  A
// cluster of R rows and G groups needs R * G logs, tens of FP64
// instructions each, against R * P * 8 bytes of input read once: at the
// main path's P ~ 28, k = 3 (G = 4,060) that is hundreds of operations
// per byte, far above the card's 10 FP64 operations per byte of HBM, so
// operations bind (chip_smoke.group_scores_bound counts the instructions
// per log from this build's SASS).
//
// rpvg_tpu_torch/ops/group_scores_cuda.py group_scores_plain repeats the
// arithmetic in PyTorch (the same slot order of the k-term sum, the same
// division by k); the sums over r differ in order, so the two agree to
// rounding.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace group_scores {

// Group sizes up to this keep a thread's column indices in registers.
constexpr int kRegSlots = 8;

struct Clusters {
  const double* probs;
  const double* noise;
  const double* counts;
  const int32_t* table;
  const int64_t* mat_offsets;    // cluster -> first probability
  const int64_t* row_offsets;    // cluster -> first noise / count
  const int64_t* n_rows;
  const int64_t* n_cols;
  const int64_t* table_offsets;  // cluster -> first int32 of its (G, k) table
  const int64_t* n_groups;
  const int64_t* out_offsets;    // cluster -> first score
  const int64_t* tile_cluster;   // tile -> cluster
  const int64_t* tile_first;     // tile -> its first group
  const int64_t* tile_ids;       // this launch's tiles
  int group_size;
  int staged;
  int64_t smem_doubles;
  double* out;
};

// kRegs > 0: the group's indices in registers (k <= kRegs); kRegs == 0:
// read from the table for every row.
template <int kRegs>
__global__ void __launch_bounds__(128) group_scores_kernel(Clusters cl) {
  extern __shared__ double rows[];
  const int64_t tile = cl.tile_ids[blockIdx.x];
  const int64_t c = cl.tile_cluster[tile];
  const int64_t g = cl.tile_first[tile] + threadIdx.x;
  const int64_t R = cl.n_rows[c];
  const int64_t P = cl.n_cols[c];
  const bool live = g < cl.n_groups[c];
  const int k = cl.group_size;
  const double kd = static_cast<double>(k);
  const double* probs = cl.probs + cl.mat_offsets[c];
  const double* noise = cl.noise + cl.row_offsets[c];
  const double* counts = cl.counts + cl.row_offsets[c];
  const int32_t* idx = cl.table + cl.table_offsets[c] + (live ? g : 0) * k;

  int cols[kRegs > 0 ? kRegs : 1];
  if (kRegs > 0) {
#pragma unroll
    for (int j = 0; j < (kRegs > 0 ? kRegs : 1); ++j) cols[j] = j < k ? idx[j] : 0;
  }

  const int64_t per_pass = cl.staged ? cl.smem_doubles / P : R;
  double score = 0.0;
  for (int64_t r0 = 0; r0 < R; r0 += per_pass) {
    const int64_t n = R - r0 < per_pass ? R - r0 : per_pass;
    const double* src = probs + r0 * P;
    if (cl.staged) {
      __syncthreads();  // the previous pass is read
      for (int64_t e = threadIdx.x; e < n * P; e += blockDim.x) rows[e] = src[e];
      __syncthreads();
      src = rows;
    }
    if (live) {
      for (int64_t r = 0; r < n; ++r) {
        const double* row = src + r * P;
        double acc;
        if (kRegs > 0) {
          acc = row[cols[0]];
#pragma unroll
          for (int j = 1; j < (kRegs > 0 ? kRegs : 1); ++j) {
            if (j < k) acc += row[cols[j]];
          }
        } else {
          acc = row[idx[0]];
          for (int j = 1; j < k; ++j) acc += row[idx[j]];
        }
        const double group = noise[r0 + r] + acc / kd;
        const double lg = group > 0.0 ? log(group) : -CUDART_INF;
        score += counts[r0 + r] * lg;
      }
    }
  }
  if (live) cl.out[cl.out_offsets[c] + g] = score;
}

}  // namespace group_scores

// One launch over the n_tiles tiles listed in tile_ids (int64, on the
// device), one block of `threads` (128) threads each, with smem_bytes of
// dynamic shared memory per block for the staged rows (staged = 1; at
// least one row of every cluster in the launch fits) or none (staged =
// 0), on `stream`.  Tile t covers groups tile_first[t] .. + threads - 1
// of cluster tile_cluster[t]; cluster c writes n_groups[c] float64 scores
// at out_offsets[c] of out.  Returns cudaGetLastError().
extern "C" int rpvg_group_scores_f64(
    const void* probs, const void* noise, const void* counts, const void* table,
    const void* mat_offsets, const void* row_offsets, const void* n_rows, const void* n_cols,
    const void* table_offsets, const void* n_groups, const void* out_offsets,
    const void* tile_cluster, const void* tile_first, const void* tile_ids, int64_t n_tiles,
    int64_t group_size, int64_t threads, int64_t staged, int64_t smem_bytes, void* out,
    void* stream) {
  if (n_tiles <= 0) return 0;
  const group_scores::Clusters cl{
      static_cast<const double*>(probs),         static_cast<const double*>(noise),
      static_cast<const double*>(counts),        static_cast<const int32_t*>(table),
      static_cast<const int64_t*>(mat_offsets),  static_cast<const int64_t*>(row_offsets),
      static_cast<const int64_t*>(n_rows),       static_cast<const int64_t*>(n_cols),
      static_cast<const int64_t*>(table_offsets), static_cast<const int64_t*>(n_groups),
      static_cast<const int64_t*>(out_offsets),  static_cast<const int64_t*>(tile_cluster),
      static_cast<const int64_t*>(tile_first),   static_cast<const int64_t*>(tile_ids),
      static_cast<int>(group_size),              static_cast<int>(staged),
      smem_bytes / 8,                            static_cast<double*>(out)};
  const dim3 grid(static_cast<unsigned>(n_tiles));
  const dim3 block(static_cast<unsigned>(threads));
  const size_t smem = static_cast<size_t>(staged ? smem_bytes : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group_size <= group_scores::kRegSlots) {
    group_scores::group_scores_kernel<group_scores::kRegSlots><<<grid, block, smem, s>>>(cl);
  } else {
    group_scores::group_scores_kernel<0><<<grid, block, smem, s>>>(cl);
  }
  return static_cast<int>(cudaGetLastError());
}
