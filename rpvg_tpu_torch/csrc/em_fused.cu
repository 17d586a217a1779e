// EM abundance fixed point over several padded shape buckets in one
// call, float64.
//
// Replaces the TPU kernel rpvg_tpu/ops/em_pallas.py::_em_fused_kernel
// (launched by _em_fused_call, public em_pallas_fused).  That kernel
// held K differently shaped (B_k, R_k, C_k) buckets in VMEM and ran one
// loop per bucket, freezing each cluster after its own convergence; the
// point was to pay one dispatch instead of K on a high-latency link.
// Here the K buckets are concatenated row-major into one buffer each for
// P (B_k, R_k, C_k), the counts (B_k, R_k) and the column masks
// (B_k, C_k), a descriptor per bucket gives its offsets and padded
// shape, and every padded cluster loops to its own convergence.
// Per-cluster freezing makes the TPU kernel's per-bucket loop and this
// per-cluster loop compute the same trajectories.
//
// Padding: padded columns have a zero mask and zero P, padded rows zero
// counts and zero P.  A cluster first finds its extent (the last column
// with a nonzero mask, the last row with a nonzero count) and hands only
// that extent, with the padded row stride of its source, to
// em_task::solve (em_task.cuh), the loop of the ragged kernel
// em_fixed_point.cu.  Every element past the extent adds an exact +0.0
// to a sum, so skipping it changes no bit, and the team and summation
// order depend on the extent alone: a task gives the same bits here as
// in the ragged kernel.  The start is a_c = m_c / max(sum_c m_c, 1); an
// all-zero cluster (a dummy slot) runs 10 empty iterations and writes
// zeros.
//
// What bounds it on an H100: as in the ragged kernel, the slowest
// cluster's serial iterations.  The padded stride used to cost strided
// L2 reads on every iteration; now a cluster's P is copied once, densely
// at its extent, into shared memory, so padding costs only the bytes of
// that one copy.  One call of the C function below is one launch over
// the clusters of one team size, grouped by the host planner
// (ops/em_cuda.py plan_launches) from extents computed on the device.

#include "em_task.cuh"

// Named (not anonymous): the struct is a kernel template argument.
namespace em_fused {

constexpr int kDescFields = 5;  // probs, counts, cols offsets; R, C

struct FusedSource {
  const double* probs;
  const double* counts;
  const double* col_masks;
  const int64_t* desc;
  const int64_t* cluster_offsets;
  int64_t n_blocks;
  const int32_t* layouts;
  double* q_scratch;
  double* out_fracs;
  int64_t* out_iters;

  template <class Team>
  __device__ void operator()(const Team& team, int64_t cluster, bool staged, double* smem,
                             em_task::Params prm) const {
    // Bucket k holds clusters [cluster_offsets[k], cluster_offsets[k + 1]):
    // the last k whose first cluster is at or before this one.
    int64_t lo = 0;
    int64_t hi = n_blocks - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) / 2;
      if (cluster_offsets[mid] <= cluster) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int64_t* __restrict__ d = desc + lo * kDescFields;
    const int64_t b = cluster - cluster_offsets[lo];
    const int64_t R_pad = d[3];
    const int64_t C_pad = d[4];
    const double* __restrict__ P = probs + d[0] + b * R_pad * C_pad;
    const double* __restrict__ cnt = counts + d[1] + b * R_pad;
    const double* __restrict__ mask = col_masks + d[2] + b * C_pad;

    // Extents and the number of unmasked columns (integer reductions,
    // exact in any order).
    int last_row = -1;
    int last_col = -1;
    int n_on = 0;
    for (int64_t r = team.rank; r < R_pad; r += team.size()) {
      if (cnt[r] != 0.0) last_row = static_cast<int>(r);
    }
    for (int64_t c = team.rank; c < C_pad; c += team.size()) {
      if (mask[c] > 0.0) {
        last_col = static_cast<int>(c);
        ++n_on;
      }
    }
    const int64_t R = team.max(last_row, smem) + 1;
    const int64_t C = team.max(last_col, smem) + 1;
    const int on = team.isum(n_on, smem);

    const int32_t* l = layouts + 3 * cluster;
    em_task::solve(team, R, C, em_task::Layout{l[0], l[1], l[2]}, P, C_pad, cnt, mask, on,
                   staged, smem,
                   q_scratch + d[1] + b * R_pad, prm, out_fracs + d[2] + b * C_pad, C_pad,
                   out_iters + cluster);
  }
};

}  // namespace em_fused

// One launch over the n_tasks padded clusters listed in task_ids (int64
// cluster indices, on the device), with each cluster's em_task::Layout in
// layouts (3 int32 per cluster, from its extent), as teams of `threads` threads (32: one
// warp per cluster), with P staged in shared memory or (staged = 0) read
// from global memory, on `stream`; returns cudaGetLastError() (0 on
// success).  desc holds kDescFields int64 per bucket: the element offsets
// of its P, counts and column masks (the output fractions share the
// masks' layout), then its padded R and C; cluster_offsets (n_blocks + 1)
// the first cluster of each bucket.  smem_bytes is per block (for warp
// teams: em_task::kWarpsPerBlock equal slots).  The caller allocates
// every buffer: out_fracs (as many doubles as the masks), out_iters (one
// int64 per cluster) and q_scratch (as many doubles as the counts, used
// only unstaged).
extern "C" int rpvg_em_fused_f64(
    const void* probs, const void* counts, const void* col_masks, const void* desc,
    const void* cluster_offsets, int64_t n_blocks, const void* layouts, const void* task_ids,
    int64_t n_tasks,
    int64_t threads, int64_t staged, int64_t smem_bytes, int64_t max_em_its,
    double max_rel_em_conv, void* q_scratch, void* out_fracs, void* out_iters, void* stream) {
  const em_fused::FusedSource source{
      static_cast<const double*>(probs),     static_cast<const double*>(counts),
      static_cast<const double*>(col_masks), static_cast<const int64_t*>(desc),
      static_cast<const int64_t*>(cluster_offsets), n_blocks,
      static_cast<const int32_t*>(layouts),  static_cast<double*>(q_scratch),
      static_cast<double*>(out_fracs),
      static_cast<int64_t*>(out_iters)};
  return em_task::launch(source, static_cast<const int64_t*>(task_ids), n_tasks, threads,
                         static_cast<int>(staged), smem_bytes,
                         em_task::Params{max_em_its, max_rel_em_conv},
                         static_cast<cudaStream_t>(stream));
}
