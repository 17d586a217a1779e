// EM abundance fixed point over several padded shape buckets in one
// launch, float64, one thread block per padded cluster.
//
// Replaces the TPU kernel rpvg_tpu/ops/em_pallas.py::_em_fused_kernel
// (launched by _em_fused_call, public em_pallas_fused).  That kernel
// held K differently shaped (B_k, R_k, C_k) buckets in VMEM and ran one
// loop per bucket, freezing each cluster after its own convergence; the
// point was to pay one dispatch instead of K on a high-latency link.
// Here the K buckets are concatenated row-major into one buffer each for
// P (B_k, R_k, C_k), the counts (B_k, R_k) and the column masks
// (B_k, C_k), a descriptor per bucket gives its offsets and padded
// shape, and every padded cluster of every bucket is one thread block
// that loops to its own convergence.  Per-cluster freezing makes the
// TPU kernel's per-bucket loop and this per-cluster loop compute the
// same trajectories.
//
// Each iteration, for a cluster with matrix P (R x C), counts n (R) and
// column mask m (C, 0 or 1):
//   rs_r = sum_c P_rc a_c
//   q_r  = n_r / rs_r, or 0 where rs_r <= 0
//   a'_c = a_c * (sum_r P_rc q_r) / max(sum_r n_r, 1)
// starting from a_c = m_c / max(sum_c m_c, 1).  The cluster stops when
// every a'_c >= 1e-8 has moved relatively by at most max_rel_em_conv for
// 10 consecutive iterations, or after max_em_its iterations.  An
// all-zero cluster (a dummy slot) runs 10 empty iterations and writes
// zeros.
//
// Padding: padded columns have a zero mask and zero P, padded rows zero
// counts and zero P.  A cluster first finds its extent (the last column
// with a nonzero mask, the last row with a nonzero count) and loops only
// over it: every element past the extent adds an exact +0.0 to a sum, so
// skipping it changes no bit.  Within the extent the sums run in the
// order of csrc/em_fixed_point.cu (rows spread over threads for the E
// step, fixed row slices per column for the M step), so a task gives the
// same bits here as in the ragged kernel.
//
// What bounds it on an H100: latency, as in the ragged kernel.  The
// buckets of one launch are a few MB and stay in the 50 MB L2; the wall
// time is set by the slowest cluster's serial iterations.  What the
// padding costs is bytes moved and staged, not loop work.
//
// Determinism: sums run in a fixed order with no atomics; the extents
// are integer maxima and counts (warp reductions, exact in any order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kMinAbundance = 1e-8;  // constants.MIN_EM_ABUNDANCE
constexpr int kMinConvIts = 10;         // constants.MIN_EM_CONV_ITS
constexpr int kDescFields = 5;          // probs, counts, cols offsets; R, C
constexpr unsigned kFullMask = 0xffffffffu;

// Shared memory of one block (doubles): a[C], a_next[C], red[threads],
// then q[R] when the cluster's row extent is at most q_smem_rows
// (otherwise q lives in q_scratch at the cluster's count offset).
// threads must be a multiple of 32, at most 1024.
__global__ void em_fused_kernel(
    const double* __restrict__ probs, const double* __restrict__ counts,
    const double* __restrict__ col_masks, const int64_t* __restrict__ desc,
    const int64_t* __restrict__ cluster_offsets, int64_t n_blocks,
    int64_t max_em_its, double max_rel_em_conv, int64_t q_smem_rows,
    double* __restrict__ q_scratch, double* __restrict__ out_fracs,
    int64_t* __restrict__ out_iters) {
  extern __shared__ double smem[];
  __shared__ double s_denom;
  __shared__ int s_last_row[32], s_last_col[32], s_n_on[32];

  // Bucket k holds clusters [cluster_offsets[k], cluster_offsets[k + 1]):
  // the last k whose first cluster is at or before this one.
  const int64_t cluster = blockIdx.x;
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
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // Extents and the number of unmasked columns.
  int last_row = -1;
  int last_col = -1;
  unsigned n_on = 0;
  for (int64_t r = tid; r < R_pad; r += nthreads) {
    if (cnt[r] != 0.0) last_row = static_cast<int>(r);
  }
  for (int64_t c = tid; c < C_pad; c += nthreads) {
    if (mask[c] > 0.0) {
      last_col = static_cast<int>(c);
      ++n_on;
    }
  }
  last_row = __reduce_max_sync(kFullMask, last_row);
  last_col = __reduce_max_sync(kFullMask, last_col);
  n_on = __reduce_add_sync(kFullMask, n_on);
  if (lane == 0) {
    s_last_row[warp] = last_row;
    s_last_col[warp] = last_col;
    s_n_on[warp] = static_cast<int>(n_on);
  }
  __syncthreads();
  int64_t R = -1;
  int64_t C = -1;
  int on = 0;
  for (int w = 0; w < nthreads / 32; ++w) {
    R = s_last_row[w] > R ? s_last_row[w] : R;
    C = s_last_col[w] > C ? s_last_col[w] : C;
    on += s_n_on[w];
  }
  R += 1;
  C += 1;

  double* a = smem;
  double* a_next = smem + C_pad;
  double* red = smem + 2 * C_pad;
  double* q = (R <= q_smem_rows) ? red + nthreads : q_scratch + d[1] + b * R_pad;

  // Denominator max(sum_r n_r, 1): strided partial sums, then one
  // thread adds the partials in thread order.
  double part = 0.0;
  for (int64_t r = tid; r < R; r += nthreads) part += cnt[r];
  red[tid] = part;
  const double init = 1.0 / static_cast<double>(on > 1 ? on : 1);
  for (int64_t c = tid; c < C; c += nthreads) a[c] = mask[c] > 0.0 ? init : 0.0;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int i = 0; i < nthreads; ++i) total += red[i];
    s_denom = total > 1.0 ? total : 1.0;
  }
  __syncthreads();
  const double denom = s_denom;

  // M-step layout: with C <= threads, thread tid owns column tid % C of
  // row slice tid / C; slices = threads / C row slices per column.
  const bool sliced = C >= 1 && C <= nthreads;
  const int64_t slices = sliced ? nthreads / C : 1;
  const int64_t my_col = sliced ? tid % C : 0;
  const int64_t my_slice = sliced ? tid / C : 0;

  int conv_its = 0;
  int64_t it = 0;
  while (it < max_em_its && conv_its < kMinConvIts) {
    // E step: one thread per row.
    for (int64_t r = tid; r < R; r += nthreads) {
      const double* __restrict__ row = P + r * C_pad;
      double rs = 0.0;
      for (int64_t c = 0; c < C; ++c) rs += row[c] * a[c];
      q[r] = rs > 0.0 ? cnt[r] / rs : 0.0;
    }
    __syncthreads();

    // M step and convergence test.
    int not_conv = 0;
    if (sliced) {
      double t = 0.0;
      if (my_slice < slices) {
        for (int64_t r = my_slice; r < R; r += slices) t += P[r * C_pad + my_col] * q[r];
      }
      red[tid] = t;
      __syncthreads();
      if (tid < C) {
        double tc = 0.0;
        for (int64_t s = 0; s < slices; ++s) tc += red[s * C + tid];
        const double old = a[tid];
        const double nw = old * tc / denom;
        a_next[tid] = nw;
        not_conv = nw >= kMinAbundance && fabs(nw - old) / nw > max_rel_em_conv;
      }
    } else {
      for (int64_t c = tid; c < C; c += nthreads) {
        double tc = 0.0;
        for (int64_t r = 0; r < R; ++r) tc += P[r * C_pad + c] * q[r];
        const double old = a[c];
        const double nw = old * tc / denom;
        a_next[c] = nw;
        not_conv |= nw >= kMinAbundance && fabs(nw - old) / nw > max_rel_em_conv;
      }
    }
    not_conv = __syncthreads_or(not_conv);
    conv_its = not_conv ? 0 : conv_its + 1;
    double* swap = a;
    a = a_next;
    a_next = swap;
    ++it;
  }

  double* __restrict__ out = out_fracs + d[2] + b * C_pad;
  for (int64_t c = tid; c < C_pad; c += nthreads) out[c] = c < C ? a[c] : 0.0;
  if (tid == 0) out_iters[cluster] = it;
}

}  // namespace

// Launches one block of `threads` threads per padded cluster (n_clusters
// = cluster_offsets[n_blocks]) on `stream` and returns
// cudaGetLastError() (0 on success).  desc holds kDescFields int64 per
// bucket: the element offsets of its P, counts and column masks (the
// output fractions share the masks' layout), then its padded R and C.
// The caller allocates every buffer: out_fracs (as many doubles as the
// masks), out_iters (n_clusters int64) and q_scratch (as many doubles as
// the counts, used only by clusters with more than q_smem_rows rows).
// smem_bytes must cover 8 * (2 * max C + threads + min(max R,
// q_smem_rows)).
extern "C" int rpvg_em_fused_f64(
    const void* probs, const void* counts, const void* col_masks,
    const void* desc, const void* cluster_offsets, int64_t n_blocks,
    int64_t n_clusters, int64_t max_em_its, double max_rel_em_conv,
    int64_t q_smem_rows, void* q_scratch, void* out_fracs, void* out_iters,
    int64_t threads, int64_t smem_bytes, void* stream) {
  if (n_clusters <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        em_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  em_fused_kernel<<<dim3(static_cast<unsigned>(n_clusters)),
                    dim3(static_cast<unsigned>(threads)),
                    static_cast<size_t>(smem_bytes),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(probs), static_cast<const double*>(counts),
      static_cast<const double*>(col_masks),
      static_cast<const int64_t*>(desc),
      static_cast<const int64_t*>(cluster_offsets), n_blocks, max_em_its,
      max_rel_em_conv, q_smem_rows, static_cast<double*>(q_scratch),
      static_cast<double*>(out_fracs), static_cast<int64_t*>(out_iters));
  return static_cast<int>(cudaGetLastError());
}
