// EM abundance fixed point over a ragged set of tasks, float64, one
// thread block per task.
//
// Replaces the TPU kernel rpvg_tpu/ops/em_pallas.py::_em_kernel
// (launched by _em_pallas_call, public em_pallas_batched).  That kernel
// ran padded (B, R, C) buckets in float32 with a batch-synchronous
// per-cluster freeze; here every task is one block that loops to its
// own convergence, straight on the ragged layout of
// rpvg_tpu_torch.infer.batching.pack_ragged (the layout of the native
// run_native_em): no padding, no shape buckets, no float32 downcast.
// The sequential specification of the same per-task loop is
// em_fixed_point_one in native/rpvg_native.cpp.
//
// Each iteration, for a task with matrix P (R x C, row-major, the noise
// column last) and read counts n (R):
//   rs_r = sum_c P_rc a_c
//   q_r  = n_r / rs_r, or 0 where rs_r <= 0
//   a'_c = a_c * (sum_r P_rc q_r) / max(sum_r n_r, 1)
// starting from a_c = 1 / C.  The task stops when every a'_c >= 1e-8 has
// moved relatively by at most max_rel_em_conv for 10 consecutive
// iterations, or after max_em_its iterations.  Edge cases (R = 1, C = 1,
// all-zero rows, zero-count rows) follow the formula with no special
// casing.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  The main
// path's tasks are tiny (median 3 x 9 elements) and the whole task set
// (a few MB) stays in the 50 MB L2, so P is simply re-read from global
// memory each iteration.  The kernel's wall time is set by the heavy
// tail: a few tasks run thousands of serial iterations, each a chain of
// three block barriers.  The design keeps each iteration's dependent
// chain short instead: a, a' and the reductions live in shared memory,
// rows are spread over threads for the E step, and rows are cut into
// slices for the M step so a column sum is R / slices long.
//
// Determinism: every sum runs in a fixed order (rows ascending within a
// slice, slices ascending, columns ascending within a row) with no
// atomics, so results are identical from run to run.
//
// Later work (not done here): splitting one big task across a thread
// block cluster, staging P in shared memory, a float32 variant, and
// packing several tiny tasks into one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kMinAbundance = 1e-8;  // constants.MIN_EM_ABUNDANCE
constexpr int kMinConvIts = 10;         // constants.MIN_EM_CONV_ITS

// Shared memory of one block (doubles): a[C], a_next[C], red[threads],
// then q[R] when R <= q_smem_rows (otherwise q lives in q_scratch at the
// task's row offset).
__global__ void em_fixed_point_kernel(
    const double* __restrict__ probs, const double* __restrict__ counts,
    const int64_t* __restrict__ mat_offsets,
    const int64_t* __restrict__ row_offsets,
    const int64_t* __restrict__ col_offsets,
    const int64_t* __restrict__ n_rows, const int64_t* __restrict__ n_cols,
    int64_t max_em_its, double max_rel_em_conv, int64_t q_smem_rows,
    double* __restrict__ q_scratch, double* __restrict__ out_fracs,
    int64_t* __restrict__ out_iters) {
  extern __shared__ double smem[];
  __shared__ double s_denom;

  const int64_t task = blockIdx.x;
  const int64_t R = n_rows[task];
  const int64_t C = n_cols[task];
  const double* __restrict__ P = probs + mat_offsets[task];
  const double* __restrict__ cnt = counts + row_offsets[task];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  double* a = smem;
  double* a_next = smem + C;
  double* red = smem + 2 * C;
  double* q = (R <= q_smem_rows) ? red + nthreads : q_scratch + row_offsets[task];

  // Denominator max(sum_r n_r, 1): strided partial sums, then one
  // thread adds the partials in thread order.
  double part = 0.0;
  for (int64_t r = tid; r < R; r += nthreads) part += cnt[r];
  red[tid] = part;
  for (int64_t c = tid; c < C; c += nthreads) a[c] = 1.0 / static_cast<double>(C);
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
      const double* __restrict__ row = P + r * C;
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
        for (int64_t r = my_slice; r < R; r += slices) t += P[r * C + my_col] * q[r];
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
        for (int64_t r = 0; r < R; ++r) tc += P[r * C + c] * q[r];
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

  const int64_t out_base = col_offsets[task];
  for (int64_t c = tid; c < C; c += nthreads) out_fracs[out_base + c] = a[c];
  if (tid == 0) out_iters[task] = it;
}

}  // namespace

// Launches one block of `threads` threads per task on `stream` and
// returns cudaGetLastError() (0 on success).  The caller allocates every
// buffer: out_fracs (col_offsets[n_tasks] doubles), out_iters (n_tasks
// int64) and q_scratch (row_offsets[n_tasks] doubles, used only by tasks
// with more than q_smem_rows rows).  smem_bytes must cover
// 8 * (2 * max C + threads + min(max R, q_smem_rows)).
extern "C" int rpvg_em_fixed_point_f64(
    const void* probs, const void* counts, const void* mat_offsets,
    const void* row_offsets, const void* col_offsets, const void* n_rows,
    const void* n_cols, int64_t n_tasks, int64_t max_em_its,
    double max_rel_em_conv, int64_t q_smem_rows, void* q_scratch,
    void* out_fracs, void* out_iters, int64_t threads, int64_t smem_bytes,
    void* stream) {
  if (n_tasks <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        em_fixed_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  em_fixed_point_kernel<<<dim3(static_cast<unsigned>(n_tasks)),
                          dim3(static_cast<unsigned>(threads)),
                          static_cast<size_t>(smem_bytes),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(probs), static_cast<const double*>(counts),
      static_cast<const int64_t*>(mat_offsets),
      static_cast<const int64_t*>(row_offsets),
      static_cast<const int64_t*>(col_offsets),
      static_cast<const int64_t*>(n_rows), static_cast<const int64_t*>(n_cols),
      max_em_its, max_rel_em_conv, q_smem_rows,
      static_cast<double*>(q_scratch), static_cast<double*>(out_fracs),
      static_cast<int64_t*>(out_iters));
  return static_cast<int>(cudaGetLastError());
}
