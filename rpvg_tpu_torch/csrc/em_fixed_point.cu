// EM abundance fixed point over a ragged set of tasks, float64.
//
// Replaces the TPU kernel rpvg_tpu/ops/em_pallas.py::_em_kernel
// (launched by _em_pallas_call, public em_pallas_batched).  That kernel
// ran padded (B, R, C) buckets in float32 with a batch-synchronous
// per-cluster freeze; here every task loops to its own convergence,
// straight on the ragged layout of
// rpvg_tpu_torch.infer.batching.pack_ragged (the layout of the native
// run_native_em): no padding, no shape buckets, no float32 downcast.
// The sequential specification of the same per-task loop is
// em_fixed_point_one in csrc/host/rpvg_native.cpp.
//
// The loop itself is em_task::solve (em_task.cuh), shared with
// em_fused.cu: its notes give the formula, the team per task, P staged
// in shared memory, and the summation order.  One call of the C
// function below is one launch over the tasks of one team size that the
// host planner (ops/em_cuda.py plan_launches) grouped together.
//
// What bounds it on an H100: the slowest task's serial iterations; the
// bound from bytes and FLOPs is under 0.1 ms for the main path's tasks.
// Those tasks are tiny (median 3 x 9); the time is set by the few of up
// to 348 x 61 that run up to 10,000 iterations.  An iteration of a small
// task is a chain of a divide, shared-memory loads, a vote and branches;
// one of a 348 x 61 task reads its P twice through one SM's shared memory
// (2 x 170 KB at 128 bytes per clock).  What is left: P in registers for
// the largest tasks, a float32 mode (half the bytes per pass), and
// splitting one big task over a thread block cluster.

#include "em_task.cuh"

// Named (not anonymous): the struct is a kernel template argument.
namespace em_ragged {

struct RaggedSource {
  const double* probs;
  const double* counts;
  const int64_t* mat_offsets;
  const int64_t* row_offsets;
  const int64_t* col_offsets;
  const int64_t* n_rows;
  const int64_t* n_cols;
  const int32_t* layouts;
  double* q_scratch;
  double* out_fracs;
  int64_t* out_iters;

  template <class Team>
  __device__ void operator()(const Team& team, int64_t task, bool staged, double* smem,
                             em_task::Params prm) const {
    const int64_t R = n_rows[task];
    const int64_t C = n_cols[task];
    const int32_t* l = layouts + 3 * task;
    em_task::solve(team, R, C, em_task::Layout{l[0], l[1], l[2]}, probs + mat_offsets[task], C,
                   counts + row_offsets[task],
                   nullptr, static_cast<int>(C), staged, smem, q_scratch + row_offsets[task],
                   prm, out_fracs + col_offsets[task], C, out_iters + task);
  }
};

}  // namespace em_ragged

// One launch over the n_tasks tasks listed in task_ids (int64, on the
// device), with each task's em_task::Layout in layouts (3 int32 per task),
// as teams of `threads` threads (32: one warp per task), with P
// staged in shared memory or (staged = 0) read from global memory, on
// `stream`; returns cudaGetLastError() (0 on success).  smem_bytes is
// per block (for warp teams: em_task::kWarpsPerBlock equal slots).  The
// caller allocates every buffer: out_fracs (col_offsets[n] doubles),
// out_iters (n int64) and q_scratch (row_offsets[n] doubles, used only
// unstaged).
extern "C" int rpvg_em_fixed_point_f64(
    const void* probs, const void* counts, const void* mat_offsets,
    const void* row_offsets, const void* col_offsets, const void* n_rows,
    const void* n_cols, const void* layouts, const void* task_ids, int64_t n_tasks,
    int64_t threads,
    int64_t staged, int64_t smem_bytes, int64_t max_em_its, double max_rel_em_conv,
    void* q_scratch, void* out_fracs, void* out_iters, void* stream) {
  const em_ragged::RaggedSource source{
      static_cast<const double*>(probs), static_cast<const double*>(counts),
      static_cast<const int64_t*>(mat_offsets), static_cast<const int64_t*>(row_offsets),
      static_cast<const int64_t*>(col_offsets), static_cast<const int64_t*>(n_rows),
      static_cast<const int64_t*>(n_cols), static_cast<const int32_t*>(layouts),
      static_cast<double*>(q_scratch),
      static_cast<double*>(out_fracs), static_cast<int64_t*>(out_iters)};
  return em_task::launch(source, static_cast<const int64_t*>(task_ids), n_tasks, threads,
                         static_cast<int>(staged), smem_bytes,
                         em_task::Params{max_em_its, max_rel_em_conv},
                         static_cast<cudaStream_t>(stream));
}
