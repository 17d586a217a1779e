// The per-task EM fixed point, float64, shared by the ragged kernel
// (em_fixed_point.cu) and the multi-bucket kernel (em_fused.cu).  Both
// hand it a task's extent (R rows, C columns) and where its P, counts
// and column mask lie; given the same extent and inputs, both kernels
// therefore run the same instructions in the same summation order and
// give the same bits.
//
// Each iteration, for P (R x C) and read counts n (R):
//   rs_r = sum_c P_rc a_c
//   q_r  = n_r / rs_r, or 0 where rs_r <= 0
//   a'_c = a_c * (sum_r P_rc q_r) / max(sum_r n_r, 1)
// The task stops when every a'_c >= 1e-8 has moved relatively by at most
// max_rel_em_conv for 10 consecutive iterations, or after max_em_its.
// Two divides per column left each iteration's chain: a' multiplies by
// 1 / max(sum_r n_r, 1), computed once, and the convergence test compares
// |a'_c - a_c| with max_rel_em_conv * a'_c (each within a rounding of the
// formula; results stay within rtol 1e-6 of the plain version).
//
// Design (what bounds the loop on an H100 is each iteration's chain of
// dependent shared-memory loads, adds, shuffles and barriers, and for the
// largest tasks the shared-memory traffic of reading P twice; not HBM
// bytes or FLOPs):
// * Team sized to the task.  A task of at most 1,024 elements runs as
//   one warp (kWarpsPerBlock independent tasks per block, __syncwarp and
//   a warp vote in place of block barriers); a larger one as a block of
//   128-1,024 threads.  The host planner (ops/em_cuda.py plan_launches)
//   chooses the team from (R, C) alone and launches once per team size,
//   each launch on a stream of its own so the launches overlap.
// * P staged once, densely, in shared memory, with its counts, before
//   the first iteration; the loop never reads P from global memory, and
//   the staged call site of iterate() compiles to LDS/STS, not generic
//   loads.  A task too big for shared memory keeps P, counts and q in
//   global memory (the planner decides; same loop, same order).
// * Short, coalesced sums.  E step: groups of row_lanes lanes per row,
//   each lane summing columns lane, lane + row_lanes, ... in ascending
//   order, then a fixed __shfl_xor_sync butterfly over the group.  M step:
//   the same with groups of col_lanes lanes per column over rows.  The
//   planner picks the two widths (powers of two, 1 to 32) by a chain
//   model, among the pairs for which a row stride exists that keeps every
//   half-warp's loads in both steps on distinct banks, and that stride
//   (Layout); so a 3 x 9 task sums serially per lane and a 205 x 41 task
//   uses 2 lanes per row and 8 per column at a stride of 42.
// * Two team barriers per iteration (after the E step; the vote after
//   the M step), down from three; the inner sums issue four terms' loads
//   at a time.
//
// Determinism: every sum runs in a fixed order with no atomics (an xor
// butterfly gives every lane of a group the same bits), so two launches
// give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace em_task {

constexpr double kMinAbundance = 1e-8;  // constants.MIN_EM_ABUNDANCE
constexpr int kMinConvIts = 10;         // constants.MIN_EM_CONV_ITS
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;       // ops/em_cuda.py WARPS_PER_BLOCK
constexpr int kRedDoubles = 32;         // ops/em_cuda.py _RED_DOUBLES

struct Params {
  int64_t max_em_its;
  double max_rel_em_conv;
};

// How a task's sums are laid out (ops/em_cuda.py sum_layouts, from the
// task's extent and team alone): lanes per row in the E step, lanes per
// column in the M step, and the row stride of P staged in shared memory.
struct Layout {
  int32_t row_lanes;
  int32_t col_lanes;
  int32_t stride;
};

// One warp per task.
struct WarpTeam {
  int rank;
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
  __device__ int any(int p, double*) const {
    __syncwarp();
    return __any_sync(kFullMask, p);
  }
  __device__ double sum(double v, double*) const {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
    return v;
  }
  __device__ int max(int v, double*) const { return __reduce_max_sync(kFullMask, v); }
  __device__ int isum(int v, double*) const { return __reduce_add_sync(kFullMask, v); }
};

// One block per task; red holds one slot per warp.
struct BlockTeam {
  int rank;
  int threads;
  __device__ int size() const { return threads; }
  __device__ void sync() const { __syncthreads(); }
  __device__ int any(int p, double*) const { return __syncthreads_or(p); }
  __device__ double sum(double v, double* red) const {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
    if ((rank & 31) == 0) red[rank >> 5] = v;
    __syncthreads();
    double total = 0.0;
    for (int w = 0; w < threads >> 5; ++w) total += red[w];
    __syncthreads();
    return total;
  }
  __device__ int max(int v, double* red) const {
    v = __reduce_max_sync(kFullMask, v);
    int* slots = reinterpret_cast<int*>(red);
    if ((rank & 31) == 0) slots[rank >> 5] = v;
    __syncthreads();
    int m = slots[0];
    for (int w = 1; w < threads >> 5; ++w) m = slots[w] > m ? slots[w] : m;
    __syncthreads();
    return m;
  }
  __device__ int isum(int v, double* red) const {
    v = __reduce_add_sync(kFullMask, v);
    int* slots = reinterpret_cast<int*>(red);
    if ((rank & 31) == 0) slots[rank >> 5] = v;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < threads >> 5; ++w) total += slots[w];
    __syncthreads();
    return total;
  }
};

// The iterations of one task, from a_c (in a) to the result (in a on
// return, with a_next its scratch); returns the iteration count.  Inlined
// at two call sites, one for each kind of memory P, counts and q lie in,
// so that the staged site compiles to shared-memory loads and stores
// (LDS/STS) rather than generic ones.
template <class Team>
__device__ __forceinline__ int64_t iterate(const Team& team, int R, int C, int S, int w, int h,
                                           const double* __restrict__ P,
                                           const double* __restrict__ cnt,
                                           double* __restrict__ q, double*& a, double*& a_next,
                                           double* red, double inv_denom, Params prm) {
  const int tid = team.rank;
  const int T = team.size();
  const int e_groups = T / w;
  const int m_groups = T / h;
  const int e_group = tid / w;
  const int e_lane = tid % w;
  const int m_group = tid / h;
  const int m_lane = tid % h;

  int conv_its = 0;
  int64_t it = 0;
  while (it < prm.max_em_its && conv_its < kMinConvIts) {
    // E step.
    for (int r0 = 0; r0 < R; r0 += e_groups) {
      const int r = r0 + e_group;
      double rs = 0.0;
      if (r < R) {
        const double* __restrict__ row = P + r * S;
        int c = e_lane;
        // Four terms' loads issued together, added in column order.
        for (; c + 3 * w < C; c += 4 * w) {
          const double p0 = row[c], p1 = row[c + w], p2 = row[c + 2 * w], p3 = row[c + 3 * w];
          const double a0 = a[c], a1 = a[c + w], a2 = a[c + 2 * w], a3 = a[c + 3 * w];
          rs += p0 * a0;
          rs += p1 * a1;
          rs += p2 * a2;
          rs += p3 * a3;
        }
        for (; c < C; c += w) rs += row[c] * a[c];
      }
      for (int off = w >> 1; off > 0; off >>= 1) rs += __shfl_xor_sync(kFullMask, rs, off);
      if (e_lane == 0 && r < R) q[r] = rs > 0.0 ? cnt[r] / rs : 0.0;
    }
    team.sync();

    // M step and convergence vote.
    int not_conv = 0;
    for (int c0 = 0; c0 < C; c0 += m_groups) {
      const int c = c0 + m_group;
      double t = 0.0;
      if (c < C) {
        const double* __restrict__ col = P + c;
        const int step = h * S;
        int r = m_lane;
        // Four terms' loads issued together, added in row order.
        for (; r + 3 * h < R; r += 4 * h) {
          const double* p = col + r * S;
          const double p0 = p[0], p1 = p[step], p2 = p[2 * step], p3 = p[3 * step];
          const double q0 = q[r], q1 = q[r + h], q2 = q[r + 2 * h], q3 = q[r + 3 * h];
          t += p0 * q0;
          t += p1 * q1;
          t += p2 * q2;
          t += p3 * q3;
        }
        for (; r < R; r += h) t += col[r * S] * q[r];
      }
      for (int off = h >> 1; off > 0; off >>= 1) t += __shfl_xor_sync(kFullMask, t, off);
      if (m_lane == 0 && c < C) {
        const double old = a[c];
        const double nw = old * t * inv_denom;
        a_next[c] = nw;
        not_conv |= nw >= kMinAbundance && fabs(nw - old) > prm.max_rel_em_conv * nw;
      }
    }
    not_conv = team.any(not_conv, red);
    conv_its = not_conv ? 0 : conv_its + 1;
    double* swap = a;
    a = a_next;
    a_next = swap;
    ++it;
  }
  return it;
}

// Solves one task.  P_src is row-major at src_stride, cnt_src holds R
// counts; mask (C entries, or nullptr for all columns on) and on (the
// number of columns on) set the start a_c = mask_c > 0 ? 1 / max(on, 1)
// : 0.  smem is the task's shared memory (doubles): red[kRedDoubles],
// a[C], a_next[C] and, when staged, counts[R], q[R], P[R x stride];
// unstaged, q lives in q_global.  Writes out[c] = a_c for c < C and 0 for
// C <= c < out_len, and the iteration count to *out_iters.  The loop
// indexes in 32 bits (the planner keeps R * stride below 2^31).
template <class Team>
__device__ void solve(const Team& team, int64_t R, int64_t C, Layout layout,
                      const double* __restrict__ P_src, int64_t src_stride,
                      const double* __restrict__ cnt_src,
                      const double* __restrict__ mask, int on, bool staged,
                      double* smem, double* q_global, Params prm,
                      double* __restrict__ out, int64_t out_len,
                      int64_t* __restrict__ out_iters) {
  const int tid = team.rank;
  const int T = team.size();
  double* red = smem;
  double* a = smem + kRedDoubles;
  double* a_next = a + C;
  double* cnt_s = a_next + C;
  double* q_s = cnt_s + R;
  double* P_s = q_s + R;
  const int64_t S = layout.stride;
  if (staged) {
    for (int64_t i = tid; i < R * C; i += T) {
      const int64_t r = i / C;
      const int64_t c = i - r * C;
      P_s[r * S + c] = P_src[r * src_stride + c];
    }
    for (int64_t r = tid; r < R; r += T) cnt_s[r] = cnt_src[r];
  }

  const double init = 1.0 / static_cast<double>(on > 1 ? on : 1);
  for (int64_t c = tid; c < C; c += T) a[c] = (mask == nullptr || mask[c] > 0.0) ? init : 0.0;
  double part = 0.0;
  for (int64_t r = tid; r < R; r += T) part += cnt_src[r];
  const double total = team.sum(part, red);
  const double inv_denom = 1.0 / (total > 1.0 ? total : 1.0);
  team.sync();

  const int Ri = static_cast<int>(R);
  const int Ci = static_cast<int>(C);
  const int64_t it =
      staged ? iterate(team, Ri, Ci, static_cast<int>(S), layout.row_lanes, layout.col_lanes,
                       P_s, cnt_s, q_s, a, a_next, red, inv_denom, prm)
             : iterate(team, Ri, Ci, static_cast<int>(src_stride), layout.row_lanes,
                       layout.col_lanes, P_src, cnt_src, q_global, a, a_next, red, inv_denom,
                       prm);

  for (int64_t c = tid; c < out_len; c += T) out[c] = c < C ? a[c] : 0.0;
  if (tid == 0) *out_iters = it;
}

// Source: a struct with
//   template <class Team> __device__ void operator()(const Team&, int64_t
//       task, bool staged, double* smem, Params) const
// that finds the task's inputs and calls solve.

// kWarpsPerBlock tasks per block, one warp each; every warp's shared
// memory is slot_doubles long.
template <class Source>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    warp_team_kernel(Source source, const int64_t* __restrict__ task_ids,
                     int64_t n_tasks, int64_t slot_doubles, int staged, Params prm) {
  extern __shared__ double smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (k >= n_tasks) return;
  source(WarpTeam{static_cast<int>(threadIdx.x & 31)}, task_ids[k], staged != 0,
         smem + warp * slot_doubles, prm);
}

// One task per block of blockDim.x threads (a multiple of 32).
template <class Source>
__global__ void __launch_bounds__(1024)
    block_team_kernel(Source source, const int64_t* __restrict__ task_ids, int staged,
                      Params prm) {
  extern __shared__ double smem[];
  source(BlockTeam{static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x)},
         task_ids[blockIdx.x], staged != 0, smem, prm);
}

// One launch of `threads`-thread teams (32: warp teams) over n_tasks
// task ids on `stream`; smem_bytes is per block (for warp teams,
// kWarpsPerBlock equal slots).  Returns cudaGetLastError().
template <class Source>
int launch(const Source& source, const int64_t* task_ids, int64_t n_tasks, int64_t threads,
           int staged, int64_t smem_bytes, Params prm, cudaStream_t stream) {
  if (n_tasks <= 0) return 0;
  if (threads == 32) {
    auto* kernel = warp_team_kernel<Source>;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t blocks = (n_tasks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kWarpsPerBlock * 32),
             static_cast<size_t>(smem_bytes), stream>>>(
        source, task_ids, n_tasks, smem_bytes / 8 / kWarpsPerBlock, staged, prm);
  } else {
    auto* kernel = block_team_kernel<Source>;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(static_cast<unsigned>(n_tasks)), dim3(static_cast<unsigned>(threads)),
             static_cast<size_t>(smem_bytes), stream>>>(source, task_ids, staged, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace em_task
