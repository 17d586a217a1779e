// Collapsed Gibbs sampler of haplotype groups over k slots, one block per
// (cluster, chain), float64.
//
// Replaces the XLA device function
// rpvg_tpu/infer/posteriors.py::_gibbs_chains_vmapped (core
// _gibbs_chains_core; reference sampler src/path_estimator.cpp:475-589)
// at every group size k != 2 (gibbs_posterior.cu takes k = 2 through
// cached pair-score CDFs, which cannot exist here: one slot's conditional
// depends on the sum of the other k - 1).  A chain starts from k paths
// uniform in [0, P) and runs burn + its iterations; an iteration redraws
// slot j = 0 .. k-1 in turn:
//
//   1. threads over rows r: base[r] = noise[r] + (sum_{i != j} probs[r, g_i]) / k,
//      the sum in slot order, recomputed at every step as the JAX
//      function does (an incremental update would round differently from
//      the plain version);
//   2. threads over (row slice s, path p): partial[s][p] = sum over the
//      slice's rows r = s, s + S, ... of
//      counts[r] * log(base[r] + probs[r, p] / k)  (-inf where <= 0);
//   3. threads over p: logits[p] = partial[0][p] + ... + partial[S-1][p]
//      + log_freqs[p] (NaN taken as -inf); a warp finds their maximum m;
//      weights w[p] = exp(logits[p] - m) (all 1 when m is not finite);
//   4. one thread draws: the first p whose running sum of w in path order
//      reaches u * total, for one uniform u.
//
// Each iteration's group is written out, burn-in included.  The logits'
// sums over r run in another order than the plain version's, so a draw
// can flip where u falls within rounding of a CDF boundary; such a chain
// leaves the plain version's (chip_smoke.py phase 12 holds those clusters
// to total variation 0.05).
//
// Random bits: Philox4x32-10 (philox.cuh) keyed by the cluster's 64-bit
// seed, the init draw of slot j at counter (chain, 0, j, tag 0), the step
// draw at (chain, iteration, j, tag 1).
// rpvg_tpu_torch/ops/posterior_gibbs_k_cuda.py posterior_gibbs_k_plain
// repeats the arithmetic in PyTorch on the same counters.
//
// Staged clusters hold their (R, P) probabilities and the workspace
// (base, partial logits) in shared memory; a cluster too large for that
// reads its probabilities from global memory (L2) and keeps the
// workspace in a global scratch.  What bounds it on an H100: the FP64
// logs, chains x (burn + its) x k x R x P of them, tens of FP64
// instructions each (chip_smoke.posterior_k_bound); the steps of one chain
// are serial, with six block barriers and one thread's O(P) draw each.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "philox.cuh"

namespace gibbs_k {

constexpr uint32_t kTagInit = 0u << 24;  // (chain, 0, slot)
constexpr uint32_t kTagStep = 1u << 24;  // (chain, iteration, slot)

struct Chains {
  const double* probs;
  const double* noise;
  const double* counts;
  const double* log_freqs;
  const int64_t* mat_offsets;    // cluster -> first probability
  const int64_t* row_offsets;    // cluster -> first noise / count
  const int64_t* col_offsets;    // cluster -> first log frequency
  const int64_t* n_rows;
  const int64_t* n_cols;
  const int64_t* n_chains;
  const int64_t* n_burn;
  const int64_t* n_its;
  const int64_t* seeds;
  const int64_t* out_offsets;    // cluster -> first int32 of its groups
  const int64_t* block_cluster;  // block -> cluster
  const int64_t* block_chain;    // block -> chain
  const int64_t* block_scratch;  // block -> its workspace in scratch (unstaged)
  const int64_t* block_ids;      // this launch's blocks
  double* scratch;
  int group_size;
  int staged;
  int32_t* out;
};

__global__ void __launch_bounds__(256) gibbs_k_kernel(Chains ch) {
  extern __shared__ double smem[];
  const int64_t blk = ch.block_ids[blockIdx.x];
  const int64_t b = ch.block_cluster[blk];
  const int64_t chain = ch.block_chain[blk];
  const int k = ch.group_size;
  const double kd = static_cast<double>(k);
  const int64_t R = ch.n_rows[b];
  const int64_t P = ch.n_cols[b];
  const double* noise = ch.noise + ch.row_offsets[b];
  const double* counts = ch.counts + ch.row_offsets[b];
  const double* lf = ch.log_freqs + ch.col_offsets[b];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int64_t L = P < T ? P : T;  // path lanes
  const int64_t S = T / L;          // row slices

  int* g = reinterpret_cast<int*>(smem);
  double* m_slot = smem + (k + 1) / 2;
  double* work = ch.staged ? m_slot + 1 : ch.scratch + ch.block_scratch[blk];
  double* base = work;
  double* part = work + R;
  const double* probs = ch.probs + ch.mat_offsets[b];
  if (ch.staged) {
    double* staged = part + S * P;
    for (int64_t e = tid; e < R * P; e += T) staged[e] = probs[e];
    probs = staged;
  }

  const uint64_t seed = static_cast<uint64_t>(ch.seeds[b]);
  const uint32_t c0 = static_cast<uint32_t>(chain);
  const double Pd = static_cast<double>(P);
  for (int j = tid; j < k; j += T) {
    const double u = philox::draw(seed, c0, 0, static_cast<uint32_t>(j), kTagInit).u0;
    const int64_t pick = static_cast<int64_t>(floor(u * Pd));
    g[j] = static_cast<int>(pick < P ? pick : P - 1);
  }
  __syncthreads();

  const int64_t steps = ch.n_burn[b] + ch.n_its[b];
  int32_t* out = ch.out + ch.out_offsets[b] + chain * steps * k;
  for (int64_t it = 0; it < steps; ++it) {
    for (int j = 0; j < k; ++j) {
      // 1. noise plus the other slots' mean probability, per row.
      for (int64_t r = tid; r < R; r += T) {
        const double* row = probs + r * P;
        double acc = j != 0 ? row[g[0]] : 0.0;
        for (int i = 1; i < k; ++i) acc += i != j ? row[g[i]] : 0.0;
        base[r] = noise[r] + acc / kd;
      }
      __syncthreads();
      // 2. partial logits per (row slice, path).
      if (tid < L * S) {
        const int64_t lane = tid % L;
        const int64_t s = tid / L;
        for (int64_t p = lane; p < P; p += L) {
          double sum = 0.0;
          for (int64_t r = s; r < R; r += S) {
            const double x = base[r] + probs[r * P + p] / kd;
            sum += counts[r] * (x > 0.0 ? log(x) : -CUDART_INF);
          }
          part[s * P + p] = sum;
        }
      }
      __syncthreads();
      // 3. logits, their maximum, the weights.
      for (int64_t p = tid; p < P; p += T) {
        double v = part[p];
        for (int64_t s = 1; s < S; ++s) v += part[s * P + p];
        v += lf[p];
        part[p] = isnan(v) ? -CUDART_INF : v;
      }
      __syncthreads();
      if (tid < 32) {
        double m = -CUDART_INF;
        for (int64_t p = tid; p < P; p += 32) m = fmax(m, part[p]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (tid == 0) *m_slot = m;
      }
      __syncthreads();
      const double m = *m_slot;
      const bool finite = isfinite(m);
      for (int64_t p = tid; p < P; p += T) part[p] = finite ? exp(part[p] - m) : 1.0;
      __syncthreads();
      // 4. the draw.
      if (tid == 0) {
        const double u =
            philox::draw(seed, c0, static_cast<uint32_t>(it), static_cast<uint32_t>(j), kTagStep)
                .u0;
        double total = 0.0;
        for (int64_t p = 0; p < P; ++p) total += part[p];
        const double target = u * total;
        double cum = 0.0;
        int64_t pick = P - 1;
        for (int64_t p = 0; p < P; ++p) {
          cum += part[p];
          if (cum >= target) {
            pick = p;
            break;
          }
        }
        g[j] = static_cast<int>(pick);
      }
      __syncthreads();
    }
    for (int j = tid; j < k; j += T) out[it * k + j] = g[j];
  }
}

}  // namespace gibbs_k

// One launch over the n_blocks blocks listed in block_ids (int64, on the
// device), `threads` threads each (32, 128 or 256), with smem_bytes of
// dynamic shared memory per block (the k slots and the maximum; with
// staged = 1 also the workspace and the cluster's probabilities), on
// `stream`.  Block i runs chain block_chain[i] of cluster
// block_cluster[i]; an unstaged block's workspace is scratch +
// block_scratch[i] (R + S P doubles).  Cluster b writes n_chains[b] x
// (n_burn[b] + n_its[b]) x group_size int32 at out_offsets[b] of out.
// Returns cudaGetLastError().
extern "C" int rpvg_gibbs_posterior_k_f64(
    const void* probs, const void* noise, const void* counts, const void* log_freqs,
    const void* mat_offsets, const void* row_offsets, const void* col_offsets,
    const void* n_rows, const void* n_cols, const void* n_chains, const void* n_burn,
    const void* n_its, const void* seeds, const void* out_offsets, const void* block_cluster,
    const void* block_chain, const void* block_scratch, const void* block_ids, void* scratch,
    int64_t n_blocks, int64_t group_size, int64_t threads, int64_t staged, int64_t smem_bytes,
    void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  const gibbs_k::Chains ch{
      static_cast<const double*>(probs),          static_cast<const double*>(noise),
      static_cast<const double*>(counts),         static_cast<const double*>(log_freqs),
      static_cast<const int64_t*>(mat_offsets),   static_cast<const int64_t*>(row_offsets),
      static_cast<const int64_t*>(col_offsets),   static_cast<const int64_t*>(n_rows),
      static_cast<const int64_t*>(n_cols),        static_cast<const int64_t*>(n_chains),
      static_cast<const int64_t*>(n_burn),        static_cast<const int64_t*>(n_its),
      static_cast<const int64_t*>(seeds),         static_cast<const int64_t*>(out_offsets),
      static_cast<const int64_t*>(block_cluster), static_cast<const int64_t*>(block_chain),
      static_cast<const int64_t*>(block_scratch), static_cast<const int64_t*>(block_ids),
      static_cast<double*>(scratch),              static_cast<int>(group_size),
      static_cast<int>(staged),                   static_cast<int32_t*>(out)};
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gibbs_k::gibbs_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gibbs_k::gibbs_k_kernel<<<dim3(static_cast<unsigned>(n_blocks)),
                            dim3(static_cast<unsigned>(threads)),
                            static_cast<size_t>(smem_bytes),
                            static_cast<cudaStream_t>(stream)>>>(ch);
  return static_cast<int>(cudaGetLastError());
}
