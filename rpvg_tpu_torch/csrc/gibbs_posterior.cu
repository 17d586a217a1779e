// Collapsed Gibbs sampler of diploid haplotype pairs, one block per
// cluster, float64 scores.
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
//   1. threads over rows o: the row's maximum m, then the prefix sums of
//      exp(score[o, p] - m) in column order, each divided by the row's
//      total (a row with no finite maximum gets a uniform CDF);
//   2. threads over chains: the two slots start uniform over the P paths,
//      then burn + its steps each draw slot 0 given slot 1 and slot 1
//      given the new slot 0, by a binary search for the first CDF entry
//      not below a uniform; the pairs after burn-in are written out.
//
// Random bits: Philox4x32-10 (philox.cuh) keyed by the cluster's 64-bit
// seed, at counter (chain, step, 0, tag): each chain is its own stream.
// rpvg_tpu_torch/ops/posterior_gibbs_cuda.py posterior_gibbs_plain
// repeats this arithmetic in PyTorch on the same counters; its CDFs
// differ from the kernel's (multiply-adds fused here) in the last bits at
// most, so a chain leaves the plain version's only where that flips a
// search.
//
// The CDFs live in shared memory when P * P doubles fit, else in a
// global scratch of the same layout.  What bounds it on an H100: the
// serial steps of one chain (burn + its, 150 + 0.3 P), two dependent
// binary searches of log2 P loads each per step; bytes and operations
// are far below a millisecond at the main path's sizes (chip_smoke.py
// phase 8).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace gibbs_post {

constexpr uint32_t kTagInit = 0u << 24;  // (chain, 0, 0)
constexpr uint32_t kTagStep = 1u << 24;  // (chain, step, 0)

struct Clusters {
  const double* scores;
  const int64_t* score_offsets;  // cluster -> first score
  const int64_t* strides;        // cluster -> row stride of its scores
  const int64_t* n_cols;
  const int64_t* n_chains;
  const int64_t* n_burn;
  const int64_t* n_its;
  const int64_t* seeds;
  const int64_t* cdf_offsets;    // cluster -> its P * P CDF in the scratch
  const int64_t* out_offsets;    // cluster -> first int32 of its pairs
  const int64_t* cluster_ids;    // this launch's clusters
  int staged;
  double* cdf_scratch;
  int32_t* out;
};

__device__ __forceinline__ int64_t lower_bound(const double* cdf, int64_t P, double u) {
  int64_t lo = 0;
  int64_t hi = P;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (cdf[mid] < u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < P ? lo : P - 1;
}

__global__ void __launch_bounds__(256) posterior_gibbs_kernel(Clusters cl) {
  extern __shared__ double smem[];
  const int64_t b = cl.cluster_ids[blockIdx.x];
  const int64_t P = cl.n_cols[b];
  const int64_t stride = cl.strides[b];
  const double* scores = cl.scores + cl.score_offsets[b];
  double* cdf = cl.staged ? smem : cl.cdf_scratch + cl.cdf_offsets[b];
  const uint64_t seed = static_cast<uint64_t>(cl.seeds[b]);

  for (int64_t o = threadIdx.x; o < P; o += blockDim.x) {
    const double* row = scores + o * stride;
    double* out = cdf + o * P;
    double m = row[0];
    for (int64_t p = 1; p < P; ++p) m = fmax(m, row[p]);
    const bool finite = isfinite(m);
    double acc = 0.0;
    for (int64_t p = 0; p < P; ++p) {
      acc += finite ? exp(row[p] - m) : 1.0;
      out[p] = acc;
    }
    for (int64_t p = 0; p < P; ++p) out[p] = out[p] / acc;
  }
  __syncthreads();

  const int64_t burn = cl.n_burn[b];
  const int64_t its = cl.n_its[b];
  const double Pd = static_cast<double>(P);
  int32_t* pairs = cl.out + cl.out_offsets[b];
  for (int64_t chain = threadIdx.x; chain < cl.n_chains[b]; chain += blockDim.x) {
    const uint32_t ch = static_cast<uint32_t>(chain);
    const philox::Uniforms init = philox::draw(seed, ch, 0, 0, kTagInit);
    int64_t g0 = static_cast<int64_t>(floor(init.u0 * Pd));
    int64_t g1 = static_cast<int64_t>(floor(init.u1 * Pd));
    g0 = g0 < P ? g0 : P - 1;
    g1 = g1 < P ? g1 : P - 1;
    for (int64_t it = 0; it < burn + its; ++it) {
      const philox::Uniforms u = philox::draw(seed, ch, static_cast<uint32_t>(it), 0, kTagStep);
      g0 = lower_bound(cdf + g1 * P, P, u.u0);
      g1 = lower_bound(cdf + g0 * P, P, u.u1);
      if (it >= burn) {
        const int64_t rec = chain * its + (it - burn);
        pairs[2 * rec] = static_cast<int32_t>(g0);
        pairs[2 * rec + 1] = static_cast<int32_t>(g1);
      }
    }
  }
}

}  // namespace gibbs_post

// One launch over the n_clusters clusters listed in cluster_ids (int64,
// on the device), one block of `threads` threads (a multiple of 32, at
// most 256) each, with the CDFs in smem_bytes of shared memory per block
// (staged = 1) or in cdf_scratch at cdf_offsets (staged = 0), on
// `stream`.  Cluster b's (P, P) scores start at score_offsets[b] with row
// stride strides[b]; it runs n_chains[b] chains of n_burn[b] + n_its[b]
// steps with the Philox stream keyed by seeds[b], and writes
// n_chains[b] x n_its[b] int32 pairs at out_offsets[b] of out.  Returns
// cudaGetLastError().
extern "C" int rpvg_gibbs_posterior_f64(
    const void* scores, const void* score_offsets, const void* strides, const void* n_cols,
    const void* n_chains, const void* n_burn, const void* n_its, const void* seeds,
    const void* cdf_offsets, const void* out_offsets, const void* cluster_ids,
    int64_t n_clusters, int64_t threads, int64_t staged, int64_t smem_bytes,
    void* cdf_scratch, void* out, void* stream) {
  if (n_clusters <= 0) return 0;
  const gibbs_post::Clusters cl{
      static_cast<const double*>(scores),       static_cast<const int64_t*>(score_offsets),
      static_cast<const int64_t*>(strides),     static_cast<const int64_t*>(n_cols),
      static_cast<const int64_t*>(n_chains),    static_cast<const int64_t*>(n_burn),
      static_cast<const int64_t*>(n_its),       static_cast<const int64_t*>(seeds),
      static_cast<const int64_t*>(cdf_offsets), static_cast<const int64_t*>(out_offsets),
      static_cast<const int64_t*>(cluster_ids), static_cast<int>(staged),
      static_cast<double*>(cdf_scratch),        static_cast<int32_t*>(out)};
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(gibbs_post::posterior_gibbs_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gibbs_post::posterior_gibbs_kernel<<<dim3(static_cast<unsigned>(n_clusters)),
                                       dim3(static_cast<unsigned>(threads)),
                                       static_cast<size_t>(smem_bytes),
                                       static_cast<cudaStream_t>(stream)>>>(cl);
  return static_cast<int>(cudaGetLastError());
}
