// Collapsed Gibbs sampler of haplotype groups over k slots, float64: one
// chain per thread block, or per thread-block cluster of 2-8 CTAs for the
// largest clusters.
//
// Replaces the XLA device function
// rpvg_tpu/infer/posteriors.py::_gibbs_chains_vmapped (core
// _gibbs_chains_core; reference sampler src/path_estimator.cpp:475-589)
// at every group size k != 2 (gibbs_posterior.cu takes k = 2 through
// cached pair-score CDFs, which cannot exist here: one slot's conditional
// depends on the sum of the other k - 1).  A chain starts from k paths
// uniform in [0, P) and runs burn + its iterations; an iteration redraws
// slot j = 0 .. k-1 in turn from
//
//   logits[p] = sum_r counts[r] * log(base[r] + probs[r, p] / k) + lf[p],
//   base[r] = noise[r] + (sum_{i != j} probs[r, g_i]) / k
//
// (-inf where an argument is <= 0, NaN taken as -inf, the other slots'
// sum in slot order).  Where probs[r, p] == 0 the log is log(base[r]),
// the same for every such path, so a slot step computes one log per row
// and one per nonzero entry, never R x P:
//
//   logits[p] = Z + sum_{r in nz(p)} counts[r] * (log(base[r] + q[r, p]) - lb[r]) + lf[p],
//   lb[r] = log(base[r]),  Z = sum_r counts[r] * lb[r],  q = probs / k,
//
// with nz(p) the nonzero rows of path p (a compact list built once per
// cluster on the host, rpvg_tpu_torch/ops/posterior_gibbs_k_cuda.py
// nonzero_lists).  A row whose base is 0 (zero noise, no other slot
// there) has lb = -inf: it stays out of Z, and a path with a zero entry
// in such a row gets logit -inf, as counts * log(0) gives it there.
//
// One slot step, three barriers:
//   1. threads over the CTA's rows: base, lb, and the warp's share of Z
//      (a xor butterfly, then one partial per warp);
//      barrier;
//   2. S = a power of two of lanes per path, S <= 32, inside one warp:
//      each sums every S-th entry of the path's list in this CTA's rows,
//      the S partials join in a xor butterfly; thread 0 sums the warps'
//      Z partials in warp order;
//      cluster barrier (a block barrier for a one-CTA chain);
//   3. warp 0 of every CTA, lane l over a contiguous chunk of paths:
//      logits = Z + the CTAs' partials in rank order (distributed shared
//      memory) + lf, their maximum (butterfly), weights exp(logit - max)
//      (all 1 when the maximum is not finite), a warp prefix scan of the
//      lanes' chunk sums, a ballot for the first lane whose running sum
//      reaches u * total, and that lane's walk of its chunk (the chunk's
//      last path when rounding leaves the walk short); every CTA draws
//      the same path from the same numbers, so nothing is broadcast;
//      barrier.
// The partials are double-buffered by slot step, so one cluster barrier
// per step keeps a CTA from overwriting what another still reads.
//
// The kernel's logits round apart from the plain version's (the sum is
// split into Z and the list terms, and taken in another order), so a
// draw can flip where u falls within rounding of a CDF boundary; such a
// chain leaves the plain version's (chip_smoke.py phase 12 holds those
// clusters to total variation 0.05 and counts them).
//
// Random bits: Philox4x32-10 (philox.cuh) keyed by the cluster's 64-bit
// seed, the init draw of slot j at counter (chain, 0, j, tag 0), the step
// draw at (chain, iteration, j, tag 1).
// rpvg_tpu_torch/ops/posterior_gibbs_k_cuda.py posterior_gibbs_k_plain
// repeats the function in PyTorch on the same counters.
//
// A CTA stages its rows' noise, counts and workspace, and its slice of
// the nonzero lists, in shared memory; a slice too large for that is read
// from global memory (L2) with the workspace in a global scratch.  The
// dense probabilities are read from global memory in step 1 only (k - 1
// per row).  What bounds it on an H100: the FP64 logs, chains x
// (burn + its) x k x (R + nonzeros) of them, tens of FP64 instructions
// each (chip_smoke.posterior_bound); the steps of one chain are serial,
// so the longest chain sets a floor of its slot steps x one step's
// latency (three barriers, a log chain, warp 0's draw).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "philox.cuh"

// Cycle probes for tools/torch_gibbs_profile.py: a build with
// -DRPVG_GIBBS_PROFILE adds, in thread 0 of block 0, the cycles between
// consecutive marks of a slot step into g_prof.
#ifdef RPVG_GIBBS_PROFILE
__device__ long long g_prof[8];
#define PROF_START long long prof_t = clock64()
#define PROF_MARK(i)                                                 \
  do {                                                               \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                       \
      const long long prof_now = clock64();                          \
      g_prof[i] += prof_now - prof_t;                                \
      prof_t = prof_now;                                             \
    }                                                                \
  } while (0)
#else
#define PROF_START
#define PROF_MARK(i)
#endif

namespace gibbs_k {

namespace cg = cooperative_groups;

constexpr uint32_t kTagInit = 0u << 24;  // (chain, 0, slot)
constexpr uint32_t kTagStep = 1u << 24;  // (chain, iteration, slot)

struct Chains {
  const double* probs;           // row-major (R, P) per cluster, step 1
  const double* noise;
  const double* counts;
  const double* log_freqs;
  const int32_t* nz_rows;        // list entry -> row, local to its CTA's slice
  const double* nz_q;            // list entry -> probs[r, p] / k
  const int32_t* nz_ptr;         // cluster -> (CTA, path) -> first entry, C P + 1
  const int64_t* mat_offsets;    // cluster -> first probability
  const int64_t* row_offsets;    // cluster -> first noise / count
  const int64_t* col_offsets;    // cluster -> first log frequency
  const int64_t* nz_offsets;     // cluster -> first list entry
  const int64_t* ptr_offsets;    // cluster -> first nz_ptr
  const int64_t* n_rows;
  const int64_t* n_cols;
  const int64_t* n_burn;
  const int64_t* n_its;
  const int64_t* seeds;
  const int64_t* out_offsets;    // cluster -> first int32 of its groups
  const int64_t* chain_cluster;  // chain entry -> cluster
  const int64_t* chain_index;    // chain entry -> chain of its cluster
  const int64_t* chain_scratch;  // chain entry -> its workspace in scratch (unstaged)
  const int64_t* chain_ids;      // this launch's chain entries
  double* scratch;
  int group_size;
  int ctas;                      // CTAs per chain (the cluster size)
  int staged;
  int32_t* out;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A list entry's term of its path's partial logit: counts x (log(base +
// q) - log base), or counts x log(base + q) and one more hit where the
// row's base is 0.
__device__ __forceinline__ double list_term(int32_t r, double q, const double* base,
                                            const double* lb, const double* counts, int& hits) {
  const double x = base[r] + q;
  const double lx = x > 0.0 ? log(x) : -CUDART_INF;
  const double l0 = lb[r];
  if (l0 > -CUDART_INF) return counts[r] * (lx - l0);
  ++hits;
  return counts[r] * lx;
}

__global__ void __launch_bounds__(1024) gibbs_k_kernel(Chains ch) {
  extern __shared__ double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = ch.ctas;
  const int rank = ctas > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int64_t entry = ch.chain_ids[blockIdx.x / ctas];
  const int64_t b = ch.chain_cluster[entry];
  const int64_t chain = ch.chain_index[entry];
  const int k = ch.group_size;
  const double kd = static_cast<double>(k);
  const int64_t R = ch.n_rows[b];
  const int64_t P = ch.n_cols[b];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;

  // This CTA's rows [r0, r0 + Rc).
  const int64_t rows_per = (R + ctas - 1) / ctas;
  const int64_t r0 = lmin(R, rank * rows_per);
  const int64_t Rc = lmin(R, r0 + rows_per) - r0;
  const double* probs = ch.probs + ch.mat_offsets[b] + r0 * P;
  const double* noise = ch.noise + ch.row_offsets[b] + r0;
  const double* counts = ch.counts + ch.row_offsets[b] + r0;
  const double* lf = ch.log_freqs + ch.col_offsets[b];
  const int32_t* ptr = ch.nz_ptr + ch.ptr_offsets[b] + rank * P;
  const int32_t* rows = ch.nz_rows + ch.nz_offsets[b];
  const double* q = ch.nz_q + ch.nz_offsets[b];

  // Shared memory: the slots, warp 0's weights, the double-buffered
  // partials (logits, bad-row hits, Z and bad rows), the warps' Z
  // partials, the log frequencies, then (staged) the rows and the list
  // slice.
  int* g = reinterpret_cast<int*>(smem);
  double* w = smem + (k + 1) / 2;
  double* part = w + P;                                // 2 P
  int* bad = reinterpret_cast<int*>(part + 2 * P);     // 2 P
  double* zc = part + 3 * P;                           // 2
  double* nbc = zc + 2;                                // 2
  double* zpart = nbc + 2;                             // 32
  double* nbpart = zpart + 32;                         // 32
  double* s_lf = nbpart + 32;                          // P
  double* body = s_lf + P;
  double* base;
  double* lb;
  if (ch.staged) {
    const int32_t first = ptr[0];
    const int64_t n_nz = ptr[P] - first;
    double* s_noise = body;
    double* s_counts = body + Rc;
    base = body + 2 * Rc;
    lb = body + 3 * Rc;
    double* s_q = body + 4 * Rc;
    int32_t* s_rows = reinterpret_cast<int32_t*>(s_q + n_nz);
    int32_t* s_ptr = s_rows + n_nz;
    for (int64_t r = tid; r < Rc; r += T) {
      s_noise[r] = noise[r];
      s_counts[r] = counts[r];
    }
    for (int64_t e = tid; e < n_nz; e += T) {
      s_q[e] = q[first + e];
      s_rows[e] = rows[first + e];
    }
    for (int64_t p = tid; p <= P; p += T) s_ptr[p] = ptr[p] - first;
    noise = s_noise;
    counts = s_counts;
    q = s_q;
    rows = s_rows;
    ptr = s_ptr;
  } else {
    base = ch.scratch + ch.chain_scratch[entry] + rank * 2 * rows_per;
    lb = base + Rc;
  }

  for (int64_t p = tid; p < P; p += T) s_lf[p] = lf[p];
  lf = s_lf;
  const uint64_t seed = static_cast<uint64_t>(ch.seeds[b]);
  const uint32_t c0 = static_cast<uint32_t>(chain);
  const double Pd = static_cast<double>(P);
  for (int j = tid; j < k; j += T) {
    const double u = philox::draw(seed, c0, 0, static_cast<uint32_t>(j), kTagInit).u0;
    const int64_t pick = static_cast<int64_t>(floor(u * Pd));
    g[j] = static_cast<int>(pick < P ? pick : P - 1);
  }
  __syncthreads();

  // Step 2's lanes: S per path (a power of two, S P <= T where it can).
  int S = 1;
  while (S < 32 && 2 * S * P <= T) S <<= 1;
  const int s = tid & (S - 1);
  const int64_t group = tid / S;
  const int64_t groups = T / S;
  // Step 3's chunk of paths per lane.
  const int64_t chunk = (P + 31) / 32;
  const int64_t lo = lmin(P, lane * chunk);
  const int64_t hi = lmin(P, lo + chunk);

  const int64_t steps = ch.n_burn[b] + ch.n_its[b];
  int32_t* out = ch.out + ch.out_offsets[b] + chain * steps * k;
  int buf = 0;
  for (int64_t it = 0; it < steps; ++it) {
    for (int j = 0; j < k; ++j) {
      PROF_START;
      // The slot's uniform, drawn ahead of the step that reads it.
      const double u =
          warp == 0
              ? philox::draw(seed, c0, static_cast<uint32_t>(it), static_cast<uint32_t>(j),
                             kTagStep)
                    .u0
              : 0.0;
      // 1. base, its log, the warp's share of Z and of the bad rows.
      double z = 0.0;
      int n_bad = 0;
      for (int64_t r = tid; r < Rc; r += T) {
        const double* row = probs + r * P;
        double acc = j != 0 ? row[g[0]] : 0.0;
        for (int i = 1; i < k; ++i) acc += i != j ? row[g[i]] : 0.0;
        const double x = noise[r] + acc / kd;
        const double l = x > 0.0 ? log(x) : -CUDART_INF;
        base[r] = x;
        lb[r] = l;
        if (x > 0.0) {
          z += counts[r] * l;
        } else {
          ++n_bad;
        }
      }
      z = warp_sum(z);
      n_bad = warp_sum(n_bad);
      if (lane == 0) {
        zpart[warp] = z;
        nbpart[warp] = static_cast<double>(n_bad);
      }
      PROF_MARK(0);
      __syncthreads();
      PROF_MARK(1);
      // 2. this CTA's partial logits over the paths' nonzero lists.
      if (tid == 0) {
        double zt = 0.0, nt = 0.0;
        for (int v = 0; v < n_warps; ++v) {
          zt += zpart[v];
          nt += nbpart[v];
        }
        zc[buf] = zt;
        nbc[buf] = nt;
      }
      for (int64_t p0 = 0; p0 < P; p0 += groups) {
        const int64_t p = p0 + group;
        double sum = 0.0;
        int hits = 0;
        if (p < P) {
          // Two entries at a time, two sums: their logs overlap.
          const int32_t end = ptr[p + 1];
          double other = 0.0;
          int32_t e = ptr[p] + s;
          for (; e + S < end; e += 2 * S) {
            sum += list_term(rows[e], q[e], base, lb, counts, hits);
            other += list_term(rows[e + S], q[e + S], base, lb, counts, hits);
          }
          if (e < end) sum += list_term(rows[e], q[e], base, lb, counts, hits);
          sum += other;
        }
        for (int off = S >> 1; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
          hits += __shfl_xor_sync(0xffffffffu, hits, off);
        }
        if (s == 0 && p < P) {
          part[buf * P + p] = sum;
          bad[buf * P + p] = hits;
        }
      }
      PROF_MARK(2);
      if (ctas > 1) {
        cluster.sync();
      } else {
        __syncthreads();
      }
      PROF_MARK(3);
      // 3. warp 0 of every CTA draws the slot.
      if (warp == 0) {
        double zt = 0.0, nt = 0.0;
        for (int c = 0; c < ctas; ++c) {
          const double* zr = ctas > 1 ? cluster.map_shared_rank(zc, c) : zc;
          const double* nr = ctas > 1 ? cluster.map_shared_rank(nbc, c) : nbc;
          zt += zr[buf];
          nt += nr[buf];
        }
        double m = -CUDART_INF;
        for (int64_t p = lo; p < hi; ++p) {
          double v = zt;
          int hits = 0;
          for (int c = 0; c < ctas; ++c) {
            const double* pr = ctas > 1 ? cluster.map_shared_rank(part, c) : part;
            const int* br = ctas > 1 ? cluster.map_shared_rank(bad, c) : bad;
            v += pr[buf * P + p];
            hits += br[buf * P + p];
          }
          v += lf[p];
          if (static_cast<double>(hits) < nt || isnan(v)) v = -CUDART_INF;
          w[p] = v;
          m = fmax(m, v);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
        const bool finite = isfinite(m);
        double own = 0.0;
        for (int64_t p = lo; p < hi; ++p) {
          const double wp = finite ? exp(w[p] - m) : 1.0;
          w[p] = wp;
          own += wp;
        }
        double incl = own;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        double excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.0;
        const double total = __shfl_sync(0xffffffffu, incl, 31);
        const double target = u * total;
        const unsigned reach = __ballot_sync(0xffffffffu, hi > lo && incl >= target);
        const int first = reach ? __ffs(reach) - 1 : -1;
        int64_t pick = P - 1;
        if (lane == first) {
          double cum = excl;
          pick = hi - 1;
          for (int64_t p = lo; p < hi; ++p) {
            cum += w[p];
            if (cum >= target) {
              pick = p;
              break;
            }
          }
        }
        if (first >= 0) pick = __shfl_sync(0xffffffffu, pick, first);
        if (lane == 0) g[j] = static_cast<int>(pick);
      }
      PROF_MARK(4);
      __syncthreads();
      PROF_MARK(5);
      buf ^= 1;
    }
    if (rank == 0) {
      for (int j = tid; j < k; j += T) out[it * k + j] = g[j];
    }
  }
  // No CTA leaves while another may still read its shared memory.
  if (ctas > 1) cluster.sync();
}

}  // namespace gibbs_k

// One launch over the n_chains chain entries listed in chain_ids (int64,
// on the device), each a cluster of `ctas` CTAs of `threads` threads
// (a multiple of 32, at most 1,024), with smem_bytes of dynamic shared
// memory per CTA (the slots and partials; with staged = 1 also the CTA's
// rows and list slice), on `stream`.  Entry i runs chain chain_index[i]
// of cluster chain_cluster[i]; an unstaged CTA of rank c keeps base and
// its log at scratch + chain_scratch[i] + 2 c ceil(R / ctas).  Cluster b
// writes (n_burn[b] + n_its[b]) x group_size int32 per chain at
// out_offsets[b] of out.  Returns the launch's CUDA error.
extern "C" int rpvg_gibbs_posterior_k_f64(
    const void* probs, const void* noise, const void* counts, const void* log_freqs,
    const void* nz_rows, const void* nz_q, const void* nz_ptr, const void* mat_offsets,
    const void* row_offsets, const void* col_offsets, const void* nz_offsets,
    const void* ptr_offsets, const void* n_rows, const void* n_cols, const void* n_burn,
    const void* n_its, const void* seeds, const void* out_offsets, const void* chain_cluster,
    const void* chain_index, const void* chain_scratch, const void* chain_ids, void* scratch,
    int64_t n_chains, int64_t group_size, int64_t threads, int64_t ctas, int64_t staged,
    int64_t smem_bytes, void* out, void* stream) {
  if (n_chains <= 0) return 0;
  const gibbs_k::Chains ch{
      static_cast<const double*>(probs),          static_cast<const double*>(noise),
      static_cast<const double*>(counts),         static_cast<const double*>(log_freqs),
      static_cast<const int32_t*>(nz_rows),       static_cast<const double*>(nz_q),
      static_cast<const int32_t*>(nz_ptr),        static_cast<const int64_t*>(mat_offsets),
      static_cast<const int64_t*>(row_offsets),   static_cast<const int64_t*>(col_offsets),
      static_cast<const int64_t*>(nz_offsets),    static_cast<const int64_t*>(ptr_offsets),
      static_cast<const int64_t*>(n_rows),        static_cast<const int64_t*>(n_cols),
      static_cast<const int64_t*>(n_burn),        static_cast<const int64_t*>(n_its),
      static_cast<const int64_t*>(seeds),         static_cast<const int64_t*>(out_offsets),
      static_cast<const int64_t*>(chain_cluster), static_cast<const int64_t*>(chain_index),
      static_cast<const int64_t*>(chain_scratch), static_cast<const int64_t*>(chain_ids),
      static_cast<double*>(scratch),              static_cast<int>(group_size),
      static_cast<int>(ctas),                     static_cast<int>(staged),
      static_cast<int32_t*>(out)};
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gibbs_k::gibbs_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_chains * ctas));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = ctas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, gibbs_k::gibbs_k_kernel, ch);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
