// A float64 natural log for finite positive arguments (denormals
// included) in straight-line code: about a third of libdevice's FP64
// instructions and no branch, so that several logs of one thread
// interleave on the FP64 pipe.
//
// x = 2^e m with m in [sqrt(1/2), sqrt(2)); j = round((m - 1) 128) in
// [-37, 53] picks table entry j + 37 = (c, l) with c = 1 / (1 + j / 128)
// rounded to float64 and l = -log(c) (c = 1 and l = 0 at j = 0, so that a
// value near 1 keeps its relative accuracy); then t = m c - 1 (one fused
// multiply-add, |t| < 0.0056) and
//
//   log(x) = e ln2 + l + log1p(t),   log1p(t) = t + t^2 q(t),
//
// q the Taylor series of (log1p(t) - t) / t^2 to t^6 (truncation below
// 1e-19 relative).  Accuracy: a few units in the last place (held against
// numpy's log by tests/test_torch_group_scores.py through the plain
// mirror rpvg_tpu_torch/ops/group_scores_cuda.py table_log, which uses
// the same table, log_table()).
#pragma once

#include <cstdint>

namespace log_f64 {

constexpr int kTableSize = 91;  // j = -37 .. 53
constexpr int kTableBias = 37;

// table: kTableSize (c, l) pairs.  x must be finite and > 0.
__device__ __forceinline__ double log_pos(double x, const double2* table) {
  const bool tiny = x < 2.2250738585072014e-308;  // a denormal: scale by 2^54
  x = tiny ? x * 18014398509481984.0 : x;
  const uint64_t bits = static_cast<uint64_t>(__double_as_longlong(x));
  const uint64_t frac = bits & 0x000fffffffffffffull;
  const bool high = frac >= 0x6a09e667f3bcdull;  // m >= sqrt(2): halve it
  const int e = static_cast<int>(bits >> 52) - 1023 - (tiny ? 54 : 0) + (high ? 1 : 0);
  const double m =
      __longlong_as_double(static_cast<long long>(frac | (high ? 0x3fe0000000000000ull
                                                                : 0x3ff0000000000000ull)));
  const int j = high ? static_cast<int>(((frac >> 45) + 1) >> 1) - 64
                     : static_cast<int>(((frac >> 44) + 1) >> 1);
  const double2 cl = table[j + kTableBias];
  const double t = fma(m, cl.x, -1.0);
  double q = -1.0 / 8.0;
  q = fma(q, t, 1.0 / 7.0);
  q = fma(q, t, -1.0 / 6.0);
  q = fma(q, t, 1.0 / 5.0);
  q = fma(q, t, -1.0 / 4.0);
  q = fma(q, t, 1.0 / 3.0);
  q = fma(q, t, -1.0 / 2.0);
  const double log1p_t = fma(t * t, q, t);
  const double ed = static_cast<double>(e);
  const double hi = fma(ed, 6.93147180369123816490e-01, cl.y);  // ln2 to 32 bits: ed x it is exact
  const double lo = fma(ed, 1.90821492927058770002e-10, log1p_t);
  return hi + lo;
}

}  // namespace log_f64
