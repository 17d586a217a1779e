// Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11; the Random123
// library's philox4x32_R with R = 10), written out for the Gibbs samplers.
//
// The same function is rpvg_tpu_torch.prng.philox4x32 on 64-bit integers
// (numpy or torch), which the samplers' plain PyTorch versions call, so a
// kernel and its plain version draw the same bits.  Known answers
// (Random123 kat_vectors): counter 0, key 0 gives 6627e8d5 e169c58d
// bc57ac4c 9b00dbd8.
//
// A draw is addressed by a counter (what is being drawn, never a running
// state), so a job's stream does not depend on how many draws other jobs
// or its own earlier or later iterations make.
#pragma once

#include <cstdint>

namespace philox {

struct Words {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{c0, c1, c2, c3};
}

// Two doubles in (0, 1): words (0, 1) and (2, 3) each as one 64-bit
// integer, whose top 52 bits plus one half are scaled by 2^-52 (exact, so
// never 0 or 1).
struct Uniforms {
  double u0, u1;
};

__device__ __forceinline__ Uniforms uniforms(const Words& w) {
  const double scale = 1.0 / 4503599627370496.0;
  const uint64_t a = (static_cast<uint64_t>(w.w0) << 20) + (w.w1 >> 12);
  const uint64_t b = (static_cast<uint64_t>(w.w2) << 20) + (w.w3 >> 12);
  return Uniforms{(static_cast<double>(a) + 0.5) * scale, (static_cast<double>(b) + 0.5) * scale};
}

// The pair of uniforms at counter (c0, c1, c2, c3) of the stream keyed by
// a 64-bit seed (high word first, as a threefry key's two words).
__device__ __forceinline__ Uniforms draw(uint64_t seed, uint32_t c0, uint32_t c1, uint32_t c2,
                                         uint32_t c3) {
  return uniforms(philox4x32_10(c0, c1, c2, c3, static_cast<uint32_t>(seed >> 32),
                                static_cast<uint32_t>(seed)));
}

}  // namespace philox
