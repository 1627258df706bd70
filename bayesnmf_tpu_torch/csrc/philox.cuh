// Philox4x32-10 (Salmon et al., SC'11) and the uniform of one of its words,
// shared by csrc/rng.cu (the chains' random streams) and csrc/allocation.cu
// (the allocation's in-kernel stream). The plain PyTorch versions are
// ops/rng.py's philox4x32_10 and uniform_of.

#pragma once

#include <stdint.h>

struct U4 {
  uint32_t x[4];
};

__device__ __forceinline__ U4 philox4x32_10(U4 ctr, uint32_t k0,
                                            uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * ctr.x[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x[0]);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.x[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.x[2]);
    ctr = U4{{hi1 ^ ctr.x[1] ^ k0, lo1, hi0 ^ ctr.x[3] ^ k1, lo0}};
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return ctr;
}

// A word's low 24 bits j as max(j / 2^24, float32's smallest normal): in
// [tiny, 1), every value exact in float32.
__device__ __forceinline__ float philox_uniform(uint32_t w) {
  return fmaxf((float)(w & 0xFFFFFFu) * 5.9604644775390625e-8f,
               1.17549435e-38f);
}
