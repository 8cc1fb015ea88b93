// The two sweeps of the exact-list kernels' tile loop (lj_cluster_ilist.cu,
// eam_cluster.cu): a distance sweep that marks, in a lane mask, the staged
// j atoms inside this thread's cutoff, and the pair math over the marked
// atoms only, in ascending order. The kernels' headers say why.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ilist_sweep {

// staged j atoms per chunk: sweep A fills one kChunk-bit mask, sweep B
// pops it; a tile holds a whole number of chunks (kChunkJ16 j16 each)
constexpr int kChunk = 128;
constexpr int kChunkJ16 = kChunk / 16;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// (dx*dx + dy*dy) + dz*dz with every operation rounded on its own, the
// plain version's order: no fused multiply-add may change the pair set
template <typename T>
__device__ __forceinline__ T rsq_rn(T dx, T dy, T dz) {
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

// A lane's mask over one chunk, two 64-bit words. set() takes a bit index
// that is a compile-time constant once sweep A's loop is unrolled, so the
// mask stays in registers; pop() returns and clears the lowest set bit.
struct Mask {
  uint64_t lo = 0, hi = 0;
  __device__ __forceinline__ void set(int k) {
    if (k < 64) lo |= 1ull << k; else hi |= 1ull << (k - 64);
  }
  // clear the bits at and above `left` (all of them if left <= 0)
  __device__ __forceinline__ void keep_below(int left) {
    if (left < 64) lo = left > 0 ? lo & ((1ull << left) - 1ull) : 0ull;
    const int lh = left - 64;
    if (lh < 64) hi = lh > 0 ? hi & ((1ull << lh) - 1ull) : 0ull;
  }
  __device__ __forceinline__ bool any() const { return (lo | hi) != 0; }
  __device__ __forceinline__ int pop() {
    const bool first = lo != 0;
    const uint64_t b = first ? lo : hi;
    const int k = __ffsll(static_cast<long long>(b)) - 1 + (first ? 0 : 64);
    const uint64_t rest = b & (b - 1ull);
    if (first) lo = rest; else hi = rest;
    return k;
  }
};
static_assert(kChunk == 128, "Mask holds 128 bits");

// the 16 bytes at p (16-byte aligned shared memory) as 16 / sizeof(T)
// values
template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const double2 a = *reinterpret_cast<const double2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}

// Sweep A over staged coordinate planes: bit k is set where atom c0 + k
// satisfies 0 < rsq < cutsq against (xi, yi, zi). A NaN rsq fails both
// tests, as the plain version's mask does. c0 is a multiple of kChunk and
// the planes are 16-byte aligned, so each plane is read as 16-byte
// vectors.
template <typename T>
__device__ __forceinline__ Mask sweep_planes(const T* sx, const T* sy, const T* sz,
                                             int c0, T xi, T yi, T zi, T cutsq) {
  constexpr int kVec = 16 / sizeof(T);
  Mask mask;
#pragma unroll
  for (int k = 0; k < kChunk; k += kVec) {
    T x[kVec], y[kVec], z[kVec];
    load16(sx + c0 + k, x);
    load16(sy + c0 + k, y);
    load16(sz + c0 + k, z);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const T rsq = rsq_rn(xi - x[v], yi - y[v], zi - z[v]);
      if (rsq < cutsq && rsq > T(0)) mask.set(k + v);
    }
  }
  return mask;
}

// (dx*dx + dy*dy) + dz*dz of two pairs in bfloat16, each operation rounded
// on its own (the bf16 form's rsq)
__device__ __forceinline__ __nv_bfloat162 rsq_bf16x2(__nv_bfloat162 dx, __nv_bfloat162 dy,
                                                     __nv_bfloat162 dz) {
  return __hadd2_rn(__hadd2_rn(__hmul2_rn(dx, dx), __hmul2_rn(dy, dy)),
                    __hmul2_rn(dz, dz));
}

// Sweep A of the bf16 form (T2) over staged float32 planes: bit k is set
// where atom c0 + k satisfies 0 < rsq < cut in bfloat16, rsq_bf16x2 of the
// distances subtracted in float32 and rounded to bfloat16. `cut` must be
// the smallest bfloat16 value >= the float32 cutoff c (the wrapper rounds
// it up): for a bfloat16 rsq, rsq < cut holds exactly where rsq < c does,
// so the pairs are those of the plain version's test on rsq's float32
// value. The compares are ordered (a NaN rsq sets no bit). Atoms k and
// k + 16 of each 32 share one packed lane pair, so the two bits of the
// packed compares (0 and 16) land at bits k and k + 16 of the 32 atoms'
// mask word with one shift. The loops over the four words and over a
// word's four vector steps stay rolled: on the H100 that ran 6% faster
// than the unrolled chunk (56 registers against 72).
__device__ __forceinline__ Mask sweep_planes_bf16(const float* sx, const float* sy,
                                                  const float* sz, int c0, float xi,
                                                  float yi, float zi,
                                                  __nv_bfloat162 cut) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
  Mask mask;
#pragma unroll 1
  for (int g = 0; g < kChunk / 32; ++g) {
    uint32_t w = 0;
#pragma unroll 1
    for (int k = 0; k < 16; k += 4) {
      const int a = c0 + 32 * g + k;
      float xa[4], ya[4], za[4], xb[4], yb[4], zb[4];
      load16(sx + a, xa);
      load16(sy + a, ya);
      load16(sz + a, za);
      load16(sx + a + 16, xb);
      load16(sy + a + 16, yb);
      load16(sz + a + 16, zb);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const __nv_bfloat162 rsq =
            rsq_bf16x2(__floats2bfloat162_rn(xi - xa[v], xi - xb[v]),
                       __floats2bfloat162_rn(yi - ya[v], yi - yb[v]),
                       __floats2bfloat162_rn(zi - za[v], zi - zb[v]));
        w |= (__hlt2_mask(rsq, cut) & __hgt2_mask(rsq, zero) & 0x10001u) << (k + v);
      }
    }
    const uint64_t wide = static_cast<uint64_t>(w) << (32 * (g & 1));
    if (g < 2) mask.lo |= wide; else mask.hi |= wide;
  }
  return mask;
}

// A tile's j16 count for a staging budget of `budget` j16: a whole number
// of chunks, at least one
constexpr int whole_chunks(int budget) {
  return (budget / kChunkJ16 > 0 ? budget / kChunkJ16 : 1) * kChunkJ16;
}

}  // namespace ilist_sweep
