// Group-window Lennard-Jones force for the cluster-pair scheme, for Hopper
// (sm_90a). Replaces mdbench_tpu/ops/pallas/lj_cluster.py::_kernel_stream
// (the TPU kernel launched by lj_cluster_force_pallas_stream), untyped.
//
// Contract (the same as the TPU kernel's):
//   xc, yc, zc   (C_total, 8) coordinate planes; j16 id c covers the 16
//                atoms of rows 2c and 2c+1, i.e. flat atoms 16c .. 16c+15
//   jlist        (ng, L) int32 j16 ids shared by the 16 i-clusters of
//                group g (rows 16g .. 16g+15), L a multiple of 8; tile s
//                is the 8 entries 8s .. 8s+7 (128 j atoms)
//   ranges       (ng, 33) int32: member m's window [start, end) in tiles
//                at [m] and [16+m], the group's tile bound njg at [32]
//   fx, fy, fz   (ng*16, 8), written (not accumulated): the i-atom in
//                slot a of member m of group g gets, in row 16g+m column
//                a, the sum of d_ij * 48 eps sr6 (sr6 - 1/2) sr2 over the
//                atoms of every tile s < njg with start[m] <= s < end[m],
//                where 0 < rsq < cutforcesq
// Every id of a tile below njg is read, so entries past the group's nj
// must be valid j16 rows too (the sentinel j16, or a real j16 more than
// cutneigh from the whole group, as mdbench_tpu's lists hold there): the
// cutoff test, not the list length, removes them.
//
// Design. One block of 128 threads per group, one thread per i-atom
// (member t/8, slot t%8). For each tile below njg the whole block stages
// the tile's 128 j atoms in shared memory, one atom per thread (16
// consecutive threads read one j16's 16 consecutive coordinates), and the
// threads whose member's window holds the tile run the 128 pairs against
// them as shared-memory broadcasts. The window test sits between the two
// barriers and never skips one: njg is uniform across the block. The sum
// stays in registers and runs in tile order, so the result is
// deterministic and needs no atomics. None of the TPU kernel's layout
// work is carried over: no per-step pre-gather of the tiles
// (repack_jtiles), no unrolled tile loop, no revolving output block or
// ones-dot lane reduction.
//
// What bounds it on the card: the pair arithmetic over the window pairs
// (one divide and ~20 flops per pair inside the cutoff); each staged
// coordinate is reused by up to 128 threads. A warp holds four members,
// and where their windows differ the warp runs the tile with the other
// members' lanes idle.
//
// Padding atoms sit at ~1e30; in float32 their rsq overflows to inf and
// two coinciding padding atoms give rsq == 0. The cutoff test therefore
// SELECTS (a branch around the pair math), never multiplies by a 0/1
// mask (inf * 0 = NaN). rsq is computed with explicitly rounded
// operations, in the plain version's order, so the kernel keeps exactly
// the plain version's pair set even where the compiler would contract
// it into fused multiply-adds. The reciprocal is an IEEE divide.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;             // i-clusters per group
constexpr int kThreads = kGroup * 8;   // one thread per i-atom of the group
constexpr int kTileJ16 = 8;            // j16 per tile
constexpr int kTileAtoms = kTileJ16 * 16;
constexpr int kRanges = 2 * kGroup + 1;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lj_cluster_stream_kernel(const T* __restrict__ xc, const T* __restrict__ yc,
                         const T* __restrict__ zc,
                         const int32_t* __restrict__ jlist,
                         const int32_t* __restrict__ ranges,
                         T* __restrict__ fx, T* __restrict__ fy,
                         T* __restrict__ fz, int L, T cutforcesq, T sigma6,
                         T epsilon) {
  __shared__ T sx[kTileAtoms], sy[kTileAtoms], sz[kTileAtoms];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int m = t / 8;  // member of the group
  const int32_t* rg = ranges + static_cast<int64_t>(g) * kRanges;
  const int njg = min(max(rg[2 * kGroup], 0), L / kTileJ16);
  const int start = rg[m];
  const int end = rg[kGroup + m];
  const int32_t* list = jlist + static_cast<int64_t>(g) * L;

  const int64_t row = static_cast<int64_t>(g) * kThreads + t;
  const T xi = xc[row], yi = yc[row], zi = zc[row];
  T ax = T(0), ay = T(0), az = T(0);

  for (int s = 0; s < njg; ++s) {
    const int64_t src =
        static_cast<int64_t>(list[s * kTileJ16 + t / 16]) * 16 + t % 16;
    sx[t] = xc[src];
    sy[t] = yc[src];
    sz[t] = zc[src];
    __syncthreads();
    if (s >= start && s < end) {
#pragma unroll 4
      for (int e = 0; e < kTileAtoms; ++e) {
        const T dx = xi - sx[e];
        const T dy = yi - sy[e];
        const T dz = zi - sz[e];
        const T rsq = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
        if (rsq < cutforcesq && rsq > T(0)) {
          const T sr2 = T(1) / rsq;
          const T sr6 = sr2 * sr2 * sr2 * sigma6;
          const T gf = T(48) * epsilon * sr6 * (sr6 - T(0.5)) * sr2;
          ax += dx * gf;
          ay += dy * gf;
          az += dz * gf;
        }
      }
    }
    __syncthreads();
  }
  fx[row] = ax;
  fy[row] = ay;
  fz[row] = az;
}

template <typename T>
int launch(const T* xc, const T* yc, const T* zc, const int32_t* jlist,
           const int32_t* ranges, T* fx, T* fy, T* fz, int ng, int L,
           T cutforcesq, T sigma6, T epsilon, void* stream) {
  if (ng <= 0 || L <= 0 || L % kTileJ16) return cudaErrorInvalidValue;
  lj_cluster_stream_kernel<T><<<ng, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      xc, yc, zc, jlist, ranges, fx, fy, fz, L, cutforcesq, sigma6, epsilon);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lj_cluster_stream_f32(const float* xc, const float* yc,
                                     const float* zc, const int32_t* jlist,
                                     const int32_t* ranges, float* fx,
                                     float* fy, float* fz, int ng, int L,
                                     float cutforcesq, float sigma6,
                                     float epsilon, void* stream) {
  return launch<float>(xc, yc, zc, jlist, ranges, fx, fy, fz, ng, L,
                       cutforcesq, sigma6, epsilon, stream);
}

extern "C" int lj_cluster_stream_f64(const double* xc, const double* yc,
                                     const double* zc, const int32_t* jlist,
                                     const int32_t* ranges, double* fx,
                                     double* fy, double* fz, int ng, int L,
                                     double cutforcesq, double sigma6,
                                     double epsilon, void* stream) {
  return launch<double>(xc, yc, zc, jlist, ranges, fx, fy, fz, ng, L,
                        cutforcesq, sigma6, epsilon, stream);
}
