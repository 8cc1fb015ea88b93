// Exact-list Lennard-Jones force for the cluster-pair scheme, for Hopper
// (sm_90a). Replaces mdbench_tpu/ops/pallas/lj_cluster.py::_kernel_ilist
// (the TPU kernel launched by lj_cluster_force_ilist_pallas).
//
// Contract (the same as the TPU kernel's, untyped):
//   xc, yc, zc   (C_total, 8) coordinate planes; j16 id c covers the 16
//                atoms of rows 2c and 2c+1, i.e. flat atoms 16c .. 16c+15
//   ijlist       (n_units, icap) int32 j16 ids; unit u's i-atoms are
//                cluster rows u*share .. u*share+share-1 (flat atoms
//                u*share*8 .. (u+1)*share*8-1)
//   nji          (n_units,) int32; entries past nji[u] are sentinel ids,
//                which contribute exactly 0, so the kernel stops there
//   fx, fy, fz   (n_units*share, 8), written (not accumulated):
//                f_i = sum_j d_ij * 48 eps sr6 (sr6 - 1/2) sr2 over every
//                listed j atom with 0 < rsq < cutforcesq
//
// Design. One thread per i-atom; the sum stays in registers and runs in
// list order, so the result is deterministic and needs no atomics. A
// block of 128 threads holds 128/(8*share) units. The block walks its
// units' lists in tiles: each unit's threads stage tile_j listed j16
// (16 atoms x 3 coordinates each) into shared memory with coalesced
// 16-atom loads, then every thread of the unit reads them back as
// broadcasts. Only the coordinates of listed j16 are read, once per unit
// per step: no pre-gathered planes as on the TPU.
//
// What bounds it on the card: the pair arithmetic (one divide and ~20
// flops per pair, over icap*16 pairs per i-atom), not memory — each
// staged coordinate is reused by share*8 threads. The list length
// varies per unit, so the tile loop runs to the block's longest list
// and units with shorter lists idle for the rest; packing units of
// similar length into one block (the TPU path's capacity buckets) is
// the next step for speed.
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

constexpr int kThreads = 128;      // threads per block
constexpr int kJ16 = 16;           // atoms per j-cluster
constexpr int kSmemBytes = 24576;  // staging budget per block

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lj_cluster_ilist_kernel(const T* __restrict__ xc, const T* __restrict__ yc,
                        const T* __restrict__ zc,
                        const int32_t* __restrict__ ijlist,
                        const int32_t* __restrict__ nji,
                        T* __restrict__ fx, T* __restrict__ fy,
                        T* __restrict__ fz, int n_units, int icap, int share,
                        int tile_j, T cutforcesq, T sigma6, T epsilon) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_nmax;
  const int tpu = share * 8;           // threads (= i-atoms) per unit
  const int upb = kThreads / tpu;      // units per block
  const int lu = threadIdx.x / tpu;    // unit within the block
  const int ia = threadIdx.x % tpu;    // i-atom within the unit
  const int u = blockIdx.x * upb + lu;
  const bool active = u < n_units;
  const int tile_atoms = tile_j * kJ16;
  T* sx = reinterpret_cast<T*>(smem_raw) + lu * 3 * tile_atoms;
  T* sy = sx + tile_atoms;
  T* sz = sy + tile_atoms;

  int n = 0;
  if (active) n = min(max(nji[u], 0), icap);
  if (threadIdx.x == 0) s_nmax = 0;
  __syncthreads();
  if (active && ia == 0) atomicMax(&s_nmax, n);
  __syncthreads();
  const int nmax = s_nmax;

  const int64_t row = static_cast<int64_t>(u) * tpu + ia;
  T xi = T(0), yi = T(0), zi = T(0);
  if (active) {
    xi = xc[row];
    yi = yc[row];
    zi = zc[row];
  }
  const int32_t* list = ijlist + static_cast<int64_t>(active ? u : 0) * icap;
  T ax = T(0), ay = T(0), az = T(0);

  for (int k0 = 0; k0 < nmax; k0 += tile_j) {
    const int m = min(tile_j, n - k0) * kJ16;  // this unit's atoms in the tile
    for (int e = ia; e < m; e += tpu) {
      const int64_t src = static_cast<int64_t>(list[k0 + e / kJ16]) * kJ16 + e % kJ16;
      sx[e] = xc[src];
      sy[e] = yc[src];
      sz[e] = zc[src];
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
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
    __syncthreads();
  }
  if (active) {
    fx[row] = ax;
    fy[row] = ay;
    fz[row] = az;
  }
}

template <typename T>
int launch(const T* xc, const T* yc, const T* zc, const int32_t* ijlist,
           const int32_t* nji, T* fx, T* fy, T* fz, int n_units, int icap,
           int share, T cutforcesq, T sigma6, T epsilon, void* stream) {
  if (share != 1 && share != 2 && share != 4) return cudaErrorInvalidValue;
  if (n_units <= 0 || icap <= 0) return cudaErrorInvalidValue;
  const int upb = kThreads / (share * 8);
  int tile_j = kSmemBytes / (upb * 3 * kJ16 * static_cast<int>(sizeof(T)));
  if (tile_j < 1) tile_j = 1;
  const size_t smem = static_cast<size_t>(upb) * 3 * tile_j * kJ16 * sizeof(T);
  const int blocks = (n_units + upb - 1) / upb;
  lj_cluster_ilist_kernel<T><<<blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      xc, yc, zc, ijlist, nji, fx, fy, fz, n_units, icap, share, tile_j,
      cutforcesq, sigma6, epsilon);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lj_cluster_ilist_f32(const float* xc, const float* yc,
                                    const float* zc, const int32_t* ijlist,
                                    const int32_t* nji, float* fx, float* fy,
                                    float* fz, int n_units, int icap,
                                    int share, float cutforcesq, float sigma6,
                                    float epsilon, void* stream) {
  return launch<float>(xc, yc, zc, ijlist, nji, fx, fy, fz, n_units, icap,
                       share, cutforcesq, sigma6, epsilon, stream);
}

extern "C" int lj_cluster_ilist_f64(const double* xc, const double* yc,
                                    const double* zc, const int32_t* ijlist,
                                    const int32_t* nji, double* fx, double* fy,
                                    double* fz, int n_units, int icap,
                                    int share, double cutforcesq,
                                    double sigma6, double epsilon,
                                    void* stream) {
  return launch<double>(xc, yc, zc, ijlist, nji, fx, fy, fz, n_units, icap,
                        share, cutforcesq, sigma6, epsilon, stream);
}
