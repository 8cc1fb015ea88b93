// The two passes of the cluster-scheme EAM force over exact unit lists,
// for Hopper (sm_90a). Replace the TPU kernels of
// mdbench_tpu/ops/pallas/eam_cluster.py launched by
// eam_cluster_force_pallas through _pass_call:
//   eam_rho_ilist    <- _kernel_eam_rho   (pass 1, K2)
//   eam_force_ilist  <- _kernel_eam_force (pass 2, K3)
//
// Contract (the same as the TPU kernels', with the list layout of
// lj_cluster_ilist.cu):
//   xc, yc, zc   (C_total, 8) coordinate planes; j16 id c covers the 16
//                atoms of rows 2c and 2c+1
//   fp           (C_total, 8) pass 2 only: fp = F'(rho) per atom, ghost
//                rows already refreshed; fp_i is row u*share*8 + ia
//   ijlist, nji  (n_units, icap) int32 j16 ids, (n_units,) int32 lengths;
//                entries past nji[u] are sentinel ids and are not read
//   coefs        host float64 [mid, iscale, cutsq, dens[17], g1[17],
//                g2[17]], copied into a by-value kernel argument rounded
//                to T, as the TPU kernels fold them in as constants
//   pass 1 writes rho_i = sum_j dens(t); pass 2 writes
//   f_i = sum_j d_ij * fpair, fpair = -((fp_i + fp_j) g1(t) + g2(t)),
//   both over every listed j atom with 0 < rsq < cutsq, where
//   t = clip((sqrt(rsq) - mid) * iscale, -1, 1) and each polynomial is
//   evaluated highest degree first (Horner). Outputs (n_units*share, 8)
//   are written, not accumulated.
//
// Bucketed form (K2b, K3b; the same passes per capacity bucket in
// mdbench_tpu/ops/pallas/eam_cluster.py, `buckets=`): the same kernels with
// lj_cluster_ilist.cu's runtime unit map (unit_map.cuh). ijlist is then
// bijlist (n_rows, icap), the lists in nji-sorted order; bcrows
// (n_rows*share,) gives each position's cluster rows (a dummy unit's lie
// past n_units*share: it reads and writes nothing); each bucket's units
// read min(nji, cap) entries, a cap-0 tier none (its rows get exactly 0).
// Each unit's rows are written straight from its position, and pass 2
// reads fp_i from the unit's own rows of fp: no permuted i-planes, no
// fp_plane[bcrows] and no inverse gather, which on the TPU served the
// BlockSpec's contiguous blocks. One launch per pass covers every bucket.
// Each unit's sum runs in list order, so K2b and K3b equal K2 and K3 bit
// for bit on the same lists.
//
// Design: K1's (lj_cluster_ilist.cu). One thread per i-atom; the sum in
// registers in list order, deterministic, no atomics; the unit's listed
// j16 staged in shared memory in tiles (coalesced 16-atom loads,
// broadcast reads), 3 values per atom for pass 1, 4 (with fp) for pass 2.
// The TPU's pre-gathered 48/64-wide planar rows, lane folds and output
// blocks are not needed: the kernel reads the listed rows itself.
//
// What bounds it on the card: the pair arithmetic. A pair inside the
// cutoff costs a square root and one (pass 1) or two (pass 2) degree-16
// Horner chains, ~40-70 flops, against 12-16 bytes of staged data that
// share*8 threads reuse. Horner runs on explicitly rounded multiplies and
// adds (no fused multiply-add), so each pair's value is bit-equal to the
// plain torch version's; letting the compiler fuse them is the first
// speed step once a tolerance for it is argued.
//
// Padding atoms sit at ~1e30 (rsq inf in float32, or 0 for two
// coinciding padding atoms): the cutoff test SELECTS (a branch around the
// pair math). rsq is formed with explicitly rounded operations in the
// plain version's order, so the pair set is the plain version's; sqrt is
// the IEEE square root.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unit_map.cuh"

namespace {

using unit_map::Buckets;
using unit_map::unit_of;

constexpr int kThreads = 128;      // threads per block
constexpr int kJ16 = 16;           // atoms per j-cluster
constexpr int kSmemBytes = 24576;  // staging budget per block
constexpr int kNCoef = 17;         // degree-16 polynomials

template <typename T>
struct EamCoefs {
  T mid, iscale, cutsq;
  T dens[kNCoef];
  T g1[kNCoef];
  T g2[kNCoef];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// clip(x, -1, 1) as max then min, for finite x
template <typename T>
__device__ __forceinline__ T clip1(T x) {
  const T lo = x < T(-1) ? T(-1) : x;
  return lo > T(1) ? T(1) : lo;
}

template <typename T>
__device__ __forceinline__ T horner(const T (&c)[kNCoef], T t) {
  T acc = c[kNCoef - 1];
#pragma unroll
  for (int k = kNCoef - 2; k >= 0; --k) acc = add_rn(mul_rn(acc, t), c[k]);
  return acc;
}

template <typename T, bool kForce>
__global__ void __launch_bounds__(kThreads)
eam_ilist_kernel(const T* __restrict__ xc, const T* __restrict__ yc,
                 const T* __restrict__ zc, const T* __restrict__ fp,
                 const int32_t* __restrict__ ijlist,
                 const int32_t* __restrict__ nji,
                 const int32_t* __restrict__ bcrows, T* __restrict__ out0,
                 T* __restrict__ out1, T* __restrict__ out2, int n_rows,
                 int n_units, int icap, int share, int tile_j,
                 const Buckets bk, const EamCoefs<T> c) {
  constexpr int kVals = kForce ? 4 : 3;  // staged values per j atom
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_nmax;
  const int tpu = share * 8;           // threads (= i-atoms) per unit
  const int upb = kThreads / tpu;      // units per block
  const int lu = threadIdx.x / tpu;    // unit within the block
  const int ia = threadIdx.x % tpu;    // i-atom within the unit
  const int s = blockIdx.x * upb + lu; // the unit's list row
  int cap;
  const int u = unit_of(s, n_rows, n_units, share, icap, bcrows, bk, cap);
  const bool active = u >= 0;
  const int tile_atoms = tile_j * kJ16;
  T* sx = reinterpret_cast<T*>(smem_raw) + lu * kVals * tile_atoms;
  T* sy = sx + tile_atoms;
  T* sz = sy + tile_atoms;
  T* sf = sz + tile_atoms;  // pass 2 only

  int n = 0;
  if (active) n = min(max(nji[u], 0), cap);
  if (threadIdx.x == 0) s_nmax = 0;
  __syncthreads();
  if (active && ia == 0) atomicMax(&s_nmax, n);
  __syncthreads();
  const int nmax = s_nmax;

  const int64_t row = static_cast<int64_t>(u) * tpu + ia;
  T xi = T(0), yi = T(0), zi = T(0), fpi = T(0);
  if (active) {
    xi = xc[row];
    yi = yc[row];
    zi = zc[row];
    if constexpr (kForce) fpi = fp[row];
  }
  const int32_t* list = ijlist + static_cast<int64_t>(active ? s : 0) * icap;
  T a0 = T(0), a1 = T(0), a2 = T(0);

  for (int k0 = 0; k0 < nmax; k0 += tile_j) {
    const int m = min(tile_j, n - k0) * kJ16;  // this unit's atoms in the tile
    for (int e = ia; e < m; e += tpu) {
      const int64_t src = static_cast<int64_t>(list[k0 + e / kJ16]) * kJ16 + e % kJ16;
      sx[e] = xc[src];
      sy[e] = yc[src];
      sz[e] = zc[src];
      if constexpr (kForce) sf[e] = fp[src];
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
      const T dx = xi - sx[e];
      const T dy = yi - sy[e];
      const T dz = zi - sz[e];
      const T rsq = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
      if (rsq < c.cutsq && rsq > T(0)) {
        const T t = clip1(mul_rn(sqrt_rn(rsq) - c.mid, c.iscale));
        if constexpr (kForce) {
          const T fpair =
              -add_rn(mul_rn(add_rn(fpi, sf[e]), horner(c.g1, t)), horner(c.g2, t));
          a0 += dx * fpair;
          a1 += dy * fpair;
          a2 += dz * fpair;
        } else {
          a0 += horner(c.dens, t);
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    out0[row] = a0;
    if constexpr (kForce) {
      out1[row] = a1;
      out2[row] = a2;
    }
  }
}

template <typename T, bool kForce>
int launch(const T* xc, const T* yc, const T* zc, const T* fp,
           const int32_t* ijlist, const int32_t* nji, const int32_t* bcrows,
           T* out0, T* out1, T* out2, int n_rows, int n_units, int icap,
           int share, const Buckets& bk, const double* coefs, void* stream) {
  if (share != 1 && share != 2 && share != 4) return cudaErrorInvalidValue;
  if (n_rows <= 0 || n_units <= 0 || icap <= 0 || coefs == nullptr)
    return cudaErrorInvalidValue;
  EamCoefs<T> c;
  c.mid = static_cast<T>(coefs[0]);
  c.iscale = static_cast<T>(coefs[1]);
  c.cutsq = static_cast<T>(coefs[2]);
  for (int k = 0; k < kNCoef; ++k) {
    c.dens[k] = static_cast<T>(coefs[3 + k]);
    c.g1[k] = static_cast<T>(coefs[3 + kNCoef + k]);
    c.g2[k] = static_cast<T>(coefs[3 + 2 * kNCoef + k]);
  }
  constexpr int kVals = kForce ? 4 : 3;
  const int upb = kThreads / (share * 8);
  int tile_j = kSmemBytes / (upb * kVals * kJ16 * static_cast<int>(sizeof(T)));
  if (tile_j < 1) tile_j = 1;
  const size_t smem = static_cast<size_t>(upb) * kVals * tile_j * kJ16 * sizeof(T);
  const int blocks = (n_rows + upb - 1) / upb;
  eam_ilist_kernel<T, kForce><<<blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      xc, yc, zc, fp, ijlist, nji, bcrows, out0, out1, out2, n_rows, n_units,
      icap, share, tile_j, bk, c);
  return static_cast<int>(cudaGetLastError());
}

// the flat forms: list row u is unit u
template <typename T, bool kForce>
int launch_flat(const T* xc, const T* yc, const T* zc, const T* fp,
                const int32_t* ijlist, const int32_t* nji, T* out0, T* out1,
                T* out2, int n_units, int icap, int share, const double* coefs,
                void* stream) {
  const Buckets flat{};  // n = 0: no map
  return launch<T, kForce>(xc, yc, zc, fp, ijlist, nji, nullptr, out0, out1,
                           out2, n_units, n_units, icap, share, flat, coefs,
                           stream);
}

// the bucketed forms: nbuckets position ranges ending at ends[k]
// (ends[nbuckets-1] == n_rows) with caps caps[k], both host arrays
template <typename T, bool kForce>
int launch_buckets(const T* xc, const T* yc, const T* zc, const T* fp,
                   const int32_t* bijlist, const int32_t* bcrows,
                   const int32_t* nji, T* out0, T* out1, T* out2, int n_rows,
                   int icap, int n_units, int share, int nbuckets,
                   const int* ends, const int* caps, const double* coefs,
                   void* stream) {
  Buckets bk{};
  if (bcrows == nullptr || !unit_map::make_buckets(nbuckets, ends, caps, n_rows, bk))
    return cudaErrorInvalidValue;
  return launch<T, kForce>(xc, yc, zc, fp, bijlist, nji, bcrows, out0, out1,
                           out2, n_rows, n_units, icap, share, bk, coefs, stream);
}

}  // namespace

extern "C" int eam_rho_ilist_f32(const float* xc, const float* yc,
                                 const float* zc, const int32_t* ijlist,
                                 const int32_t* nji, float* rho, int n_units,
                                 int icap, int share, const double* coefs,
                                 void* stream) {
  return launch_flat<float, false>(xc, yc, zc, nullptr, ijlist, nji, rho, nullptr,
                              nullptr, n_units, icap, share, coefs, stream);
}

extern "C" int eam_rho_ilist_f64(const double* xc, const double* yc,
                                 const double* zc, const int32_t* ijlist,
                                 const int32_t* nji, double* rho, int n_units,
                                 int icap, int share, const double* coefs,
                                 void* stream) {
  return launch_flat<double, false>(xc, yc, zc, nullptr, ijlist, nji, rho, nullptr,
                               nullptr, n_units, icap, share, coefs, stream);
}

extern "C" int eam_force_ilist_f32(const float* xc, const float* yc,
                                   const float* zc, const float* fp,
                                   const int32_t* ijlist, const int32_t* nji,
                                   float* fx, float* fy, float* fz,
                                   int n_units, int icap, int share,
                                   const double* coefs, void* stream) {
  return launch_flat<float, true>(xc, yc, zc, fp, ijlist, nji, fx, fy, fz, n_units,
                             icap, share, coefs, stream);
}

extern "C" int eam_force_ilist_f64(const double* xc, const double* yc,
                                   const double* zc, const double* fp,
                                   const int32_t* ijlist, const int32_t* nji,
                                   double* fx, double* fy, double* fz,
                                   int n_units, int icap, int share,
                                   const double* coefs, void* stream) {
  return launch_flat<double, true>(xc, yc, zc, fp, ijlist, nji, fx, fy, fz, n_units,
                              icap, share, coefs, stream);
}

// the bucketed passes (K2b, K3b): (xc, yc, zc, [fp,] bijlist, bcrows, nji,
// outputs, n_rows, icap, n_units, share, nbuckets, ends, caps, coefs,
// stream); outputs are (n_units*share, 8)
extern "C" int eam_rho_buckets_f32(const float* xc, const float* yc, const float* zc,
                                   const int32_t* bijlist, const int32_t* bcrows,
                                   const int32_t* nji, float* rho, int n_rows,
                                   int icap, int n_units, int share, int nbuckets,
                                   const int* ends, const int* caps,
                                   const double* coefs, void* stream) {
  return launch_buckets<float, false>(xc, yc, zc, nullptr, bijlist, bcrows, nji,
                                      rho, nullptr, nullptr, n_rows, icap, n_units,
                                      share, nbuckets, ends, caps, coefs, stream);
}

extern "C" int eam_rho_buckets_f64(const double* xc, const double* yc,
                                   const double* zc, const int32_t* bijlist,
                                   const int32_t* bcrows, const int32_t* nji,
                                   double* rho, int n_rows, int icap, int n_units,
                                   int share, int nbuckets, const int* ends,
                                   const int* caps, const double* coefs,
                                   void* stream) {
  return launch_buckets<double, false>(xc, yc, zc, nullptr, bijlist, bcrows, nji,
                                       rho, nullptr, nullptr, n_rows, icap, n_units,
                                       share, nbuckets, ends, caps, coefs, stream);
}

extern "C" int eam_force_buckets_f32(const float* xc, const float* yc,
                                     const float* zc, const float* fp,
                                     const int32_t* bijlist, const int32_t* bcrows,
                                     const int32_t* nji, float* fx, float* fy,
                                     float* fz, int n_rows, int icap, int n_units,
                                     int share, int nbuckets, const int* ends,
                                     const int* caps, const double* coefs,
                                     void* stream) {
  return launch_buckets<float, true>(xc, yc, zc, fp, bijlist, bcrows, nji, fx, fy,
                                     fz, n_rows, icap, n_units, share, nbuckets,
                                     ends, caps, coefs, stream);
}

extern "C" int eam_force_buckets_f64(const double* xc, const double* yc,
                                     const double* zc, const double* fp,
                                     const int32_t* bijlist, const int32_t* bcrows,
                                     const int32_t* nji, double* fx, double* fy,
                                     double* fz, int n_rows, int icap, int n_units,
                                     int share, int nbuckets, const int* ends,
                                     const int* caps, const double* coefs,
                                     void* stream) {
  return launch_buckets<double, true>(xc, yc, zc, fp, bijlist, bcrows, nji, fx, fy,
                                      fz, n_rows, icap, n_units, share, nbuckets,
                                      ends, caps, coefs, stream);
}
