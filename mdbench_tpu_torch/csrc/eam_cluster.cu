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
// Design: the two sweeps of lj_cluster_ilist.cu (csrc/ilist_sweep.cuh).
// One thread per i-atom; the sum in registers, deterministic, no atomics;
// the unit's listed j16 staged in shared memory in tiles (coalesced
// 16-atom loads, broadcast reads), 3 values per atom for pass 1, 4 (with
// fp) for pass 2. Per chunk of 128 staged atoms, sweep A computes every
// pair's rsq (explicitly rounded, the plain version's order) and sets a
// bit of a 128-bit register mask where 0 < rsq < cutsq; sweep B pops the
// set bits in ascending order, recomputes that pair's d and rsq with the
// same operations and runs the pair math: sqrt, t, and one (pass 1) or two
// (pass 2) degree-16 Horner chains. Each i-atom's sum therefore runs over
// the plain version's pair set in list order, and K2b/K3b equal K2/K3 bit
// for bit. The TPU's pre-gathered 48/64-wide planar rows, lane folds and
// output blocks are not needed: the kernel reads the listed rows itself.
//
// What bounds it on the card: the pair arithmetic inside the cutoff, paid
// at the warp's busiest lane. At 131k (the EAM run's final bucketed lists,
// ops/lj_cluster.ilist_sweep_counts) 5,054,118 of 57,343,488 listed pairs
// lie inside the 4.95 A cutoff (8.8%); such a pair costs a square root and
// 32 (pass 1) or 64 (pass 2) explicitly rounded Horner operations, against
// ~12 for the distance test. A branch around the pair math, per pair, was
// taken by some lane of the warp at 928,339 of 1,889,408 staged atoms
// (49%), each time at the price of the whole pair math; sweep B takes
// 443,959 warp steps at chunk 64 (efficiency 0.36, mean set bits over the
// busiest lane's) and ~344,000 at 128 (0.46). On one H100 (NVIDIA H100
// 80GB HBM3, 700.00 W; probes/ilist.py, the branch loop's kernel and the
// variants in one process), float32 K3b / K2b: the branch loop
// 0.2253-0.2260 / 0.1440-0.1444 ms; the two sweeps 0.1378-0.1380 /
// 0.1065-0.1073 at chunk 64, 0.1144-0.1151 / 0.1000-0.1032 at 128. A
// warp-wide queue of the set bits (the pair math on 32 queued pairs a
// step, each lane's sum from a buffer in list order) took 0.1417-0.1437 /
// 0.1245-0.1282: its queue and buffer cost more than the busiest lane's
// wait. Horner with fused multiply-adds was 10% faster at chunk 64 but
// moved pass 2's float32 force off the plain version's by 1.09e-5 of max
// |f| at 131k (1.41e-5 on the card test's engine lists), past the 1e-5
// the kernels are held to, so each multiply and add stays rounded on its
// own and each pair's value is bit-equal to the plain torch version's.
//
// Padding atoms sit at ~1e30 (rsq inf in float32, or 0 for two coinciding
// padding atoms) and NaN coordinates give a NaN rsq: none sets a bit, so
// none reaches the pair math (a select, never a product with a 0/1 mask).
// sqrt is the IEEE square root.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ilist_sweep.cuh"
#include "unit_map.cuh"

namespace {

using ilist_sweep::add_rn;
using ilist_sweep::kChunk;
using ilist_sweep::Mask;
using ilist_sweep::mul_rn;
using unit_map::Buckets;
using unit_map::unit_of;

constexpr int kThreads = 128;      // threads per block
constexpr int kJ16 = 16;           // atoms per j-cluster
constexpr int kSmemBytes = 24576;  // staging budget per block
constexpr int kNCoef = 17;         // degree-16 polynomials
// dynamic shared memory a launch may take without opting in (48 KB less
// the static s_nmax and some slack)
constexpr size_t kDefaultSmem = 48 * 1024 - 64;

template <typename T>
struct EamCoefs {
  T mid, iscale, cutsq;
  T dens[kNCoef];
  T g1[kNCoef];
  T g2[kNCoef];
};

__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// clip(x, -1, 1) as max then min, for finite x
template <typename T>
__device__ __forceinline__ T clip1(T x) {
  const T lo = x < T(-1) ? T(-1) : x;
  return lo > T(1) ? T(1) : lo;
}

// highest degree first, each multiply and add rounded on its own (the
// plain version's values; the header says why not fused)
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
  const int nw = __reduce_max_sync(0xffffffffu, n);  // the warp's longest list

  for (int k0 = 0; k0 < nmax; k0 += tile_j) {
    const int m = min(tile_j, n - k0) * kJ16;    // this unit's atoms in the tile
    const int mw = min(tile_j, nw - k0) * kJ16;  // the warp's most
    for (int e = ia; e < m; e += tpu) {
      const int64_t src = static_cast<int64_t>(list[k0 + e / kJ16]) * kJ16 + e % kJ16;
      sx[e] = xc[src];
      sy[e] = yc[src];
      sz[e] = zc[src];
      if constexpr (kForce) sf[e] = fp[src];
    }
    __syncthreads();
    for (int c0 = 0; c0 < mw; c0 += kChunk) {
      // sweep A: the chunk's pairs inside the cutoff, this unit's atoms only
      Mask mask = ilist_sweep::sweep_planes(sx, sy, sz, c0, xi, yi, zi, c.cutsq);
      mask.keep_below(m - c0);
      // sweep B: the pair math on the set bits, in list order
      while (mask.any()) {
        const int e = c0 + mask.pop();
        const T dx = xi - sx[e];
        const T dy = yi - sy[e];
        const T dz = zi - sz[e];
        const T rsq = ilist_sweep::rsq_rn(dx, dy, dz);
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
  const int tile_j = ilist_sweep::whole_chunks(
      kSmemBytes / (upb * kVals * kJ16 * static_cast<int>(sizeof(T))));
  const size_t smem = static_cast<size_t>(upb) * kVals * tile_j * kJ16 * sizeof(T);
  auto* kernel = eam_ilist_kernel<T, kForce>;
  if (smem > kDefaultSmem) {  // beyond the default limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n_rows + upb - 1) / upb;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
