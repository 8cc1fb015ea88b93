// The two passes of the verlet-scheme EAM force over per-atom neighbour
// lists, for Hopper (sm_90a). mdbench_tpu computes this force in XLA, not
// in a Pallas kernel: these replace the fused loops XLA makes of
//   eam_rho_nlist    <- mdbench_tpu/ops/eam.py compute_force_eam (:79-130)
//                       and compute_force_eam_poly (:166-212): pass 1, K5
//   eam_force_nlist  <- the same functions' pass 2 (:142-153, :222-234), K6
//
// Contract:
//   x            (nrows, 3) coordinates; rows [0, nlocal_pad) are the local
//                atoms, the rest ghosts and the sentinel row
//   neighbors    (nlocal_pad, k) int64 row ids; numneigh (nlocal_pad,)
//                int64. Atom i's pairs are its first min(numneigh[i], k)
//                entries with rsq < cutsq; entries past them are not read.
//                There is no rsq > 0 test (the list never holds i itself).
//   spline form  rhor, z2r (nr+1, 7) spline rows (row 0 unused)
//   poly form    dens, g1, g2: degree-16 polynomials in
//                t = clip((r - mid) * iscale, -1, 1)
//   both         frho (nrho+1, 7); scalars, host float64
//                [mid, iscale, cutsq, dens[17], g1[17], g2[17], rdr, rdrho],
//                copied into a by-value kernel argument rounded to T (the
//                spline form ignores the polynomials)
//   K5 writes fp (nrows,): fp_i = F'(rho_i) from the frho spline for the
//   local rows, with rho_i = sum_j dens(r_ij) (the rhor spline's value, or
//   the dens polynomial), and 0 for every other row; with rho non-null
//   also rho (nlocal_pad,).
//   K6 writes f (nlocal_pad, 3), f_i = sum_j d_ij * fpair with
//     spline: recip = 1/r; phi = z2*recip; phip = z2p*recip - phi*recip;
//             psip = fp_i*rhoip + fp_j*rhoip + phip; fpair = -psip*recip
//     poly:   fpair = -((fp_i + fp_j)*g1(t) + g2(t)),
//   fp_i from fp_local (nlocal_pad,), fp_j from fp (nrows,), whose ghost
//   rows the caller has filled between the passes. Outputs are written,
//   not accumulated.
//
// Every spline lookup is the plain version's _grid_index: p = v*rd + 1,
// m = clamp(int(floor(p)), 1, n-1), frac = min(p - m, 1). Every multiply,
// add and subtract is rounded on its own (no fused multiply-add, as in
// eam_cluster.cu, whose header says why), in the plain version's order;
// sqrt and 1/r are the IEEE ones. One warp takes one local atom; lane l
// keeps its entries l, l + 32, ... and sums their terms in list order, and
// a fixed shuffle tree adds the 32 lane sums: no atomics, two launches
// give the same bits, and they are the plain version's, since torch's row
// sum on the card adds a row of fewer than 128 entries in the same order.
// A pair outside the cutoff, a sentinel neighbour (rsq inf in float32)
// and a NaN row (rsq NaN) fail the rsq < cutsq test and are skipped by a
// branch, never multiplied by a 0/1 mask, so a row without a pair inside
// gets rho and force exactly 0. Pass 2 recomputes d and r from x rather
// than keeping (N, K) planes across the ghost-fp refresh.
//
// What bounds them. By bytes, the listed int64 entries: on the 131k SP
// EAM run's final lists (K = 88; 8,031,065 listed pairs, 5,054,118 inside
// the cutoff) a pass reads 64 MB of them beside 1.6 MB of x and 1 MB of
// numneigh, 0.021 ms at 3.35 TB/s. By instruction issue, the unfused
// arithmetic: ~36M warp instructions a K6 pass (two degree-16 Horner
// chains, 64 instructions, on each inside pair, run by the whole warp
// while 52% of its lane slots hold one), ~39 us at 4 an SM cycle.
//
// Design. K5 in float32: each lane first loads the list entries of two
// of its rounds, then the x rows they name, then does their arithmetic,
// so that a warp has its list and gather loads in flight together rather
// than one round's chain (entry, then row, then math) after the other,
// at 32 registers: all 64 warps an SM. K6, and K5 in float64, keep one
// round at a time: K6 is bound by issue, and every way of putting more
// loads in flight that was tried cost it warps or instructions. x rows
// and fp_j by 32-bit index arithmetic. On one H100 (NVIDIA H100 80GB
// HBM3, 700.00 W; probes/eam_verlet.py, in turns with the one-round
// kernels that preceded these, on the 131k lists) float32 poly K5 takes
// 0.047 ms on the device against 0.060 (44% of the bytes' bound), K6
// 0.056 against 0.057 (37%); the list stream runs at 1.4 and 1.1 TB/s.
// Lists of int32 ids would halve the bytes that bound them. Measured
// and left out (PERF.md): a persistent grid whose blocks bring the list
// rows of tiles of atoms into a ring of shared-memory stages by 1-D bulk
// copies (TMA) for consumer warps (the ring's copies alone stream ~2
// TB/s, and its bookkeeping costs registers or L1 locality), per-warp
// rings, and K6 computing fpair densely over the inside pairs of two
// atoms in shared memory (the same bits, 44% slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ilist_sweep.cuh"

namespace {

using ilist_sweep::add_rn;
using ilist_sweep::mul_rn;
using ilist_sweep::rsq_rn;

constexpr int kThreads = 256;          // threads per block
constexpr int kWarps = kThreads / 32;  // local atoms per block
constexpr int kNCoef = 17;             // degree-16 polynomials
constexpr int kRow = 7;                // spline coefficients a row
constexpr int kScalars = 3 + 3 * kNCoef + 2;

// the blocks of a pass an SM holds at least, which caps a thread's
// registers: 8 blocks, 32 registers (all 64 warps an SM); 5 blocks, 48
// registers, for the float64 K6, which spills below that
template <typename T, bool kForce>
constexpr int kMinBlocks = sizeof(T) == 8 && kForce ? 5 : 8;
// K5: the rounds of list entries a lane loads (and then their x rows)
// before their arithmetic, two in float32
template <typename T>
constexpr int kRhoRounds = sizeof(T) == 4 ? 2 : 1;

template <typename T>
struct Scalars {
  T mid, iscale, cutsq, rdr, rdrho;
  T dens[kNCoef];
  T g1[kNCoef];
  T g2[kNCoef];
  int nr, nrho;
};

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ double floor_t(double a) { return floor(a); }

// clip(x, -1, 1) as max then min
template <typename T>
__device__ __forceinline__ T clip1(T x) {
  const T lo = x < T(-1) ? T(-1) : x;
  return lo > T(1) ? T(1) : lo;
}

// highest degree first, each multiply and add rounded on its own
template <typename T>
__device__ __forceinline__ T horner(const T (&c)[kNCoef], T t) {
  T acc = c[kNCoef - 1];
#pragma unroll
  for (int k = kNCoef - 2; k >= 0; --k) acc = add_rn(mul_rn(acc, t), c[k]);
  return acc;
}

// (c0*p + c1)*p + c2 and ((c0*p + c1)*p + c2)*p + c3 of a spline row
template <typename T>
__device__ __forceinline__ T quadratic(const T* c, T p) {
  return add_rn(mul_rn(add_rn(mul_rn(__ldg(c), p), __ldg(c + 1)), p), __ldg(c + 2));
}
template <typename T>
__device__ __forceinline__ T cubic(const T* c, T p) {
  return add_rn(mul_rn(quadratic(c, p), p), __ldg(c + 3));
}

// the plain version's _grid_index: the row m and the fraction of v
template <typename T>
__device__ __forceinline__ int grid_index(T v, T rd, int n, T& frac) {
  const T p = add_rn(mul_rn(v, rd), T(1));
  const int m = min(max(static_cast<int>(floor_t(p)), 1), n - 1);
  const T d = sub_rn(p, static_cast<T>(m));
  frac = d > T(1) ? T(1) : d;  // min(d, 1); a NaN stays NaN
  return m;
}

// the fixed shuffle tree: every lane ends with the same sum
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// row j of x (a row id is below nrows, an int: 32-bit index arithmetic)
template <typename T>
__device__ __forceinline__ void load_row(const T* x, int64_t j, T& a, T& b, T& c) {
  const T* p = x + 3 * static_cast<uint64_t>(static_cast<uint32_t>(j));
  a = p[0];
  b = p[1];
  c = p[2];
}

// the pairs of local atom i: min(numneigh[i], k)
__device__ __forceinline__ int list_length(const int64_t* numneigh, int i, int k) {
  const int64_t nn = numneigh[i];
  return nn < 0 ? 0 : (nn > k ? k : static_cast<int>(nn));
}

// A lane's batch of its entries q0, q0 + 32, ... (kR of them, those below
// n): first every entry, then every x row they name, so that the loads
// of a batch are in flight together; their arithmetic follows in list
// order.
template <int kR, typename T>
struct Batch {
  int64_t j[kR];
  T xj[kR], yj[kR], zj[kR];

  __device__ __forceinline__ void load(const T* x, const int64_t* list, int q0, int n) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (q0 + 32 * r < n) j[r] = list[q0 + 32 * r];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (q0 + 32 * r < n) load_row(x, j[r], xj[r], yj[r], zj[r]);
  }
};

template <typename T, bool kPoly>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, false>))
eam_rho_nlist_kernel(const T* __restrict__ x, const int64_t* __restrict__ neighbors,
                     const int64_t* __restrict__ numneigh, const T* __restrict__ rhor,
                     const T* __restrict__ frho, T* __restrict__ fp,
                     T* __restrict__ rho, int nrows, int nlocal_pad, int k,
                     const Scalars<T> s) {
  constexpr int kR = kRhoRounds<T>;
  // the rows past the local ones: fp 0 (the caller fills the ghosts)
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = nlocal_pad + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < nrows; g += stride)
    fp[g] = T(0);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= nlocal_pad) return;  // the whole warp: i is the warp's
  T xi, yi, zi;
  load_row(x, i, xi, yi, zi);
  const int n = list_length(numneigh, i, k);
  const int64_t* list = neighbors + static_cast<int64_t>(i) * k;
  T acc = T(0);
  for (int q0 = lane; q0 < n; q0 += 32 * kR) {
    Batch<kR, T> b;
    b.load(x, list, q0, n);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (q0 + 32 * r >= n) break;
      const T dx = xi - b.xj[r], dy = yi - b.yj[r], dz = zi - b.zj[r];
      const T rsq = rsq_rn(dx, dy, dz);
      if (rsq < s.cutsq) {
        const T rr = sqrt_rn(rsq);
        T dens;
        if constexpr (kPoly) {
          dens = horner(s.dens, clip1(mul_rn(sub_rn(rr, s.mid), s.iscale)));
        } else {
          T p;
          const int m = grid_index(rr, s.rdr, s.nr, p);
          dens = cubic(rhor + static_cast<int64_t>(m) * kRow + 3, p);
        }
        acc = add_rn(acc, dens);
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    if (rho != nullptr) rho[i] = acc;
    T pf;
    const int mf = grid_index(acc, s.rdrho, s.nrho, pf);
    fp[i] = quadratic(frho + static_cast<int64_t>(mf) * kRow, pf);
  }
}

template <typename T, bool kPoly>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, true>))
eam_force_nlist_kernel(const T* __restrict__ x, const int64_t* __restrict__ neighbors,
                       const int64_t* __restrict__ numneigh, const T* __restrict__ rhor,
                       const T* __restrict__ z2r, const T* __restrict__ fp_local,
                       const T* __restrict__ fp, T* __restrict__ f, int nlocal_pad,
                       int k, const Scalars<T> s) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= nlocal_pad) return;
  T xi, yi, zi;
  load_row(x, i, xi, yi, zi);
  const T fpi = fp_local[i];
  const int n = list_length(numneigh, i, k);
  const int64_t* list = neighbors + static_cast<int64_t>(i) * k;
  T ax = T(0), ay = T(0), az = T(0);
  for (int q = lane; q < n; q += 32) {
    const int64_t j = list[q];
    T xj, yj, zj;
    load_row(x, j, xj, yj, zj);
    const T dx = xi - xj, dy = yi - yj, dz = zi - zj;
    const T rsq = rsq_rn(dx, dy, dz);
    if (rsq < s.cutsq) {
      const T r = sqrt_rn(rsq);
      const T fpj = fp[static_cast<uint32_t>(j)];
      T fpair;
      if constexpr (kPoly) {
        const T t = clip1(mul_rn(sub_rn(r, s.mid), s.iscale));
        fpair = -add_rn(mul_rn(add_rn(fpi, fpj), horner(s.g1, t)), horner(s.g2, t));
      } else {
        T p;
        const int64_t m = grid_index(r, s.rdr, s.nr, p);
        const T* rs = rhor + m * kRow;
        const T* zs = z2r + m * kRow;
        const T rhoip = quadratic(rs, p);
        const T z2p = quadratic(zs, p);
        const T z2 = cubic(zs + 3, p);
        const T recip = rcp_rn(r);
        const T phi = mul_rn(z2, recip);
        const T phip = sub_rn(mul_rn(z2p, recip), mul_rn(phi, recip));
        const T psip = add_rn(add_rn(mul_rn(fpi, rhoip), mul_rn(fpj, rhoip)), phip);
        fpair = mul_rn(-psip, recip);
      }
      ax = add_rn(ax, mul_rn(dx, fpair));
      ay = add_rn(ay, mul_rn(dy, fpair));
      az = add_rn(az, mul_rn(dz, fpair));
    }
  }
  ax = warp_sum(ax);
  ay = warp_sum(ay);
  az = warp_sum(az);
  if (lane < 3) f[3 * static_cast<int64_t>(i) + lane] = lane == 0 ? ax : (lane == 1 ? ay : az);
}

// the scalar block, rounded to T; false if a size is out of range
template <typename T>
bool make_scalars(const double* sc, int nr, int nrho, bool poly, Scalars<T>& s) {
  if (sc == nullptr || nrho < 2 || (!poly && nr < 2)) return false;
  s.mid = static_cast<T>(sc[0]);
  s.iscale = static_cast<T>(sc[1]);
  s.cutsq = static_cast<T>(sc[2]);
  for (int k = 0; k < kNCoef; ++k) {
    s.dens[k] = static_cast<T>(sc[3 + k]);
    s.g1[k] = static_cast<T>(sc[3 + kNCoef + k]);
    s.g2[k] = static_cast<T>(sc[3 + 2 * kNCoef + k]);
  }
  s.rdr = static_cast<T>(sc[kScalars - 2]);
  s.rdrho = static_cast<T>(sc[kScalars - 1]);
  s.nr = nr;
  s.nrho = nrho;
  return true;
}

bool sizes_ok(int nrows, int nlocal_pad, int k) {
  return nrows > 0 && nlocal_pad >= 0 && nlocal_pad <= nrows && k >= 0;
}

template <typename T>
int launch_rho(const T* x, const int64_t* neighbors, const int64_t* numneigh,
               const T* rhor, const T* frho, T* fp, T* rho, int nrows, int nlocal_pad,
               int k, int nr, int nrho, int poly, const double* scalars, void* stream) {
  Scalars<T> s;
  if (!sizes_ok(nrows, nlocal_pad, k) || frho == nullptr || (!poly && rhor == nullptr) ||
      !make_scalars(scalars, nr, nrho, poly != 0, s))
    return cudaErrorInvalidValue;
  // one block at least: it zeroes the rows past the local ones
  const int blocks = nlocal_pad > 0 ? (nlocal_pad + kWarps - 1) / kWarps : 1;
  auto* kernel = poly ? &eam_rho_nlist_kernel<T, true> : &eam_rho_nlist_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, neighbors, numneigh, rhor, frho, fp, rho, nrows, nlocal_pad, k, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_force(const T* x, const int64_t* neighbors, const int64_t* numneigh,
                 const T* rhor, const T* z2r, const T* fp_local, const T* fp, T* f,
                 int nrows, int nlocal_pad, int k, int nr, int nrho, int poly,
                 const double* scalars, void* stream) {
  Scalars<T> s;
  if (!sizes_ok(nrows, nlocal_pad, k) || (!poly && (rhor == nullptr || z2r == nullptr)) ||
      !make_scalars(scalars, nr, nrho, poly != 0, s))
    return cudaErrorInvalidValue;
  if (nlocal_pad == 0) return cudaSuccess;
  const int blocks = (nlocal_pad + kWarps - 1) / kWarps;
  auto* kernel = poly ? &eam_force_nlist_kernel<T, true> : &eam_force_nlist_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, neighbors, numneigh, rhor, z2r, fp_local, fp, f, nlocal_pad, k, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pass 1 (K5): (x, neighbors, numneigh, rhor, frho, fp, rho, nrows,
// nlocal_pad, k, nr, nrho, poly, scalars, stream); rho may be null, and
// rhor with poly != 0
extern "C" int eam_rho_nlist_f32(const float* x, const int64_t* neighbors,
                                 const int64_t* numneigh, const float* rhor,
                                 const float* frho, float* fp, float* rho, int nrows,
                                 int nlocal_pad, int k, int nr, int nrho, int poly,
                                 const double* scalars, void* stream) {
  return launch_rho<float>(x, neighbors, numneigh, rhor, frho, fp, rho, nrows,
                           nlocal_pad, k, nr, nrho, poly, scalars, stream);
}

extern "C" int eam_rho_nlist_f64(const double* x, const int64_t* neighbors,
                                 const int64_t* numneigh, const double* rhor,
                                 const double* frho, double* fp, double* rho, int nrows,
                                 int nlocal_pad, int k, int nr, int nrho, int poly,
                                 const double* scalars, void* stream) {
  return launch_rho<double>(x, neighbors, numneigh, rhor, frho, fp, rho, nrows,
                            nlocal_pad, k, nr, nrho, poly, scalars, stream);
}

// pass 2 (K6): (x, neighbors, numneigh, rhor, z2r, fp_local, fp, f, nrows,
// nlocal_pad, k, nr, nrho, poly, scalars, stream); rhor and z2r may be null
// with poly != 0
extern "C" int eam_force_nlist_f32(const float* x, const int64_t* neighbors,
                                   const int64_t* numneigh, const float* rhor,
                                   const float* z2r, const float* fp_local,
                                   const float* fp, float* f, int nrows, int nlocal_pad,
                                   int k, int nr, int nrho, int poly,
                                   const double* scalars, void* stream) {
  return launch_force<float>(x, neighbors, numneigh, rhor, z2r, fp_local, fp, f, nrows,
                             nlocal_pad, k, nr, nrho, poly, scalars, stream);
}

extern "C" int eam_force_nlist_f64(const double* x, const int64_t* neighbors,
                                   const int64_t* numneigh, const double* rhor,
                                   const double* z2r, const double* fp_local,
                                   const double* fp, double* f, int nrows, int nlocal_pad,
                                   int k, int nr, int nrho, int poly,
                                   const double* scalars, void* stream) {
  return launch_force<double>(x, neighbors, numneigh, rhor, z2r, fp_local, fp, f, nrows,
                              nlocal_pad, k, nr, nrho, poly, scalars, stream);
}

// the blocks of one instantiation an SM holds (the occupancy API): pass
// 5 (K5) or 6 (K6), f64 0 or 1, poly 0 or 1; a negative CUDA error code
// on failure
extern "C" int eam_nlist_blocks_per_sm(int pass, int f64, int poly) {
  const void* fn = nullptr;
  if (pass == 5)
    fn = f64 ? (poly ? reinterpret_cast<const void*>(&eam_rho_nlist_kernel<double, true>)
                     : reinterpret_cast<const void*>(&eam_rho_nlist_kernel<double, false>))
             : (poly ? reinterpret_cast<const void*>(&eam_rho_nlist_kernel<float, true>)
                     : reinterpret_cast<const void*>(&eam_rho_nlist_kernel<float, false>));
  else if (pass == 6)
    fn = f64 ? (poly ? reinterpret_cast<const void*>(&eam_force_nlist_kernel<double, true>)
                     : reinterpret_cast<const void*>(&eam_force_nlist_kernel<double, false>))
             : (poly ? reinterpret_cast<const void*>(&eam_force_nlist_kernel<float, true>)
                     : reinterpret_cast<const void*>(&eam_force_nlist_kernel<float, false>));
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
