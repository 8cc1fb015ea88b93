// Group-window Lennard-Jones force for the cluster-pair scheme, for Hopper
// (sm_90a). Replaces mdbench_tpu/ops/pallas/lj_cluster.py::_kernel_stream
// (the TPU kernel launched by lj_cluster_force_pallas_stream), in both of
// its forms: untyped, and typed (its `tables` branch, the reference's
// EXPLICIT_TYPES per-type-pair parameters, clusterpair/atom.c:78-92).
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
//   typed form:  tc (C_total, 8) int32 atom types and three (T, T) tables
//                eps, sig6, cutsq in T's precision; each pair takes
//                eps, sigma6 and cutforcesq from [t_i * T + t_j]. Types
//                outside [0, T) are clamped into it (the caller keeps
//                them inside; the clamp only keeps the reads in bounds).
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
// ones-dot lane reduction. The typed form is a second instantiation of
// the same template: the block copies the three tables into shared memory
// once, each staged j atom is one packed record of its coordinates and
// its type (Packed below: one 16-byte shared-memory read per pair in
// float32, two in float64), each thread reads its own type once and keeps
// pointers to its rows of the tables, and a pair reads its cutoff (and,
// inside it, eps and sigma6) from shared memory. The TPU kernel's T^2
// selects per slab and T selects per tile are not needed; T is a runtime
// value up to 32 (24 KB of tables in float64).
//
// What bounds it on the card: the pair arithmetic over the window pairs
// (one divide and ~20 flops per pair inside the cutoff); each staged
// coordinate is reused by up to 128 threads. A warp holds four members,
// and where their windows differ the warp runs the tile with the other
// members' lanes idle. The typed form adds the table reads (one per
// pair, three inside the cutoff).
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
constexpr int kMaxTypes = 32;          // typed form: the largest T

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// A staged j atom of the typed form: x, y, z and the type's bits, moved
// to and from shared memory as 16-byte vectors.
template <typename T> struct Packed;
template <> struct Packed<float> {
  float4 a;
  __device__ __forceinline__ void put(float x, float y, float z, int t) {
    a = make_float4(x, y, z, __int_as_float(t));
  }
  __device__ __forceinline__ void get(float& x, float& y, float& z, int& t) const {
    const float4 v = a;
    x = v.x; y = v.y; z = v.z; t = __float_as_int(v.w);
  }
};
template <> struct Packed<double> {
  double2 a, b;
  __device__ __forceinline__ void put(double x, double y, double z, int t) {
    a = make_double2(x, y);
    b = make_double2(z, __longlong_as_double(t));
  }
  __device__ __forceinline__ void get(double& x, double& y, double& z, int& t) const {
    const double2 v = a, w = b;
    x = v.x; y = v.y; z = w.x; t = static_cast<int>(__double_as_longlong(w.y));
  }
};

template <typename T, bool kTyped>
__global__ void __launch_bounds__(kThreads)
lj_cluster_stream_kernel(const T* __restrict__ xc, const T* __restrict__ yc,
                         const T* __restrict__ zc,
                         const int32_t* __restrict__ tc,
                         const int32_t* __restrict__ jlist,
                         const int32_t* __restrict__ ranges,
                         const T* __restrict__ eps_t,
                         const T* __restrict__ sig6_t,
                         const T* __restrict__ cutsq_t, T* __restrict__ fx,
                         T* __restrict__ fy, T* __restrict__ fz, int L,
                         int ntypes, T cutforcesq, T sigma6, T epsilon) {
  __shared__ T sx[kTileAtoms], sy[kTileAtoms], sz[kTileAtoms];
  // typed form only: [the tile's packed records][eps, sig6, cutsq
  // tables, T^2 each]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt2 = kTyped ? ntypes * ntypes : 0;
  Packed<T>* sp = reinterpret_cast<Packed<T>*>(smem_raw);
  T* s_tab = reinterpret_cast<T*>(sp + kTileAtoms);
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int m = t / 8;  // member of the group
  if constexpr (kTyped) {
    for (int k = t; k < nt2; k += kThreads) {
      s_tab[k] = eps_t[k];
      s_tab[nt2 + k] = sig6_t[k];
      s_tab[2 * nt2 + k] = cutsq_t[k];
    }
  }
  const int32_t* rg = ranges + static_cast<int64_t>(g) * kRanges;
  const int njg = min(max(rg[2 * kGroup], 0), L / kTileJ16);
  const int start = rg[m];
  const int end = rg[kGroup + m];
  const int32_t* list = jlist + static_cast<int64_t>(g) * L;

  const int64_t row = static_cast<int64_t>(g) * kThreads + t;
  const T xi = xc[row], yi = yc[row], zi = zc[row];
  int ti = 0;
  if constexpr (kTyped) ti = min(max(tc[row], 0), ntypes - 1);
  // this thread's rows of the tables (typed form only)
  const T* eps_i = s_tab + ti * ntypes;
  const T* sig6_i = eps_i + nt2;
  const T* cutsq_i = sig6_i + nt2;
  T ax = T(0), ay = T(0), az = T(0);

  for (int s = 0; s < njg; ++s) {
    const int64_t src =
        static_cast<int64_t>(list[s * kTileJ16 + t / 16]) * 16 + t % 16;
    if constexpr (kTyped) {
      sp[t].put(xc[src], yc[src], zc[src], min(max(tc[src], 0), ntypes - 1));
    } else {
      sx[t] = xc[src];
      sy[t] = yc[src];
      sz[t] = zc[src];
    }
    __syncthreads();
    if (s >= start && s < end) {
#pragma unroll 4
      for (int e = 0; e < kTileAtoms; ++e) {
        T xj, yj, zj;
        int tj = 0;
        if constexpr (kTyped) {
          sp[e].get(xj, yj, zj, tj);
        } else {
          xj = sx[e];
          yj = sy[e];
          zj = sz[e];
        }
        const T dx = xi - xj;
        const T dy = yi - yj;
        const T dz = zi - zj;
        const T rsq = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
        T cut = cutforcesq;
        if constexpr (kTyped) cut = cutsq_i[tj];
        if (rsq < cut && rsq > T(0)) {
          T s6 = sigma6, ep = epsilon;
          if constexpr (kTyped) {
            s6 = sig6_i[tj];
            ep = eps_i[tj];
          }
          const T sr2 = T(1) / rsq;
          const T sr6 = sr2 * sr2 * sr2 * s6;
          const T gf = T(48) * ep * sr6 * (sr6 - T(0.5)) * sr2;
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

template <typename T, bool kTyped>
int launch(const T* xc, const T* yc, const T* zc, const int32_t* tc,
           const int32_t* jlist, const int32_t* ranges, const T* eps_t,
           const T* sig6_t, const T* cutsq_t, T* fx, T* fy, T* fz, int ng,
           int L, int ntypes, T cutforcesq, T sigma6, T epsilon,
           void* stream) {
  if (ng <= 0 || L <= 0 || L % kTileJ16) return cudaErrorInvalidValue;
  if (kTyped && (ntypes < 1 || ntypes > kMaxTypes)) return cudaErrorInvalidValue;
  // typed: the tile's records and the tables (at most 28 KB in float64)
  const size_t smem =
      kTyped ? kTileAtoms * sizeof(Packed<T>) + 3 * sizeof(T) * ntypes * ntypes : 0;
  lj_cluster_stream_kernel<T, kTyped><<<ng, kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      xc, yc, zc, tc, jlist, ranges, eps_t, sig6_t, cutsq_t, fx, fy, fz, L,
      ntypes, cutforcesq, sigma6, epsilon);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lj_cluster_stream_f32(const float* xc, const float* yc,
                                     const float* zc, const int32_t* jlist,
                                     const int32_t* ranges, float* fx,
                                     float* fy, float* fz, int ng, int L,
                                     float cutforcesq, float sigma6,
                                     float epsilon, void* stream) {
  return launch<float, false>(xc, yc, zc, nullptr, jlist, ranges, nullptr,
                              nullptr, nullptr, fx, fy, fz, ng, L, 0,
                              cutforcesq, sigma6, epsilon, stream);
}

extern "C" int lj_cluster_stream_f64(const double* xc, const double* yc,
                                     const double* zc, const int32_t* jlist,
                                     const int32_t* ranges, double* fx,
                                     double* fy, double* fz, int ng, int L,
                                     double cutforcesq, double sigma6,
                                     double epsilon, void* stream) {
  return launch<double, false>(xc, yc, zc, nullptr, jlist, ranges, nullptr,
                               nullptr, nullptr, fx, fy, fz, ng, L, 0,
                               cutforcesq, sigma6, epsilon, stream);
}

// the typed form: tables eps, sig6, cutsq are (ntypes, ntypes) on the card
extern "C" int lj_cluster_stream_typed_f32(
    const float* xc, const float* yc, const float* zc, const int32_t* tc,
    const int32_t* jlist, const int32_t* ranges, const float* eps,
    const float* sig6, const float* cutsq, float* fx, float* fy, float* fz,
    int ng, int L, int ntypes, void* stream) {
  return launch<float, true>(xc, yc, zc, tc, jlist, ranges, eps, sig6, cutsq,
                             fx, fy, fz, ng, L, ntypes, 0.0f, 0.0f, 0.0f,
                             stream);
}

extern "C" int lj_cluster_stream_typed_f64(
    const double* xc, const double* yc, const double* zc, const int32_t* tc,
    const int32_t* jlist, const int32_t* ranges, const double* eps,
    const double* sig6, const double* cutsq, double* fx, double* fy,
    double* fz, int ng, int L, int ntypes, void* stream) {
  return launch<double, true>(xc, yc, zc, tc, jlist, ranges, eps, sig6, cutsq,
                              fx, fy, fz, ng, L, ntypes, 0.0, 0.0, 0.0,
                              stream);
}
