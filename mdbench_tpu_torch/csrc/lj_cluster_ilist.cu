// Exact-list Lennard-Jones force for the cluster-pair scheme, for Hopper
// (sm_90a). Replaces mdbench_tpu/ops/pallas/lj_cluster.py::_kernel_ilist
// (the TPU kernel launched by lj_cluster_force_ilist_pallas), in both of
// its forms: untyped, and typed (its `tables` branch, the reference's
// EXPLICIT_TYPES per-type-pair parameters, clusterpair/atom.c:78-92).
//
// Contract (the same as the TPU kernel's):
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
//   typed form:  tc (C_total, 8) int32 atom types and three (T, T) tables
//                eps, sig6, cutsq in T's precision; each pair takes
//                eps, sigma6 and cutforcesq from [t_i * T + t_j]. Types
//                outside [0, T) are clamped into it (the caller keeps
//                them inside; the clamp only keeps the reads in bounds).
//
// Design. One thread per i-atom; the sum stays in registers and runs in
// list order, so the result is deterministic and needs no atomics. A
// block of 128 threads holds 128/(8*share) units. The block walks its
// units' lists in tiles: each unit's threads stage tile_j listed j16
// (16 atoms x 3 coordinates each) into shared memory with coalesced
// 16-atom loads, then every thread of the unit reads them back as
// broadcasts. Only the coordinates of listed j16 are read, once per unit
// per step: no pre-gathered planes as on the TPU. The typed form is a
// second instantiation of the same template: the block copies the three
// tables into shared memory once, each staged j atom is one packed
// record of its coordinates and its type (Packed below: one 16-byte
// shared-memory read per pair in float32, two in float64), each thread
// reads its own type once and keeps pointers to its rows of the tables.
// The TPU kernel's T^2 trace-time selects per tile are not needed; T is a
// runtime value up to 32 (24 KB of tables in float64).
//
// The tile loop runs in two sweeps per chunk of 128 staged atoms
// (csrc/ilist_sweep.cuh). Sweep A, distance only: each thread forms rsq
// for every staged atom of the chunk (planes read as 16-byte vectors; in
// the typed form the record and the pair's cutoff cutsq_i[tj]) and sets
// bit e of a 128-bit register mask where 0 < rsq < cutoff. Sweep B: the
// thread pops its set bits in ascending order, recomputes that pair's d
// and rsq with the same operations and runs the pair math (the reciprocal,
// sr6, gf; typed, eps and sigma6 from the tables) into its sums. So each
// i-atom's sum runs over exactly the plain version's pairs in list order,
// and K1b equals K1 bit for bit. Lanes with fewer set bits wait for the
// warp's busiest lane; chunks run to the warp's longest list, and each
// lane masks the atoms past its own unit's.
//
// What bounds it on the card: issue slots, at about half the card's rate.
// At 131k (the LJ run's final bucketed lists, ops/lj_cluster.
// ilist_sweep_counts) 7,215,039 of 65,316,096 listed pairs lie inside the
// cutoff (11%). Sweep A costs ~11 slots a listed pair (three vector reads
// per four atoms, rsq, two compares, the bit) over 2,212,096 warp steps;
// sweep B ~40 a step (the pop, the recomputed d and rsq, the pair math,
// the sums) over 460,428 warp steps (efficiency 0.49: mean set bits over
// the busiest lane's). A branch around the pair math per pair was taken
// by some lane at 1,149,994 staged atoms (0.54 of sweep A's steps), each
// time for ~14 (approximate reciprocal) or ~24 (divide) slots: so the two
// sweeps gain on the divide and lose on the approximate reciprocal, whose
// pair math is cheaper than sweep B's own steps. On one H100 (NVIDIA H100
// 80GB HBM3, 700.00 W; probes/ilist.py, the branch loop's kernel beside
// this one in one process), float32 K1b: exact 0.1210-0.1212 ms with the
// branch, 0.1077-0.1090 with the two sweeps; with the approximate
// reciprocal 0.0929 against 0.0997-0.1005; float64 0.1600-0.1605 against
// 0.1185-0.1194. Each staged coordinate is reused by share*8 threads, so
// memory does not bound it. The tile loop runs to the block's longest
// list, and units with shorter lists idle for the rest of it.
//
// The bucketed form (K1b; replaces the per-bucket calls of the same TPU
// kernel in mdbench_tpu/engine_cluster.py::_force_buckets) is the same
// kernel with a runtime unit map, so each unit's sum is K1's bit for bit:
//   ijlist       (n_rows, icap) = bijlist, the lists in nji-sorted order
//                (the capacity buckets' maps, ops/cluster.py)
//   bcrows       (n_rows*share,) int32: the cluster rows of the unit at
//                each position; a row past n_units*share marks a dummy
//                unit, which reads and writes nothing
//   buckets      position ranges [end[k-1], end[k]) with caps cap[k]: a
//                unit reads min(nji, cap[k]) entries, so a bucket whose
//                cap is below its longest list truncates as the TPU path's
//                bijlist[:, :cap] does; a cap-0 tier reads nothing and its
//                units' rows get exactly 0
//   fx, fy, fz   (n_units*share, 8), each unit's rows written straight
//                from its position: no permuted i-planes and no inverse
//                gather, which on the TPU only served BlockSpec's need for
//                contiguous blocks
// A block takes upb consecutive positions, so its units have nearly equal
// lists and the tile loop's length is what each of them needs. One launch
// covers every bucket, the zero tier included (its blocks write zeros and
// stop): the step is launch-bound, and a launch per bucket would add two.
//
// Padding atoms sit at ~1e30; in float32 their rsq overflows to inf and
// two coinciding padding atoms give rsq == 0, and NaN coordinates give a
// NaN rsq. None of them sets a bit, so none reaches the pair math: the
// cutoff test SELECTS, never multiplies by a 0/1 mask (inf * 0 = NaN).
// rsq is computed with explicitly rounded operations, in the plain
// version's order, so the kernel keeps exactly the plain version's pair
// set even where the compiler would contract it into fused multiply-adds.
// The reciprocal is an IEEE divide, or, in float32 when the caller asks
// for it (Params.approx_rcp, as the TPU kernel's approx_rcp),
// rcp.approx.ftz.f32 and one Newton step, r (2 - rsq r): the counterpart
// of pl.reciprocal(approx=True) and its step. Float64 ignores the flag,
// as the TPU kernel does. Only pairs inside the cutoff reach the
// reciprocal (sweep B).
//
// The bf16 form (T2, the probe of tools/r3_bf16.py: force_bf16 -> _kernel,
// the TPU kernel that runs K1's pair tile in bfloat16) is a third form of
// the pair math in the same kernel: untyped, flat lists, float32 planes,
// the TPU kernel's order of operations (r3_bf16.py:59-88), one rounding
// per operation:
//   dx, dy, dz   subtracted in float32, rounded to bfloat16
//   rsq          (dx*dx + dy*dy) + dz*dz in bfloat16
//   mask         0 < rsq < cutforcesq, on rsq's float32 value
//   sr2          the approximate float32 reciprocal (rcp.approx, the
//                counterpart of pl.reciprocal(approx=True); no Newton
//                step) of rsq, rounded to bf16
//   sr6          ((sr2*sr2)*sr2)*sigma6 in bfloat16
//   gf           ((48eps*sr6)*(sr6 - 1/2))*sr2 in bfloat16
//   f_i          sum of float32(d*gf) (the product in bfloat16) in float32,
//                in list order, over the pairs inside the mask
// sigma6 and 48*eps arrive already rounded to bfloat16 (the wrapper rounds
// them as the TPU kernel's b(sigma6), b(48 eps) do). It runs K1's two
// sweeps. Sweep A (ilist_sweep::sweep_planes_bf16) forms rsq for two
// staged atoms at a time as one __nv_bfloat162 (three packed converts of
// the float32 distances, five packed operations) and sets their bits with
// two packed compares against cutforcesq rounded up to bfloat16 by the
// wrapper (ceil_bf16): for a bfloat16 rsq that selects exactly the pairs
// of the float32 test. Sweep B pops the set bits two at a time in
// ascending order and runs the pair math on both as one lane pair (two
// rcp.approx.ftz.f32, then sr6, gf and d*gf packed), adding the lower
// pair's terms first; an odd last bit runs beside itself and adds its own
// term only. The _rn intrinsics keep each product and sum apart (no fused
// multiply-adds the TPU kernel does not have).
//
// Same bits as the form's first design, a loop that ran the masked pair
// math on every staged pair: there a pair outside the mask added
// float32(d * 0) = +-0 to each sum. A float32 sum that starts at +0 is
// never -0 (x + y rounds an exact zero to +0), so adding +-0 leaves it
// as it is, and dropping those terms changes no bit, as long as every d
// is finite: every coordinate finite and of magnitude below 1e38 (the
// engines' padding sits at SENTINEL_COORD = 1e30, where rsq is inf and
// the pair drops out). A NaN or inf coordinate made the earlier sum NaN
// (d * 0 = NaN); now such a pair sets no bit and is skipped.
// What bounds it on the card: issue slots, as K1's sweeps (per listed
// pair sweep A's six float32 subtracts and converts and seven bf16
// operations; per inside pair the pair math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ilist_sweep.cuh"
#include "unit_map.cuh"

namespace {

using ilist_sweep::kChunk;
using ilist_sweep::Mask;
using ilist_sweep::rsq_rn;
using unit_map::Buckets;
using unit_map::unit_of;

constexpr int kThreads = 128;      // threads per block
constexpr int kJ16 = 16;           // atoms per j-cluster
constexpr int kSmemBytes = 24576;  // staging budget per block
constexpr int kMaxTypes = 32;      // typed form: the largest T
// dynamic shared memory a launch may take without opting in (48 KB less
// the static s_nmax and some slack)
constexpr size_t kDefaultSmem = 48 * 1024 - 64;

// the pair math: an IEEE divide, the approximate reciprocal with one
// Newton step (float32 only), or the bf16 form (float32, untyped)
enum class PairMath { kIeee, kRcpNewton, kBf16x2 };

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1/x from the approximate reciprocal and one Newton step (float32 only)
__device__ __forceinline__ float rcp_newton(float x) {
  const float r = rcp_approx(x);
  return __fmul_rn(r, __fmaf_rn(-x, r, 2.0f));
}

// The bf16 form's pair math on staged atoms e1 and e2, two pairs inside
// the cutoff, as one lane pair: d*gf per axis, widened to float32 (.x for
// e1, .y for e2). sig6 and e48 hold sigma6 and 48 eps in bfloat16.
__device__ __forceinline__ void bf16_terms(const float* sx, const float* sy,
                                           const float* sz, int e1, int e2, float xi,
                                           float yi, float zi, __nv_bfloat162 sig6,
                                           __nv_bfloat162 e48, float2& px, float2& py,
                                           float2& pz) {
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 dx = __floats2bfloat162_rn(xi - sx[e1], xi - sx[e2]);
  const __nv_bfloat162 dy = __floats2bfloat162_rn(yi - sy[e1], yi - sy[e2]);
  const __nv_bfloat162 dz = __floats2bfloat162_rn(zi - sz[e1], zi - sz[e2]);
  const float2 rs = __bfloat1622float2(ilist_sweep::rsq_bf16x2(dx, dy, dz));
  const __nv_bfloat162 sr2 = __floats2bfloat162_rn(rcp_approx(rs.x), rcp_approx(rs.y));
  const __nv_bfloat162 sr6 = __hmul2_rn(__hmul2_rn(__hmul2_rn(sr2, sr2), sr2), sig6);
  const __nv_bfloat162 gf = __hmul2_rn(
      __hmul2_rn(__hmul2_rn(e48, sr6), __hsub2_rn(sr6, half)), sr2);
  px = __bfloat1622float2(__hmul2_rn(dx, gf));
  py = __bfloat1622float2(__hmul2_rn(dy, gf));
  pz = __bfloat1622float2(__hmul2_rn(dz, gf));
}

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

template <typename T, bool kTyped, PairMath kMath>
__global__ void __launch_bounds__(kThreads)
lj_cluster_ilist_kernel(const T* __restrict__ xc, const T* __restrict__ yc,
                        const T* __restrict__ zc,
                        const int32_t* __restrict__ tc,
                        const int32_t* __restrict__ ijlist,
                        const int32_t* __restrict__ nji,
                        const int32_t* __restrict__ bcrows,
                        const T* __restrict__ eps_t,
                        const T* __restrict__ sig6_t,
                        const T* __restrict__ cutsq_t, T* __restrict__ fx,
                        T* __restrict__ fy, T* __restrict__ fz, int n_rows,
                        int n_units, int icap, int share, int tile_j,
                        int ntypes, const Buckets bk, T cutforcesq, T sigma6,
                        T epsilon) {
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
  // shared memory, untyped: upb units x 3 planes x tile_atoms coordinates;
  // typed: upb units x tile_atoms packed records, then the eps, sig6 and
  // cutsq tables, T^2 each
  const int nt2 = kTyped ? ntypes * ntypes : 0;
  T* sx = reinterpret_cast<T*>(smem_raw) + lu * 3 * tile_atoms;
  T* sy = sx + tile_atoms;
  T* sz = sy + tile_atoms;
  Packed<T>* sp = reinterpret_cast<Packed<T>*>(smem_raw) + lu * tile_atoms;
  T* s_tab = reinterpret_cast<T*>(reinterpret_cast<Packed<T>*>(smem_raw) +
                                  upb * tile_atoms);
  if constexpr (kTyped) {
    for (int k = threadIdx.x; k < nt2; k += kThreads) {
      s_tab[k] = eps_t[k];
      s_tab[nt2 + k] = sig6_t[k];
      s_tab[2 * nt2 + k] = cutsq_t[k];
    }
    // sweep A reads whole chunks, past the unit's staged atoms too, and
    // looks up each record's type: every record holds a valid type from
    // here on (the same thread stages the same records later)
    for (int e = ia; e < tile_atoms; e += tpu) sp[e].put(T(0), T(0), T(0), 0);
  }

  int n = 0;
  if (active) n = min(max(nji[u], 0), cap);
  if (threadIdx.x == 0) s_nmax = 0;
  __syncthreads();
  if (active && ia == 0) atomicMax(&s_nmax, n);
  __syncthreads();
  const int nmax = s_nmax;

  const int64_t row = static_cast<int64_t>(u) * tpu + ia;
  T xi = T(0), yi = T(0), zi = T(0);
  int ti = 0;
  if (active) {
    xi = xc[row];
    yi = yc[row];
    zi = zc[row];
    if constexpr (kTyped) ti = min(max(tc[row], 0), ntypes - 1);
  }
  // this thread's rows of the tables (typed form only)
  const T* eps_i = s_tab + ti * ntypes;
  const T* sig6_i = eps_i + nt2;
  const T* cutsq_i = sig6_i + nt2;
  const int32_t* list = ijlist + static_cast<int64_t>(active ? s : 0) * icap;
  T ax = T(0), ay = T(0), az = T(0);
  const int nw = __reduce_max_sync(0xffffffffu, n);  // the warp's longest list

  for (int k0 = 0; k0 < nmax; k0 += tile_j) {
    const int m = min(tile_j, n - k0) * kJ16;    // this unit's atoms in the tile
    const int mw = min(tile_j, nw - k0) * kJ16;  // the warp's most
    for (int e = ia; e < m; e += tpu) {
      const int64_t src = static_cast<int64_t>(list[k0 + e / kJ16]) * kJ16 + e % kJ16;
      if constexpr (kTyped) {
        sp[e].put(xc[src], yc[src], zc[src], min(max(tc[src], 0), ntypes - 1));
      } else {
        sx[e] = xc[src];
        sy[e] = yc[src];
        sz[e] = zc[src];
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < mw; c0 += kChunk) {
      // sweep A: the chunk's pairs inside the cutoff, this unit's atoms only
      Mask mask;
      if constexpr (kTyped) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          T xj, yj, zj;
          int tj;
          sp[c0 + k].get(xj, yj, zj, tj);
          const T rsq = rsq_rn(xi - xj, yi - yj, zi - zj);
          if (rsq < cutsq_i[tj] && rsq > T(0)) mask.set(k);
        }
      } else if constexpr (kMath == PairMath::kBf16x2) {
        // cutforcesq arrives rounded up to bfloat16 (the wrapper's ceil_bf16)
        mask = ilist_sweep::sweep_planes_bf16(sx, sy, sz, c0, xi, yi, zi,
                                              __float2bfloat162_rn(cutforcesq));
      } else {
        mask = ilist_sweep::sweep_planes(sx, sy, sz, c0, xi, yi, zi, cutforcesq);
      }
      mask.keep_below(m - c0);
      if constexpr (kMath == PairMath::kBf16x2) {
        static_assert(std::is_same_v<T, float> && !kTyped, "bf16: float32, untyped");
        // sweep B, bf16: the set bits two at a time in ascending order, the
        // lower term added first; an odd last bit runs beside itself and
        // adds its own term only. sigma6 and epsilon hold sigma6 and 48 eps
        // in bfloat16.
        const __nv_bfloat162 sig6 = __float2bfloat162_rn(sigma6);
        const __nv_bfloat162 e48 = __float2bfloat162_rn(epsilon);
        while (mask.any()) {
          const int e1 = c0 + mask.pop();
          const bool two = mask.any();
          const int e2 = two ? c0 + mask.pop() : e1;
          float2 px, py, pz;
          bf16_terms(sx, sy, sz, e1, e2, xi, yi, zi, sig6, e48, px, py, pz);
          ax += px.x;
          ay += py.x;
          az += pz.x;
          if (two) {
            ax += px.y;
            ay += py.y;
            az += pz.y;
          }
        }
      } else {
        // sweep B: the pair math on the set bits, in list order
        while (mask.any()) {
          const int e = c0 + mask.pop();
          T xj, yj, zj, s6 = sigma6, ep = epsilon;
          if constexpr (kTyped) {
            int tj;
            sp[e].get(xj, yj, zj, tj);
            s6 = sig6_i[tj];
            ep = eps_i[tj];
          } else {
            xj = sx[e];
            yj = sy[e];
            zj = sz[e];
          }
          const T dx = xi - xj;
          const T dy = yi - yj;
          const T dz = zi - zj;
          const T rsq = rsq_rn(dx, dy, dz);
          T sr2;
          if constexpr (kMath == PairMath::kRcpNewton) {
            sr2 = rcp_newton(rsq);
          } else {
            sr2 = T(1) / rsq;
          }
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
  if (active) {
    fx[row] = ax;
    fy[row] = ay;
    fz[row] = az;
  }
}

template <typename T, bool kTyped>
int launch(const T* xc, const T* yc, const T* zc, const int32_t* tc,
           const int32_t* ijlist, const int32_t* nji, const int32_t* bcrows,
           const T* eps_t, const T* sig6_t, const T* cutsq_t, T* fx, T* fy,
           T* fz, int n_rows, int n_units, int icap, int share, int ntypes,
           const Buckets& bk, T cutforcesq, T sigma6, T epsilon, PairMath math,
           void* stream) {
  if (share != 1 && share != 2 && share != 4) return cudaErrorInvalidValue;
  if (n_rows <= 0 || n_units <= 0 || icap <= 0) return cudaErrorInvalidValue;
  if (kTyped && (ntypes < 1 || ntypes > kMaxTypes)) return cudaErrorInvalidValue;
  const int upb = kThreads / (share * 8);
  // bytes staged per listed j atom and unit: 3 coordinates, or a record
  const int per_atom = static_cast<int>(kTyped ? sizeof(Packed<T>) : 3 * sizeof(T));
  const int tile_j = ilist_sweep::whole_chunks(kSmemBytes / (upb * kJ16 * per_atom));
  const size_t tables = kTyped ? 3 * sizeof(T) * ntypes * ntypes : 0;
  const size_t smem = tables + static_cast<size_t>(upb) * tile_j * kJ16 * per_atom;
  auto* kernel = lj_cluster_ilist_kernel<T, kTyped, PairMath::kIeee>;
  if constexpr (std::is_same_v<T, float>) {  // float64 ignores approx_rcp
    if (math == PairMath::kRcpNewton)
      kernel = lj_cluster_ilist_kernel<T, kTyped, PairMath::kRcpNewton>;
    if constexpr (!kTyped) {
      if (math == PairMath::kBf16x2)
        kernel = lj_cluster_ilist_kernel<T, kTyped, PairMath::kBf16x2>;
    }
  }
  if (smem > kDefaultSmem) {  // beyond the default limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n_rows + upb - 1) / upb;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xc, yc, zc, tc, ijlist, nji, bcrows, eps_t, sig6_t, cutsq_t, fx, fy, fz,
      n_rows, n_units, icap, share, tile_j, ntypes, bk, cutforcesq, sigma6,
      epsilon);
  return static_cast<int>(cudaGetLastError());
}

// the flat forms: list row u is unit u
template <typename T, bool kTyped>
int launch_flat(const T* xc, const T* yc, const T* zc, const int32_t* tc,
                const int32_t* ijlist, const int32_t* nji, const T* eps_t,
                const T* sig6_t, const T* cutsq_t, T* fx, T* fy, T* fz,
                int n_units, int icap, int share, int ntypes, T cutforcesq,
                T sigma6, T epsilon, PairMath math, void* stream) {
  const Buckets flat{};  // n = 0: no map
  return launch<T, kTyped>(xc, yc, zc, tc, ijlist, nji, nullptr, eps_t, sig6_t,
                           cutsq_t, fx, fy, fz, n_units, n_units, icap, share,
                           ntypes, flat, cutforcesq, sigma6, epsilon, math,
                           stream);
}

// the bucketed form (untyped): nbuckets position ranges ending at ends[k]
// (ends[nbuckets-1] == n_rows) with caps caps[k], both host arrays
template <typename T>
int launch_buckets(const T* xc, const T* yc, const T* zc, const int32_t* bijlist,
                   const int32_t* bcrows, const int32_t* nji, T* fx, T* fy,
                   T* fz, int n_rows, int icap, int n_units, int share,
                   int nbuckets, const int* ends, const int* caps, T cutforcesq,
                   T sigma6, T epsilon, PairMath math, void* stream) {
  Buckets bk{};
  if (bcrows == nullptr || !unit_map::make_buckets(nbuckets, ends, caps, n_rows, bk))
    return cudaErrorInvalidValue;
  return launch<T, false>(xc, yc, zc, nullptr, bijlist, nji, bcrows, nullptr,
                          nullptr, nullptr, fx, fy, fz, n_rows, n_units, icap,
                          share, 0, bk, cutforcesq, sigma6, epsilon, math,
                          stream);
}

// approx_rcp of the entry points: non-zero takes the approximate reciprocal
PairMath math_of(int approx_rcp) {
  return approx_rcp ? PairMath::kRcpNewton : PairMath::kIeee;
}

}  // namespace

// Every entry point takes approx_rcp (non-zero: the approximate reciprocal
// with one Newton step) just before the stream; the float64 ones ignore it.
extern "C" int lj_cluster_ilist_f32(const float* xc, const float* yc,
                                    const float* zc, const int32_t* ijlist,
                                    const int32_t* nji, float* fx, float* fy,
                                    float* fz, int n_units, int icap,
                                    int share, float cutforcesq, float sigma6,
                                    float epsilon, int approx_rcp, void* stream) {
  return launch_flat<float, false>(xc, yc, zc, nullptr, ijlist, nji, nullptr,
                                   nullptr, nullptr, fx, fy, fz, n_units, icap,
                                   share, 0, cutforcesq, sigma6, epsilon,
                                   math_of(approx_rcp), stream);
}

extern "C" int lj_cluster_ilist_f64(const double* xc, const double* yc,
                                    const double* zc, const int32_t* ijlist,
                                    const int32_t* nji, double* fx, double* fy,
                                    double* fz, int n_units, int icap,
                                    int share, double cutforcesq,
                                    double sigma6, double epsilon,
                                    int approx_rcp, void* stream) {
  return launch_flat<double, false>(xc, yc, zc, nullptr, ijlist, nji, nullptr,
                                    nullptr, nullptr, fx, fy, fz, n_units, icap,
                                    share, 0, cutforcesq, sigma6, epsilon,
                                    math_of(approx_rcp), stream);
}

// the typed form: tables eps, sig6, cutsq are (ntypes, ntypes) on the card
extern "C" int lj_cluster_ilist_typed_f32(
    const float* xc, const float* yc, const float* zc, const int32_t* tc,
    const int32_t* ijlist, const int32_t* nji, const float* eps,
    const float* sig6, const float* cutsq, float* fx, float* fy, float* fz,
    int n_units, int icap, int share, int ntypes, int approx_rcp, void* stream) {
  return launch_flat<float, true>(xc, yc, zc, tc, ijlist, nji, eps, sig6, cutsq,
                                  fx, fy, fz, n_units, icap, share, ntypes, 0.0f,
                                  0.0f, 0.0f, math_of(approx_rcp), stream);
}

extern "C" int lj_cluster_ilist_typed_f64(
    const double* xc, const double* yc, const double* zc, const int32_t* tc,
    const int32_t* ijlist, const int32_t* nji, const double* eps,
    const double* sig6, const double* cutsq, double* fx, double* fy,
    double* fz, int n_units, int icap, int share, int ntypes, int approx_rcp,
    void* stream) {
  return launch_flat<double, true>(xc, yc, zc, tc, ijlist, nji, eps, sig6, cutsq,
                                   fx, fy, fz, n_units, icap, share, ntypes, 0.0,
                                   0.0, 0.0, math_of(approx_rcp), stream);
}

// the bucketed form (K1b): (xc, yc, zc, bijlist, bcrows, nji, fx, fy, fz,
// n_rows, icap, n_units, share, nbuckets, ends, caps, cutforcesq, sigma6,
// epsilon, approx_rcp, stream); fx, fy, fz are (n_units*share, 8)
extern "C" int lj_cluster_ilist_buckets_f32(
    const float* xc, const float* yc, const float* zc, const int32_t* bijlist,
    const int32_t* bcrows, const int32_t* nji, float* fx, float* fy, float* fz,
    int n_rows, int icap, int n_units, int share, int nbuckets, const int* ends,
    const int* caps, float cutforcesq, float sigma6, float epsilon, int approx_rcp,
    void* stream) {
  return launch_buckets<float>(xc, yc, zc, bijlist, bcrows, nji, fx, fy, fz,
                               n_rows, icap, n_units, share, nbuckets, ends, caps,
                               cutforcesq, sigma6, epsilon, math_of(approx_rcp),
                               stream);
}

extern "C" int lj_cluster_ilist_buckets_f64(
    const double* xc, const double* yc, const double* zc, const int32_t* bijlist,
    const int32_t* bcrows, const int32_t* nji, double* fx, double* fy, double* fz,
    int n_rows, int icap, int n_units, int share, int nbuckets, const int* ends,
    const int* caps, double cutforcesq, double sigma6, double epsilon,
    int approx_rcp, void* stream) {
  return launch_buckets<double>(xc, yc, zc, bijlist, bcrows, nji, fx, fy, fz,
                                n_rows, icap, n_units, share, nbuckets, ends, caps,
                                cutforcesq, sigma6, epsilon, math_of(approx_rcp),
                               stream);
}

// the bf16 form (T2): (xc, yc, zc, ijlist, nji, fx, fy, fz, n_units, icap,
// share, cutforcesq rounded up to bfloat16 (ceil_bf16), sigma6 and
// 48*epsilon rounded to bfloat16, stream)
extern "C" int lj_cluster_ilist_bf16(const float* xc, const float* yc,
                                     const float* zc, const int32_t* ijlist,
                                     const int32_t* nji, float* fx, float* fy,
                                     float* fz, int n_units, int icap, int share,
                                     float cutforcesq, float sigma6_bf,
                                     float eps48_bf, void* stream) {
  return launch_flat<float, false>(xc, yc, zc, nullptr, ijlist, nji, nullptr,
                                   nullptr, nullptr, fx, fy, fz, n_units, icap,
                                   share, 0, cutforcesq, sigma6_bf, eps48_bf,
                                   PairMath::kBf16x2, stream);
}
