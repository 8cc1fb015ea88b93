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
// Every id of a tile below njg may be read, so entries past the group's nj
// must be valid j16 rows too (the sentinel j16, or a real j16 more than
// cutneigh from the whole group, as mdbench_tpu's lists hold there): the
// cutoff test, not the list length, removes them. The planes must start on
// a 16-byte boundary and tc on an 8-byte one: the kernel reads them as
// vectors.
//
// Design. The unit of work is one member (an 8-atom i-cluster) and one
// warp, over that member's own window only: j16 entries 8*start ..
// 8*min(end, njg) - 1 of its group's list row, i.e. 16 j-clusters (rows of
// 8 atoms) per tile. A block holds kWarps warps, members of one group, so
// they share the group's list rows in L1; there is no block barrier after
// the typed form's table load. The warp walks its window's j-clusters in
// chunks of 32:
//   1. cull: lane l takes j-cluster l of the chunk, loads its 8 atoms (two
//      16-byte vectors a plane in float32, four in float64), forms its
//      bounding box and the squared box distance d2 to the member's box,
//      and votes to keep it unless d2 >= the cutoff; __ballot_sync gives
//      the warp one mask, so the decision is warp-uniform;
//   2. pairs: the warp runs the kept j-clusters in list order. Lane (i, q)
//      = (lane / 4, lane % 4) holds i-atom i and takes the 2 contiguous
//      j-atoms 2q, 2q+1 of the j-cluster (one 8-byte vector a plane in
//      float32, 16 bytes in float64): 8 i x 8 j pairs a warp step. The next
//      kept j-cluster's coordinates are loaded into registers before the
//      current one's pair math runs (software pipelining).
// Each lane keeps its own partial sums; at the end a fixed-order
// __shfl_xor_sync reduction over the 4 q-lanes (xor 1, then xor 2) gives
// every q-lane of i-atom i the same sum, which lanes q = 0, 1, 2 write to
// fx, fy, fz once, with no atomics: the result is deterministic. It
// differs from the plain version only in the order of the sum.
//
// Why the cull drops no pair that the plain version keeps. The boxes take
// fminf/fmaxf (NaN-ignoring) over the atoms' current coordinates; the
// per-axis gap is max(lo_i - hi_j, lo_j - hi_i, 0) and d2 the sum of the
// squared gaps, with the same correctly rounded operations in the same
// order as a pair's rsq. A kept pair has finite coordinates, so its atoms
// lie inside both boxes and the boxes' bounds are not NaN: lo_i - hi_j <=
// |x_i - x_j| exactly on each axis (and likewise lo_j - hi_i). Rounding to
// nearest is monotone and odd, so round(gap) <= |round(x_i - x_j)|, the
// rounded squares keep that order, and so do the two rounded sums: d2 <=
// rsq. Skipping only where d2 >= cutforcesq therefore skips only pairs
// with rsq >= cutforcesq, which the plain version drops too; no margin is
// needed. A NaN d2 never skips. On all-NaN coordinates (the cluster stub
// after its forces overflow) every gap is 0, nothing is culled, and every
// pair takes the distance test, which none passes. The typed form culls
// against the largest cutsq of its table.
//
// What bounds it on the card: the pair arithmetic of the kept j-clusters
// (one IEEE divide and ~20 flops per pair inside the cutoff, 8 for the
// distance test), at a warp step of 64 pairs; the cull's loads and box
// arithmetic are one lane per window j-cluster. The typed form adds the
// table reads (shared memory, one a pair, three inside the cutoff). On the
// benchmark's 131,072-atom lists (an H100 SXM at 700 W, chip_smoke.py
// phase 14) the cull keeps 55% of 1.59M window j-clusters, so the warps
// run 55.8M lane-pairs (a block-wide lock-step walk over the same windows
// ran 134.8M) in 0.106 ms in float32: about K1's time per pair, 13% of
// the bound on the window pairs. Block size: 8 warps and no register cap.
// Capping float32 at 40 registers (48 resident warps instead of 40) made
// ptxas spill and the kernel 5-6% slower (probes/stream.py); 4-warp
// blocks gained 4-5% in float64 only.
//
// Padding atoms sit at ~1e30; in float32 their rsq overflows to inf and
// two coinciding padding atoms give rsq == 0. The cutoff test therefore
// SELECTS (a branch around the pair math), never multiplies by a 0/1
// mask (inf * 0 = NaN). The reciprocal is an IEEE divide.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;             // i-clusters (members) per group
constexpr int kTileJ16 = 8;            // j16 per tile
constexpr int kRanges = 2 * kGroup + 1;
constexpr int kMaxTypes = 32;          // typed form: the largest T
constexpr int kWarps = 8;              // warps (members) per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerGroup = kGroup / kWarps;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGroup % kWarps == 0, "a block holds members of one group");

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// lo and hi (NaN-ignoring) of the 8 values of one row of a plane
template <typename T> struct Row;
template <> struct Row<float> {
  __device__ __forceinline__ static void bounds(const float* p, float& lo, float& hi) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    lo = fminf(fminf(fminf(a.x, a.y), fminf(a.z, a.w)),
               fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
    hi = fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)),
               fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w)));
  }
  // atoms 2q, 2q+1 of a row
  __device__ __forceinline__ static float2 two(const float* p, int q) {
    return __ldg(reinterpret_cast<const float2*>(p) + q);
  }
};
template <> struct Row<double> {
  __device__ __forceinline__ static void bounds(const double* p, double& lo, double& hi) {
    const double2* v = reinterpret_cast<const double2*>(p);
    const double2 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2), d = __ldg(v + 3);
    lo = fmin(fmin(fmin(a.x, a.y), fmin(b.x, b.y)), fmin(fmin(c.x, c.y), fmin(d.x, d.y)));
    hi = fmax(fmax(fmax(a.x, a.y), fmax(b.x, b.y)), fmax(fmax(c.x, c.y), fmax(d.x, d.y)));
  }
  __device__ __forceinline__ static double2 two(const double* p, int q) {
    return __ldg(reinterpret_cast<const double2*>(p) + q);
  }
};

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// the bounding box of one 8-atom row
template <typename T> struct Box {
  T lx, ly, lz, hx, hy, hz;
  __device__ __forceinline__ void load(const T* xc, const T* yc, const T* zc,
                                       int64_t row) {
    Row<T>::bounds(xc + row * 8, lx, hx);
    Row<T>::bounds(yc + row * 8, ly, hy);
    Row<T>::bounds(zc + row * 8, lz, hz);
  }
};

// per-axis gap max(lo_a - hi_b, lo_b - hi_a, 0), rounded as a pair's dx
template <typename T>
__device__ __forceinline__ T gap(T lo_a, T hi_a, T lo_b, T hi_b) {
  return vmax(vmax(sub_rn(lo_a, hi_b), sub_rn(lo_b, hi_a)), T(0));
}

// squared box distance in the order of a pair's rsq
template <typename T>
__device__ __forceinline__ T box_d2(const Box<T>& a, const Box<T>& b) {
  const T gx = gap(a.lx, a.hx, b.lx, b.hx);
  const T gy = gap(a.ly, a.hy, b.ly, b.hy);
  const T gz = gap(a.lz, a.hz, b.lz, b.hz);
  return add_rn(add_rn(mul_rn(gx, gx), mul_rn(gy, gy)), mul_rn(gz, gz));
}

// the two j atoms of a lane in one kept j-cluster
template <typename T> struct JAtoms {
  typename Vec2<T>::type x, y, z;
  int2 t;
  template <bool kTyped>
  __device__ __forceinline__ void load(const T* xc, const T* yc, const T* zc,
                                       const int32_t* tc, int64_t row, int q) {
    x = Row<T>::two(xc + row * 8, q);
    y = Row<T>::two(yc + row * 8, q);
    z = Row<T>::two(zc + row * 8, q);
    if constexpr (kTyped) {
      t = __ldg(reinterpret_cast<const int2*>(tc + row * 8) + q);
    } else {
      t = make_int2(0, 0);
    }
  }
};

template <typename T, bool kTyped>
__device__ __forceinline__ void pair(T xi, T yi, T zi, T xj, T yj, T zj, int tj,
                                     T cutforcesq, T sigma6, T epsilon,
                                     const T* eps_i, const T* sig6_i,
                                     const T* cutsq_i, int ntypes, T& ax,
                                     T& ay, T& az) {
  const T dx = xi - xj;
  const T dy = yi - yj;
  const T dz = zi - zj;
  const T rsq = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
  T cut = cutforcesq;
  if constexpr (kTyped) {
    tj = min(max(tj, 0), ntypes - 1);
    cut = cutsq_i[tj];
  }
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
  // typed form only: the eps, sig6, cutsq tables, T^2 each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_tab = reinterpret_cast<T*>(smem_raw);
  const int nt2 = kTyped ? ntypes * ntypes : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ia = lane / 4;  // i-atom (slot of the member)
  const int q = lane % 4;   // j-atoms 2q, 2q+1 of each j-cluster
  const int g = blockIdx.x / kBlocksPerGroup;
  const int m = (blockIdx.x % kBlocksPerGroup) * kWarps + warp;
  const int64_t irow = static_cast<int64_t>(g) * kGroup + m;

  T cull = cutforcesq;  // the cutoff the box test uses
  if constexpr (kTyped) {
    for (int k = threadIdx.x; k < nt2; k += kThreads) {
      s_tab[k] = eps_t[k];
      s_tab[nt2 + k] = sig6_t[k];
      s_tab[2 * nt2 + k] = cutsq_t[k];
    }
    __syncthreads();  // once, before any pair: the tables are read-only after
    cull = T(-INFINITY);
    for (int k = lane; k < nt2; k += 32) cull = vmax(cull, s_tab[2 * nt2 + k]);
    for (int o = 16; o > 0; o /= 2) cull = vmax(cull, __shfl_xor_sync(kFull, cull, o));
  }

  const int32_t* rg = ranges + static_cast<int64_t>(g) * kRanges;
  const int njg = min(max(rg[2 * kGroup], 0), L / kTileJ16);
  const int s0 = max(rg[m], 0);
  const int s1 = min(rg[kGroup + m], njg);
  // the window's j-clusters: entry e0 + k/2, row half k%2
  const int nwin = s1 > s0 ? (s1 - s0) * kTileJ16 * 2 : 0;
  const int32_t* list = jlist + static_cast<int64_t>(g) * L + s0 * kTileJ16;

  const int64_t iatom = irow * 8 + ia;
  const T xi = xc[iatom], yi = yc[iatom], zi = zc[iatom];
  int ti = 0;
  if constexpr (kTyped) ti = min(max(tc[iatom], 0), ntypes - 1);
  // this lane's rows of the tables (typed form only)
  const T* eps_i = s_tab + ti * ntypes;
  const T* sig6_i = eps_i + nt2;
  const T* cutsq_i = sig6_i + nt2;
  T ax = T(0), ay = T(0), az = T(0);

  Box<T> ibox;
  if (nwin > 0) ibox.load(xc, yc, zc, irow);

  for (int base = 0; base < nwin; base += 32) {
    // 1. cull: lane l votes for j-cluster base + l
    const int k = base + lane;
    int jrow = 0;  // the row of an 8-atom j-cluster (C_total < 2^31)
    bool keep = false;
    if (k < nwin) {
      jrow = 2 * __ldg(list + k / 2) + (k % 2);
      Box<T> jbox;
      jbox.load(xc, yc, zc, jrow);
      keep = !(box_d2(ibox, jbox) >= cull);
    }
    unsigned mask = __ballot_sync(kFull, keep);
    if (mask == 0) continue;
    // 2. pairs over the kept j-clusters, the next one's loads in flight
    int src = __ffs(mask) - 1;
    mask &= mask - 1;
    JAtoms<T> cur;
    cur.template load<kTyped>(xc, yc, zc, tc, __shfl_sync(kFull, jrow, src), q);
    while (true) {
      const bool more = mask != 0;  // warp-uniform
      JAtoms<T> nxt;
      if (more) {
        src = __ffs(mask) - 1;
        mask &= mask - 1;
        nxt.template load<kTyped>(xc, yc, zc, tc, __shfl_sync(kFull, jrow, src), q);
      }
      pair<T, kTyped>(xi, yi, zi, cur.x.x, cur.y.x, cur.z.x, cur.t.x, cutforcesq,
                      sigma6, epsilon, eps_i, sig6_i, cutsq_i, ntypes, ax, ay, az);
      pair<T, kTyped>(xi, yi, zi, cur.x.y, cur.y.y, cur.z.y, cur.t.y, cutforcesq,
                      sigma6, epsilon, eps_i, sig6_i, cutsq_i, ntypes, ax, ay, az);
      if (!more) break;
      cur = nxt;
    }
  }

  // fixed-order reduction over the 4 q-lanes of each i-atom
  for (int o = 1; o < 4; o *= 2) {
    ax += __shfl_xor_sync(kFull, ax, o);
    ay += __shfl_xor_sync(kFull, ay, o);
    az += __shfl_xor_sync(kFull, az, o);
  }
  if (q == 0) fx[iatom] = ax;
  if (q == 1) fy[iatom] = ay;
  if (q == 2) fz[iatom] = az;
}

template <typename T, bool kTyped>
int launch(const T* xc, const T* yc, const T* zc, const int32_t* tc,
           const int32_t* jlist, const int32_t* ranges, const T* eps_t,
           const T* sig6_t, const T* cutsq_t, T* fx, T* fy, T* fz, int ng,
           int L, int ntypes, T cutforcesq, T sigma6, T epsilon,
           void* stream) {
  if (ng <= 0 || L <= 0 || L % kTileJ16) return cudaErrorInvalidValue;
  if (kTyped && (ntypes < 1 || ntypes > kMaxTypes)) return cudaErrorInvalidValue;
  // typed: the tables (at most 24 KB in float64)
  const size_t smem = kTyped ? 3 * sizeof(T) * ntypes * ntypes : 0;
  lj_cluster_stream_kernel<T, kTyped>
      <<<ng * kBlocksPerGroup, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
