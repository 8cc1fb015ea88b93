// The verlet ranges build's candidate stage, for Hopper (sm_90a). It
// replaces no TPU kernel: mdbench_tpu runs this stage as XLA ops, the part
// of derive_rowlists_from_ranges before its exact prune
// (mdbench_tpu/ops/verlet.py:533-829). The port ran it as torch ops
// (ops/verlet.range_candidates_ref): ~40 for the unit columns, then a loop
// over chunks of units of ~75 small launches each (26 chunks a rebuild at
// 1M atoms), whose gathers write ~60 MB a chunk. Here the whole stage is
// one launch; the exact prune (verlet_prune.cu) reads its candidates.
//
// Contract:
//   x        (nrows, 3) T, contiguous; unit u is the rows 16u .. 16u+15,
//            and atom 16u + a of it is real iff 16u + a < nlocal
//   bins     (16 nu,) int64: each unit row's flat bin (ops/cells.coord_to_bin)
//   starts_l, starts_g  (d0 d1 d2 + 1,) int64: per flat bin q the number
//            of locals (ghosts) whose bin is below q, from the bin-sorted
//            locals and the cell-sorted ghosts (torch.searchsorted)
//   cand     (nu, ccap) int64, written: unit u's candidate 16-row ids
//   counts   (3, nu) int64, written: per unit total, n_dc and nk (below)
//   stats    (4,) int64, zeroed by the caller: [max total, max n_dc,
//            max nk, 0], raised by atomicMax
// Per unit, exactly what the plain version computes:
//   1. its distinct xy columns bin // d2 over its real atoms, ascending
//      (n_dc of them; the first ucol used), each with the least and the
//      largest z = bin % d2 among its atoms (floor division and remainder,
//      as torch's // and %; a bin at or past COL_BIG counts as no atom);
//   2. its xy bbox over its real atoms (FBIG / -FBIG without one; a NaN
//      coordinate makes it NaN, as torch's amin and amax);
//   3. for each column and each of the 9 columns of its 3x3 stencil, the
//      stencil column cs = clamp(col + offset, 0, ncols), kept iff cs <
//      ncols and gx^2 + gy^2 <= cutsq, where gx = max((bx - 1) bs0 - xhi,
//      xlo - bx bs0) clamped at 0 (bx = cs // d1; gy the same in y), in
//      T, each product, difference and sum rounded on its own as torch's
//      separate ops round them (__fmul_rn, __fsub_rn, __fadd_rn: nvcc
//      -O3 would contract to FMA), a NaN never kept, and cutsq rounded to
//      T as torch rounds a Python float against a tensor;
//   4. the local and the ghost 16-row range [base + (a0 >> 4), base +
//      ((a1 - 1) >> 4) + 1) of a kept stencil column, with a0, a1 the
//      block's starts at z0 = max(zlo - 1, 0) and z1 + 1 = min(zhi + 1,
//      d2 - 1) + 1, empty iff a1 <= a0; base 0 for locals, nu for ghosts;
//   5. nk, the non-empty ranges; the first kcap of them by start, trimmed
//      to disjoint intervals by the running maximum of their ends; total,
//      the length of their union; cand the union's first ccap ids in
//      ascending order, then sent16.
// Only where nk > kcap (an overflow, which the caller's flag reports and
// the engine grows past) can cand and total differ from the plain
// version's: which of several ranges with the start at the kcap-th is
// kept is then free. Elsewhere the union does not depend on the order of
// equal starts, and every output is the plain version's bit for bit.
//
// Design: one warp per unit, units in a grid-stride loop. Lanes 0-15
// hold the unit's atoms: 16 rounds of shuffles give each lane whether it
// is its column's first atom and the column's z range, a ballot the
// distinct columns, 16 more rounds each first atom's rank among them
// (shared memory holds the first ucol). Shuffle trees give the bbox. Lane
// l takes stencil slots l, l + 32, ... (local slots first, as the plain
// version orders them); the non-empty ranges are compacted by a ballot in
// slot order, ordered by a rank by count in shared memory (ties by slot:
// nk^2 compares, broadcast reads), trimmed by a warp scan of the running
// maximum and prefix-summed by a warp scan, 32 ranges a round. Lane l
// fills candidate slots l, l + 32, ... by a binary search over the ends,
// as coalesced int64 stores. The maxima go through shared memory to one
// atomicMax a block and statistic. Nothing synchronises with the host.
//
// What bounds it: bytes. It reads the unit rows' x and y and their bins
// (16 B an atom; 17 MB at 1M atoms), up to 2 x 9 x ucol pairs of start
// entries a unit from the two tables (which stay in the 50 MB L2), and
// writes nu x ccap x 8 bytes of candidates (63 MB at 1M, ccap 120) and 24
// bytes a unit of counts: ~0.025 ms at 3.35 TB/s. Its work is a few
// thousand instructions a unit, serial within a warp; the grid keeps
// enough warps resident to hide the latency of the table reads.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // units in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 8;  // grid cap, a little over what an SM holds
constexpr int kAtoms = 16;       // atoms per unit
constexpr int kStencil = 9;      // columns of a 3x3 stencil
constexpr int kMaxRanges = 2 * kStencil * kAtoms;  // a unit has <= 16 columns
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kColBig = 1LL << 29;  // ops/verlet.COL_BIG
constexpr double kFbig = 1e30;           // ops/verlet.FBIG

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
};

// torch.minimum / maximum / amin / amax: NaN if either is NaN
template <typename T> __device__ __forceinline__ T min_nan(T a, T b) {
  return (b < a || b != b) ? b : a;
}
template <typename T> __device__ __forceinline__ T max_nan(T a, T b) {
  return (b > a || b != b) ? b : a;
}
// torch.clamp(min=0): NaN stays NaN
template <typename T> __device__ __forceinline__ T clamp0(T a) { return a < T(0) ? T(0) : a; }

// torch's // and % on int64 with a positive divisor
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  const long long r = a % b;
  return r < 0 ? r + b : r;
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? b : a;
}

// the xy gap of a unit's bbox to stencil column cs, squared, <= cutsq
template <typename T>
__device__ __forceinline__ bool gap_within(int cs, int d1, T bs0, T bs1, T xlo, T xhi,
                                           T ylo, T yhi, T cutsq) {
  using A = Arith<T>;
  const T bx = T(cs / d1), by = T(cs % d1);
  const T gx = clamp0(max_nan(A::sub(A::mul(A::sub(bx, T(1)), bs0), xhi),
                              A::sub(xlo, A::mul(bx, bs0))));
  const T gy = clamp0(max_nan(A::sub(A::mul(A::sub(by, T(1)), bs1), yhi),
                              A::sub(ylo, A::mul(by, bs1))));
  return A::add(A::mul(gx, gx), A::mul(gy, gy)) <= cutsq;  // false for NaN
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
verlet_ranges_kernel(const T* __restrict__ x, const int64_t* __restrict__ bins,
                     const int64_t* __restrict__ starts_l,
                     const int64_t* __restrict__ starts_g, int64_t* __restrict__ cand,
                     int64_t* __restrict__ counts, unsigned long long* __restrict__ stats,
                     int nu, int nlocal, int ucol, int kcap, int ccap, int d1, int d2,
                     int ncols, int sent16, T bs0, T bs1, T cutsq) {
  using A = Arith<T>;
  __shared__ long long s_col[kWarps][kAtoms];
  __shared__ int s_zlo[kWarps][kAtoms], s_zhi[kWarps][kAtoms];
  __shared__ int s_lo[kWarps][kMaxRanges], s_hi[kWarps][kMaxRanges];
  // the first kcap ranges by start; then each one's offset (id - slot) and end
  __shared__ int s_off[kWarps][kMaxRanges], s_end[kWarps][kMaxRanges];
  __shared__ unsigned long long s_max[kWarps][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncap = min(ucol, kAtoms), kc = min(kcap, kMaxRanges);
  unsigned long long m_total = 0, m_ndc = 0, m_nk = 0;  // lane 0's maxima
  for (int u = blockIdx.x * kWarps + warp; u < nu; u += gridDim.x * kWarps) {
    // 1. the unit's atoms on lanes 0-15: column, z, bbox
    const int64_t row = int64_t(u) * kAtoms + (lane & (kAtoms - 1));
    const bool real = lane < kAtoms && row < nlocal;
    long long col = kColBig;
    int z = 0;
    T xlo = A::inf(), xhi = -A::inf(), ylo = A::inf(), yhi = -A::inf();
    if (lane < kAtoms) {
      xlo = ylo = T(kFbig);
      xhi = yhi = T(-kFbig);
    }
    if (real) {
      const long long b = bins[row];
      if (b < kColBig) {
        col = floor_div(b, d2);
        z = int(floor_mod(b, d2));
      }
      xlo = xhi = x[row * 3];
      ylo = yhi = x[row * 3 + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      xlo = min_nan(xlo, __shfl_xor_sync(kFull, xlo, o));
      xhi = max_nan(xhi, __shfl_xor_sync(kFull, xhi, o));
      ylo = min_nan(ylo, __shfl_xor_sync(kFull, ylo, o));
      yhi = max_nan(yhi, __shfl_xor_sync(kFull, yhi, o));
    }
    // 2. distinct columns, ascending, each with its z range
    bool first = col != kColBig;
    int zlo = z, zhi = z;
#pragma unroll
    for (int j = 0; j < kAtoms; ++j) {
      const long long cj = __shfl_sync(kFull, col, j);
      const int zj = __shfl_sync(kFull, z, j);
      if (cj == col) {
        first = first && j >= lane;
        zlo = min(zlo, zj);
        zhi = max(zhi, zj);
      }
    }
    const unsigned fmask = __ballot_sync(kFull, first);
    const int n_dc = __popc(fmask);
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kAtoms; ++j) {
      const long long cj = __shfl_sync(kFull, col, j);
      rank += ((fmask >> j) & 1u) && cj < col;
    }
    if (first && rank < ncap) {
      s_col[warp][rank] = col;
      s_zlo[warp][rank] = zlo;
      s_zhi[warp][rank] = zhi;
    }
    __syncwarp();
    // 3. the non-empty ranges of the stencil columns, local slots then
    // ghost slots, compacted in slot order
    const int nd = min(n_dc, ncap), nloc = kStencil * nd;
    int nk = 0;
    for (int s0 = 0; s0 < 2 * nloc; s0 += 32) {
      const int s = s0 + lane;
      bool live = false;
      int lo = 0, hi = 0;
      if (s < 2 * nloc) {
        const bool ghost = s >= nloc;
        const int r = ghost ? s - nloc : s;
        const int i = r / kStencil, a = r % kStencil;
        // int64 wraps as torch's add does
        const long long c = (long long)((unsigned long long)s_col[warp][i] +
                                        (unsigned long long)(long long)((a / 3 - 1) * d1 +
                                                                        (a % 3 - 1)));
        const int cs = int(c < 0 ? 0 : (c > ncols ? ncols : c));
        if (cs < ncols && gap_within(cs, d1, bs0, bs1, xlo, xhi, ylo, yhi, cutsq)) {
          const int z0 = max(s_zlo[warp][i] - 1, 0);
          const int z1 = min(s_zhi[warp][i] + 1, d2 - 1);
          const int64_t* st = (ghost ? starts_g : starts_l) + int64_t(cs) * d2;
          const long long a0 = st[z0], a1 = st[z1 + 1];
          if (a1 > a0) {
            const int base = ghost ? nu : 0;
            live = true;
            lo = base + int(a0 >> 4);
            hi = base + int((a1 - 1) >> 4) + 1;
          }
        }
      }
      const unsigned ball = __ballot_sync(kFull, live);
      if (live) {
        const int p = nk + __popc(ball & ((1u << lane) - 1u));
        s_lo[warp][p] = lo;
        s_hi[warp][p] = hi;
      }
      nk += __popc(ball);
    }
    __syncwarp();
    // 4. the first kcap ranges by start: rank by count, ties by slot
    for (int p = lane; p < nk; p += 32) {
      const int lo = s_lo[warp][p];
      int k = 0;
      for (int q = 0; q < nk; ++q) {
        const int lq = s_lo[warp][q];
        k += lq < lo || (lq == lo && q < p);
      }
      if (k < kc) {
        s_off[warp][k] = lo;
        s_end[warp][k] = s_hi[warp][p];
      }
    }
    __syncwarp();
    // 5. trim each range to what lies past the ends before it; prefix-sum
    // the lengths (32 ranges a round, the carries from lane 31)
    const int nr = min(nk, kc);
    int cmax = 0, csum = 0;
    for (int k0 = 0; k0 < nr; k0 += 32) {
      const int k = k0 + lane;
      const bool in = k < nr;
      const int lo = in ? s_off[warp][k] : 0, hi = in ? s_end[warp][k] : 0;
      int m = hi;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, m, o);
        if (lane >= o) m = max(m, v);
      }
      m = max(m, cmax);
      int pm = __shfl_up_sync(kFull, m, 1);
      if (lane == 0) pm = cmax;
      const int lo2 = max(lo, min(pm, hi));
      const int ln = in ? max(hi - lo2, 0) : 0;
      int e = ln;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, e, o);
        if (lane >= o) e += v;
      }
      e += csum;
      if (in) {
        s_off[warp][k] = lo2 - (e - ln);
        s_end[warp][k] = e;
      }
      cmax = __shfl_sync(kFull, m, 31);
      csum = __shfl_sync(kFull, e, 31);
    }
    const int total = csum;
    __syncwarp();
    // 6. slot t of the union lies in the first range whose end passes t
    int64_t* cu = cand + int64_t(u) * ccap;
    for (int t = lane; t < ccap; t += 32) {
      int64_t id = sent16;
      if (t < total) {
        int lo = 0, hi = nr - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_end[warp][mid] > t) hi = mid;
          else lo = mid + 1;
        }
        id = t + s_off[warp][lo];
      }
      cu[t] = id;
    }
    if (lane == 0) {
      counts[u] = total;
      counts[int64_t(nu) + u] = n_dc;
      counts[2 * int64_t(nu) + u] = nk;
      m_total = max_u64(m_total, total);
      m_ndc = max_u64(m_ndc, n_dc);
      m_nk = max_u64(m_nk, nk);
    }
    __syncwarp();  // the next unit overwrites this warp's shared rows
  }
  if (lane == 0) {
    s_max[warp][0] = m_total;
    s_max[warp][1] = m_ndc;
    s_max[warp][2] = m_nk;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long m = 0;
    for (int w = 0; w < kWarps; ++w) m = max_u64(m, s_max[w][threadIdx.x]);
    if (m) atomicMax(stats + threadIdx.x, m);
  }
}

template <typename T>
int ranges(const T* x, const int64_t* bins, const int64_t* starts_l, const int64_t* starts_g,
           int64_t* cand, int64_t* counts, int64_t* stats, int nu, int nlocal, int ucol,
           int kcap, int ccap, int d0, int d1, int d2, int sent16, T bs0, T bs1, T cutsq,
           void* stream) {
  if (nu < 0 || ucol < 1 || kcap < 1 || ccap < 0 || d0 < 1 || d1 < 1 || d2 < 1 ||
      sent16 < 0 || int64_t(d0) * d1 * d2 >= (int64_t(1) << 31))
    return cudaErrorInvalidValue;
  if (nu == 0) return cudaSuccess;
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (int64_t(nu) + kWarps - 1) / kWarps, cap = int64_t(nsm) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  verlet_ranges_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, bins, starts_l, starts_g, cand, counts, reinterpret_cast<unsigned long long*>(stats),
      nu, nlocal, ucol, kcap, ccap, d1, d2, d0 * d1, sent16, bs0, bs1, cutsq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (x, bins, starts_l, starts_g, cand, counts, stats, nu, nlocal, ucol, kcap,
//  ccap, d0, d1, d2, sent16, bs0, bs1, cutsq, stream); returns the launch's
// CUDA error (0: launched, or nu 0)
extern "C" int verlet_ranges_f32(const float* x, const int64_t* bins, const int64_t* starts_l,
                                 const int64_t* starts_g, int64_t* cand, int64_t* counts,
                                 int64_t* stats, int nu, int nlocal, int ucol, int kcap,
                                 int ccap, int d0, int d1, int d2, int sent16, float bs0,
                                 float bs1, float cutsq, void* stream) {
  return ranges<float>(x, bins, starts_l, starts_g, cand, counts, stats, nu, nlocal, ucol,
                       kcap, ccap, d0, d1, d2, sent16, bs0, bs1, cutsq, stream);
}

extern "C" int verlet_ranges_f64(const double* x, const int64_t* bins,
                                 const int64_t* starts_l, const int64_t* starts_g,
                                 int64_t* cand, int64_t* counts, int64_t* stats, int nu,
                                 int nlocal, int ucol, int kcap, int ccap, int d0, int d1,
                                 int d2, int sent16, double bs0, double bs1, double cutsq,
                                 void* stream) {
  return ranges<double>(x, bins, starts_l, starts_g, cand, counts, stats, nu, nlocal, ucol,
                        kcap, ccap, d0, d1, d2, sent16, bs0, bs1, cutsq, stream);
}
