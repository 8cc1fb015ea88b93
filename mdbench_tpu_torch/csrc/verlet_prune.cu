// The verlet row lists' exact prune, for Hopper (sm_90a). It replaces no
// TPU kernel: mdbench_tpu runs this stage as XLA ops, the exact prune
// that its two row-list builds share (mdbench_tpu/ops/verlet.py:465 in
// derive_rowlists_from_cells, :830 in derive_rowlists_from_ranges). The
// port ran it as torch ops (ops/verlet.exact_prune_ref), which write a
// (units, 16, cc x 16) float distance block to device memory, chunk by
// chunk, and pass over it about ten times; here no distance leaves the
// registers.
//
// Contract:
//   x        (nrows, 3) T, contiguous, 16-byte aligned; 16-row id c names
//            rows 16c .. 16c+15; unit u is the local rows 16u .. 16u+15
//            (16 nu <= nrows)
//   cand     (nu, cc) int64: unit u's candidate 16-row ids, each in
//            [0, nrows / 16) (reads of an id outside are clamped into it;
//            such an id's verdict is undefined)
//   validu   (nu, 16) bool: which atoms of each unit are real
//   rows     (nu, rcap) int64, written: unit u's kept candidates in
//            candidate order in its first slots, then sent16
//   numrows  (nu,) int64, written: the number kept, which may exceed rcap
// Candidate c of unit u is kept iff c != sent16 and
//   min over the real atoms i of u and all 16 atoms j of row c of
//   rsq_ij = dx*dx + dy*dy + dz*dz,   d = x_i - x_j,
// is <= cutsq (cutsq rounded to T, as torch compares a float32 tensor
// with a Python float). Each product and sum is rounded on its own, in
// that order (__fmul_rn/__fadd_rn: nvcc -O3 would contract to FMA), as
// the plain version's separate torch ops round them; the minimum is NaN
// if any such rsq is NaN (torch's amin propagates NaN), so a NaN drops
// the row; a unit's padding atoms count as FBIG (the plain version's
// torch.where), so a unit without a real atom keeps nothing. The rows and
// counts are the plain version's bit for bit.
//
// Design: one warp per unit, one lane per candidate. The warp stages the
// unit's 48 coordinates in shared memory and its padding mask in a
// ballot; lane l takes candidates l, l + 32, ... in rounds. Each lane
// loads its candidate's 16 atoms (192 contiguous bytes in float32) into
// registers as 16-byte loads, then walks the unit's real atoms (a warp-uniform branch skips
// padding atoms), broadcast from shared memory, keeping one running
// minimum per row atom (16 independent chains). A round's keep bits go
// through one ballot; a lane's slot is the kept count before the round
// plus the popcount of the ballot's lower lanes, so the kept rows land in
// candidate order with no sort and no second pass. A round whose lanes
// all hold sent16 (the padding at the end of a list) does no arithmetic.
// One launch a rebuild; nothing synchronises with the host. A half-warp
// per candidate (one lane per row atom, a shuffle tree for the minimum)
// would load rows coalesced but spend 4 shuffles and 4 minima a candidate
// and need a second ballot to order the verdicts; one lane per candidate
// keeps the ordering to one ballot and the row in registers.
//
// What bounds it: operations. Each (real unit atom, row atom) pair of a
// candidate other than sent16 costs 8 (3 subtracts, 3 multiplies, 2 adds)
// plus the minimum; at 1M atoms (65,536 units, ccap 128, ~70% real
// candidates) that is ~1.5e9 pairs a rebuild, ~0.2 ms at 67 TFLOP/s. The
// bytes (x 12.6 MB, which stays in the 50 MB L2, the int64 candidates 67
// MB, the rows) take ~0.04 ms at 3.35 TB/s. The unfused arithmetic the
// bit-equality needs costs up to twice the FMA-counted peak.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;         // units (warps) per block
constexpr int kThreads = kWarps * 32;
constexpr int kAtoms = 16;        // atoms per unit and per row
constexpr int kVals = 3 * kAtoms; // coordinates per unit or row
constexpr unsigned kFull = 0xffffffffu;
constexpr double kFbig = 1e30;    // the plain version's FBIG

template <typename T> struct Arith;

template <> struct Arith<float> {
  using Vec = float4;  // one 16-byte load
  static constexpr int kPerVec = 4;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  // NaN if either is NaN (fminf would return the other)
  static __device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  }
  static __device__ __forceinline__ void unpack(const Vec& v, float* r) {
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
};

template <> struct Arith<double> {
  using Vec = double2;
  static constexpr int kPerVec = 2;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  // a is the running minimum: once NaN it stays NaN; a NaN b makes it NaN
  static __device__ __forceinline__ double min_nan(double a, double b) {
    return (b < a || b != b) ? b : a;
  }
  static __device__ __forceinline__ void unpack(const Vec& v, double* r) {
    r[0] = v.x; r[1] = v.y;
  }
};

// the 48 coordinates of the 16 rows at p (atom-major: x, y, z per atom)
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, T (&r)[kVals]) {
  using A = Arith<T>;
  const typename A::Vec* q = reinterpret_cast<const typename A::Vec*>(p);
#pragma unroll
  for (int c = 0; c < kVals / A::kPerVec; ++c) A::unpack(__ldg(q + c), r + c * A::kPerVec);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
verlet_prune_kernel(const T* __restrict__ x, const int64_t* __restrict__ cand,
                    const uint8_t* __restrict__ validu, int64_t* __restrict__ rows,
                    int64_t* __restrict__ numrows, int nu, int cc, int rcap,
                    int64_t sent16, int64_t n16, T cutsq) {
  using A = Arith<T>;
  __shared__ T s_unit[kWarps][kVals];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t u = int64_t(blockIdx.x) * kWarps + warp;
  if (u >= nu) return;  // u is warp-uniform: whole warps leave
  T* su = s_unit[warp];
  for (int e = lane; e < kVals; e += 32) su[e] = x[u * kVals + e];
  const unsigned vmask =
      __ballot_sync(kFull, lane < kAtoms && validu[u * kAtoms + lane] != 0);
  __syncwarp();
  // the plain version's minimum runs over the padding atoms' FBIG too
  const T init = vmask == 0xffffu ? A::inf() : T(kFbig);
  const int64_t* cu = cand + u * cc;
  int64_t* ru = rows + u * int64_t(rcap);
  int64_t kept = 0;
  for (int base = 0; base < cc; base += 32) {
    const int k = base + lane;
    const int64_t c = k < cc ? cu[k] : sent16;
    bool keep = false;
    if (c != sent16) {
      T r[kVals];
      const int64_t cs = c < 0 ? 0 : (c >= n16 ? n16 - 1 : c);
      load_row(x + cs * kVals, r);
      T m[kAtoms];
#pragma unroll
      for (int j = 0; j < kAtoms; ++j) m[j] = init;
#pragma unroll
      for (int i = 0; i < kAtoms; ++i) {
        if (!((vmask >> i) & 1u)) continue;
        const T xi = su[3 * i], yi = su[3 * i + 1], zi = su[3 * i + 2];
#pragma unroll
        for (int j = 0; j < kAtoms; ++j) {
          const T dx = A::sub(xi, r[3 * j]);
          const T dy = A::sub(yi, r[3 * j + 1]);
          const T dz = A::sub(zi, r[3 * j + 2]);
          const T rsq = A::add(A::add(A::mul(dx, dx), A::mul(dy, dy)), A::mul(dz, dz));
          m[j] = A::min_nan(m[j], rsq);
        }
      }
      T mind = m[0];
#pragma unroll
      for (int j = 1; j < kAtoms; ++j) mind = A::min_nan(mind, m[j]);
      keep = mind <= cutsq;  // false for NaN
    }
    const unsigned ball = __ballot_sync(kFull, keep);
    if (keep) {
      const int64_t slot = kept + __popc(ball & ((1u << lane) - 1u));
      if (slot < rcap) ru[slot] = c;
    }
    kept += __popc(ball);
  }
  for (int64_t s = kept + lane; s < rcap; s += 32) ru[s] = sent16;
  if (lane == 0) numrows[u] = kept;
}

template <typename T>
int prune(const T* x, const int64_t* cand, const uint8_t* validu, int64_t* rows,
          int64_t* numrows, int nu, int cc, int rcap, int sent16, int n16, T cutsq,
          void* stream) {
  if (nu < 0 || cc < 0 || rcap < 0 || n16 <= 0 || sent16 < 0 || sent16 >= n16)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorMisalignedAddress;
  if (nu == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((int64_t(nu) + kWarps - 1) / kWarps);
  verlet_prune_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cand, validu, rows, numrows, nu, cc, rcap, sent16, n16, cutsq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (x, cand, validu, rows, numrows, nu, cc, rcap, sent16, n16, cutsq, stream);
// returns the launch's CUDA error (0: launched, or nu 0)
extern "C" int verlet_prune_f32(const float* x, const int64_t* cand, const uint8_t* validu,
                                int64_t* rows, int64_t* numrows, int nu, int cc, int rcap,
                                int sent16, int n16, float cutsq, void* stream) {
  return prune<float>(x, cand, validu, rows, numrows, nu, cc, rcap, sent16, n16, cutsq,
                      stream);
}

extern "C" int verlet_prune_f64(const double* x, const int64_t* cand, const uint8_t* validu,
                                int64_t* rows, int64_t* numrows, int nu, int cc, int rcap,
                                int sent16, int n16, double cutsq, void* stream) {
  return prune<double>(x, cand, validu, rows, numrows, nu, cc, rcap, sent16, n16, cutsq,
                       stream);
}
