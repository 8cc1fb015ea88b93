// List-driven row fetch, for Hopper (sm_90a): the probe of tools/r4_dma.py
// (dma1 -> k1 and dma8 -> k8, TPU kernels in which a scalar-prefetched id
// list drives the DMA of one (1, 128) row or one (8, 128) block of a table
// per grid step). It asks whether staging listed rows through shared
// memory with the card's asynchronous copy engines beats plain loads (K1's
// staging, torch.index_select).
//   table   (R, 128) float32, contiguous, 16-byte aligned
//   ids     (n_ids,) int32: row ids (rows_per_id 1) or ids of blocks of 8
//           consecutive rows (rows_per_id 8: id b names rows 8b .. 8b+7);
//           each id lies in [0, R / rows_per_id) (the caller keeps them
//           inside; a clamp only keeps the reads in bounds)
//   out     (n_ids * rows_per_id, 128) float32: every fetched row, in
//           order, so that out equals index_select bit for bit (the TPU
//           kernels write only the last block they fetch)
//
// The output is cut into stages of 8 rows (4 KiB); the last stage may hold
// fewer. Two fetch modes, each its own kernel:
//   kCpAsync  a block of 128 threads walks kStagesPerBlock consecutive
//             stages through a double buffer in shared memory: each thread
//             issues 16-byte cp.async.cg copies (a row is 32 of them), one
//             commit group per stage, wait_group 1; while stage i is stored
//             out with coalesced 16-byte stores, stage i+1 is in flight.
//   kTma      no thread touches the data. Persistent blocks (TmaRing's
//             kBlocksPerSm an SM) each take a contiguous range of stages,
//             so that the ids they read lie together. One thread per block
//             runs a ring of kDepth slots, each with its mbarrier: it loads
//             a stage with 1-D bulk copies (one per id: 512 B per row, 4 KiB
//             per block) onto the slot's barrier, armed with the stage's
//             byte count; waits on the slot's phase parity; stores the slot
//             to its place in `out` with one bulk copy (shared to global, a
//             bulk group); and reloads the slot with the stage kDepth ahead
//             once that slot's store has read it (wait_group.read, kLag
//             stores still in flight). So kDepth - kLag loads and kLag
//             stores are in flight per block, and the rows make no round
//             trip through registers.
// What bounds it: the bytes written out (the 4 MiB table of the probe
// stays in the 50 MB L2, so the reads mostly hit it), and in the row form
// the bulk copies' issue. Measured on an H100 (probes/dma.py, ring shapes
// in turns): an SM's bulk copies of 512 B go out at one per ~26 ns at best
// whatever their size, and a block's one thread issues its copies one
// after another, so the row form (9 copies a stage: 8 loads and the
// store) runs at the rate of the issuing blocks an SM: 2 blocks of 8
// slots 0.0301 ms, 16 blocks of 3 slots 0.0144 ms. The block form (2
// copies a stage) is bound by the bytes at 2 blocks an SM. The cp.async
// form holds two stages in flight per block of 128 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                    // cp.async form
constexpr int kCols = 128;                       // floats per row
constexpr int kChunks = kCols * 4 / 16;          // 16-byte chunks per row
constexpr int kRowBytes = kChunks * 16;
constexpr int kStageRows = 8;                    // rows per stage (4 KiB)
constexpr int kStageChunks = kStageRows * kChunks;
constexpr int kStagesPerBlock = 4;               // cp.async form
constexpr int kCpAsync = 0, kTma = 1;
// The TMA form's ring, per rows_per_id: slots per block (a slot holds a
// stage), stores in flight before a slot reloads, persistent blocks per SM
template <int kRpi> struct TmaRing;
template <> struct TmaRing<8> {
  static constexpr int kDepth = 8, kLag = 2, kBlocksPerSm = 2;
};
template <> struct TmaRing<1> {
  static constexpr int kDepth = 3, kLag = 1, kBlocksPerSm = 16;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first float of the table row that output row r comes from
template <int kRpi>
__device__ __forceinline__ const float* source_row(const float* table,
                                                   const int32_t* ids, int64_t r,
                                                   int n_id_max) {
  const int id = min(max(ids[r / kRpi], 0), n_id_max - 1);
  return table + (static_cast<int64_t>(id) * kRpi + r % kRpi) * kCols;
}

// start fetching output rows [r0, r0 + nr) into the stage buffer dst with
// cp.async copies, one commit group
template <int kRpi>
__device__ __forceinline__ void issue(const float* table, const int32_t* ids,
                                      int64_t r0, int nr, int n_id_max,
                                      float4* dst) {
  for (int c = threadIdx.x; c < nr * kChunks; c += kThreads) {
    const float* src = source_row<kRpi>(table, ids, r0 + c / kChunks, n_id_max) +
                       (c % kChunks) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst + c)), "l"(src) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kRpi>
__global__ void __launch_bounds__(kThreads)
row_fetch_kernel(const float* __restrict__ table, const int32_t* __restrict__ ids,
                 float* __restrict__ out, int64_t n_out_rows, int n_id_max) {
  __shared__ __align__(128) float4 buf[2][kStageChunks];
  const int64_t n_stages = (n_out_rows + kStageRows - 1) / kStageRows;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * kStagesPerBlock;
  const int ns = static_cast<int>(min64(kStagesPerBlock, n_stages - s0));
  if (ns <= 0) return;  // the whole block alike
  auto rows_of = [&](int i) {
    return static_cast<int>(min64(kStageRows, n_out_rows - (s0 + i) * kStageRows));
  };
  issue<kRpi>(table, ids, s0 * kStageRows, rows_of(0), n_id_max, buf[0]);
  for (int i = 0; i < ns; ++i) {
    const int nxt = (i + 1) & 1;
    if (i + 1 < ns) {
      issue<kRpi>(table, ids, (s0 + i + 1) * kStageRows, rows_of(i + 1), n_id_max,
                  buf[nxt]);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // keeps the count
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int nr = rows_of(i);
    const float4* src = buf[i & 1];
    float4* dst = reinterpret_cast<float4*>(out + (s0 + i) * kStageRows * kCols);
    for (int c = threadIdx.x; c < nr * kChunks; c += kThreads) dst[c] = src[c];
    __syncthreads();  // the buffer is free for stage i+2
  }
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  }
}

// Load output rows [r0, r0 + nr) (nr <= kStageRows) into the ring slot
// dst: arm the slot's barrier with the stage's bytes, then one bulk copy
// per id. The ids are read first, so that their loads overlap.
template <int kRpi>
__device__ __forceinline__ void tma_load(const float* table, const int32_t* ids,
                                         int64_t r0, int nr, int n_id_max,
                                         float4* dst, uint64_t* bar) {
  constexpr int kCopies = kStageRows / kRpi;  // the most a stage takes
  const float* src[kCopies];
#pragma unroll
  for (int c = 0; c < kCopies; ++c)
    src[c] = c * kRpi < nr ? source_row<kRpi>(table, ids, r0 + c * kRpi, n_id_max)
                           : table;
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(nr * kRowBytes) : "memory");
#pragma unroll
  for (int c = 0; c < kCopies; ++c) {
    if (c * kRpi < nr) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(dst + c * kRpi * kChunks)), "l"(src[c]),
             "r"(min(kRpi, nr - c * kRpi) * kRowBytes), "r"(b)
          : "memory");
    }
  }
}

// The TMA form: one thread per block (see the header). Block b takes the
// stages [n_stages * b / grid, n_stages * (b + 1) / grid).
template <int kRpi>
__global__ void __launch_bounds__(1)
row_fetch_tma_kernel(const float* __restrict__ table, const int32_t* __restrict__ ids,
                     float* __restrict__ out, int64_t n_out_rows, int n_id_max) {
  constexpr int kTmaDepth = TmaRing<kRpi>::kDepth, kTmaLag = TmaRing<kRpi>::kLag;
  static_assert(kTmaLag >= 1 && kTmaLag < kTmaDepth, "the ring needs loads in flight");
  __shared__ __align__(128) float4 ring[kTmaDepth][kStageChunks];
  __shared__ __align__(8) uint64_t bar[kTmaDepth];
  const int64_t n_stages = (n_out_rows + kStageRows - 1) / kStageRows;
  const int64_t s0 = n_stages * blockIdx.x / gridDim.x;
  const int n = static_cast<int>(n_stages * (blockIdx.x + 1) / gridDim.x - s0);
  if (n <= 0) return;
  for (int k = 0; k < kTmaDepth; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(&bar[k])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto rows_of = [&](int i) {
    return static_cast<int>(min64(kStageRows, n_out_rows - (s0 + i) * kStageRows));
  };
  auto load = [&](int i) {
    const int k = i % kTmaDepth;
    tma_load<kRpi>(table, ids, (s0 + i) * kStageRows, rows_of(i), n_id_max, ring[k],
                   &bar[k]);
  };
  for (int i = 0; i < min(n, kTmaDepth); ++i) load(i);
  for (int i = 0; i < n; ++i) {
    const int k = i % kTmaDepth;
    wait_phase(&bar[k], (i / kTmaDepth) & 1);
    // the slot was written by the async proxy and its completion observed
    // through the barrier; the store reads it through the async proxy again
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(out + (s0 + i) * kStageRows * kCols), "r"(smem_u32(ring[k])),
                    "r"(rows_of(i) * kRowBytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the slot of stage i - kTmaLag takes stage i - kTmaLag + kTmaDepth once
    // that stage's store has read it
    const int j = i - kTmaLag + kTmaDepth;
    if (i >= kTmaLag && j < n) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kTmaLag) : "memory");
      load(j);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // every store done
}

template <int kRpi>
int launch_cp_async(const float* table, const int32_t* ids, float* out, int n_ids,
                    int n_table_rows, void* stream) {
  const int64_t n_out_rows = static_cast<int64_t>(n_ids) * kRpi;
  const int64_t n_stages = (n_out_rows + kStageRows - 1) / kStageRows;
  const int64_t blocks = (n_stages + kStagesPerBlock - 1) / kStagesPerBlock;
  row_fetch_kernel<kRpi><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, ids, out, n_out_rows, n_table_rows / kRpi);
  return static_cast<int>(cudaGetLastError());
}

template <int kRpi>
int launch_tma(const float* table, const int32_t* ids, float* out, int n_ids,
               int n_table_rows, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_out_rows = static_cast<int64_t>(n_ids) * kRpi;
  const int64_t n_stages = (n_out_rows + kStageRows - 1) / kStageRows;
  const int64_t most = int64_t{TmaRing<kRpi>::kBlocksPerSm} * sms;
  const int64_t blocks = n_stages < most ? n_stages : most;
  row_fetch_tma_kernel<kRpi><<<static_cast<unsigned>(blocks), 1, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      table, ids, out, n_out_rows, n_table_rows / kRpi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (table, ids, out, n_ids, n_table_rows, rows_per_id 1 or 8, mode 0
//  cp.async or 1 TMA bulk, stream)
extern "C" int row_fetch_f32(const float* table, const int32_t* ids, float* out,
                             int n_ids, int n_table_rows, int rows_per_id,
                             int mode, void* stream) {
  if (n_ids <= 0 || n_table_rows < rows_per_id) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  if (rows_per_id == 1 && mode == kCpAsync)
    return launch_cp_async<1>(table, ids, out, n_ids, n_table_rows, stream);
  if (rows_per_id == 8 && mode == kCpAsync)
    return launch_cp_async<8>(table, ids, out, n_ids, n_table_rows, stream);
  if (rows_per_id == 1 && mode == kTma)
    return launch_tma<1>(table, ids, out, n_ids, n_table_rows, stream);
  if (rows_per_id == 8 && mode == kTma)
    return launch_tma<8>(table, ids, out, n_ids, n_table_rows, stream);
  return cudaErrorInvalidValue;
}
