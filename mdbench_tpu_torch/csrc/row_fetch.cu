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
// Design. A block of 128 threads walks kStagesPerBlock consecutive stages
// of 8 output rows (4 KiB) through a double buffer in shared memory: while
// stage i is stored out with coalesced 16-byte stores, stage i+1 is in
// flight. Two fetch modes, one template:
//   kCpAsync  each thread issues 16-byte cp.async.cg copies (a row is 32
//             of them), one commit group per stage, wait_group 1;
//   kTma      one thread issues one 1-D bulk copy per id (512 B for a row,
//             4 KiB for a block: cp.async.bulk ... mbarrier::complete_tx)
//             onto the stage's mbarrier, armed with the stage's byte count;
//             every thread waits on the barrier's phase.
// What bounds it: the bytes written out (the 4 MiB table of the probe
// stays in the 50 MB L2, so the reads mostly hit it), and the latency of
// each fetch at two stages in flight per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 128;                       // floats per row
constexpr int kChunks = kCols * 4 / 16;          // 16-byte chunks per row
constexpr int kStageRows = 8;                    // rows per stage (4 KiB)
constexpr int kStageChunks = kStageRows * kChunks;
constexpr int kStagesPerBlock = 4;
constexpr int kCpAsync = 0, kTma = 1;

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

// start fetching output rows [r0, r0 + nr) into the stage buffer dst
template <int kMode, int kRpi>
__device__ __forceinline__ void issue(const float* table, const int32_t* ids,
                                      int64_t r0, int nr, int n_id_max,
                                      float4* dst, uint64_t* bar) {
  if constexpr (kMode == kCpAsync) {
    for (int c = threadIdx.x; c < nr * kChunks; c += kThreads) {
      const float* src = source_row<kRpi>(table, ids, r0 + c / kChunks, n_id_max) +
                         (c % kChunks) * 4;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_u32(dst + c)), "l"(src) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    if (threadIdx.x == 0) {
      const uint32_t b = smem_u32(bar);
      // the buffer was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(b), "r"(nr * kChunks * 16) : "memory");
      for (int rr = 0; rr < nr; rr += kRpi) {  // one bulk copy per id
        const int bytes = min(kRpi, nr - rr) * kChunks * 16;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(dst + rr * kChunks)),
               "l"(source_row<kRpi>(table, ids, r0 + rr, n_id_max)), "r"(bytes),
               "r"(b)
            : "memory");
      }
    }
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

template <int kMode, int kRpi>
__global__ void __launch_bounds__(kThreads)
row_fetch_kernel(const float* __restrict__ table, const int32_t* __restrict__ ids,
                 float* __restrict__ out, int64_t n_out_rows, int n_id_max) {
  __shared__ __align__(128) float4 buf[2][kStageChunks];
  __shared__ __align__(8) uint64_t bar[2];
  const int64_t n_stages = (n_out_rows + kStageRows - 1) / kStageRows;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * kStagesPerBlock;
  const int ns = static_cast<int>(min64(kStagesPerBlock, n_stages - s0));
  if (ns <= 0) return;  // the whole block alike
  if constexpr (kMode == kTma) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_u32(&bar[k])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  auto rows_of = [&](int i) {
    return static_cast<int>(min64(kStageRows, n_out_rows - (s0 + i) * kStageRows));
  };
  issue<kMode, kRpi>(table, ids, s0 * kStageRows, rows_of(0), n_id_max, buf[0], &bar[0]);
  for (int i = 0; i < ns; ++i) {
    const int nxt = (i + 1) & 1;
    if (i + 1 < ns) {
      issue<kMode, kRpi>(table, ids, (s0 + i + 1) * kStageRows, rows_of(i + 1),
                         n_id_max, buf[nxt], &bar[nxt]);
    } else if constexpr (kMode == kCpAsync) {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // keeps the count
    }
    if constexpr (kMode == kCpAsync) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
    } else {
      wait_phase(&bar[i & 1], (i >> 1) & 1);
    }
    const int nr = rows_of(i);
    const float4* src = buf[i & 1];
    float4* dst = reinterpret_cast<float4*>(out + (s0 + i) * kStageRows * kCols);
    for (int c = threadIdx.x; c < nr * kChunks; c += kThreads) dst[c] = src[c];
    __syncthreads();  // the buffer is free for stage i+2
  }
}

template <int kMode, int kRpi>
int launch(const float* table, const int32_t* ids, float* out, int n_ids,
           int n_table_rows, void* stream) {
  const int64_t n_out_rows = static_cast<int64_t>(n_ids) * kRpi;
  const int64_t n_stages = (n_out_rows + kStageRows - 1) / kStageRows;
  const int64_t blocks = (n_stages + kStagesPerBlock - 1) / kStagesPerBlock;
  row_fetch_kernel<kMode, kRpi><<<static_cast<unsigned>(blocks), kThreads, 0,
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
    return launch<kCpAsync, 1>(table, ids, out, n_ids, n_table_rows, stream);
  if (rows_per_id == 8 && mode == kCpAsync)
    return launch<kCpAsync, 8>(table, ids, out, n_ids, n_table_rows, stream);
  if (rows_per_id == 1 && mode == kTma)
    return launch<kTma, 1>(table, ids, out, n_ids, n_table_rows, stream);
  if (rows_per_id == 8 && mode == kTma)
    return launch<kTma, 8>(table, ids, out, n_ids, n_table_rows, stream);
  return cudaErrorInvalidValue;
}
