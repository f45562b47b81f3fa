// hash_partition: the p4mr switch MAPPER on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_partition.py
// (hash_partition, body _kernel). For every token: its reducer bucket
//   b = ((uint32(tok) * 0x9E3779B1) mod 2^32 >> 16) % B,  -1 where tok < 0,
// and the per-bucket histogram of the valid tokens.
//
// Bound on an H100: memory. Each token is read once (4 B) and its id written
// once (4 B), 8 B a token against a handful of integer operations; the
// histogram is B ints a row.
// Design: one thread per token in uint32 arithmetic, rows (mappers) on
// blockIdx.y so one launch covers every mapper. The TPU kernel carried the
// histogram across its sequential grid; here blocks run in no order, so each
// block counts into a private histogram in shared memory and flushes it
// with int32 atomicAdd: exact and independent of the order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerRow = 1024;
constexpr uint32_t kHashMult = 0x9E3779B1u;

__global__ void hash_partition_kernel(const int32_t* __restrict__ tokens,
                                      int32_t* __restrict__ ids,
                                      int32_t* __restrict__ hist,
                                      long long n, int num_buckets) {
  extern __shared__ int32_t local_hist[];
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) local_hist[b] = 0;
  __syncthreads();

  const long long row = blockIdx.y;
  const int32_t* tok_row = tokens + row * n;
  int32_t* ids_row = ids + row * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t tok = tok_row[i];
    int32_t b = -1;
    if (tok >= 0) {
      const uint32_t h = ((uint32_t)tok * kHashMult) >> 16;
      b = (int32_t)(h % (uint32_t)num_buckets);
      atomicAdd(&local_hist[b], 1);
    }
    ids_row[i] = b;
  }
  __syncthreads();

  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) {
    const int32_t c = local_hist[b];
    if (c != 0) atomicAdd(&hist[row * num_buckets + b], c);
  }
}

}  // namespace

// tokens, ids: (rows, n) int32; hist: (rows, num_buckets) int32, zero-filled
// by the caller. Returns the cudaError_t of the launch.
extern "C" int hash_partition_launch(const void* tokens, void* ids, void* hist,
                                     long long rows, long long n, int num_buckets,
                                     void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)num_buckets * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hash_partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerRow) blocks = kMaxBlocksPerRow;
  dim3 grid((unsigned)blocks, (unsigned)rows);
  hash_partition_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tokens, (int32_t*)ids, (int32_t*)hist, n, num_buckets);
  return (int)cudaGetLastError();
}
