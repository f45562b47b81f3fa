// segment_reduce: the p4mr switch REDUCER on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce.py
// (segment_reduce, body _kernel):
//   out[s] = sum over rows with ids == s of fp32(values[row]), id -1 dropped.
//
// Bound on an H100: memory, one id and one value row read per row, plus
// atomic contention on hot words (the top Zipf word is 6.4% of a word-count
// stream). The TPU kernel turns the scatter into a one-hot matmul on the
// MXU, n * nseg * d operations: at nseg = 8 * 50,000 that is absurd, so it
// is not carried over. Here one thread per (row, column) does one fp32
// atomicAdd into out, which the caller zero-fills; ids are offset by
// (row / rows_per_batch) * nseg, so one launch covers every reducer of the
// world dim. values may be a stride-0 broadcast along rows (a count of ones),
// which then costs no memory traffic. Atomics make float sums depend on the
// order; integer-valued sums are exact while every partial stays below 2^24.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void segment_reduce_kernel(const T* __restrict__ values,
                                      const int32_t* __restrict__ ids,
                                      float* __restrict__ out,
                                      long long total_rows, long long rows_per_batch,
                                      long long row_stride, int d, int num_segments) {
  const long long total = total_rows * d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long r = i / d;
    const int c = (int)(i - r * d);
    const int32_t s = ids[r];
    if (s >= 0 && s < num_segments) {
      const long long seg = (r / rows_per_batch) * num_segments + s;
      atomicAdd(&out[seg * d + c], to_f32(values[r * row_stride + c]));
    }
  }
}

template <typename T>
int launch(const void* values, const void* ids, void* out, long long total_rows,
           long long rows_per_batch, long long row_stride, int d, int num_segments,
           cudaStream_t stream) {
  const long long total = total_rows * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_reduce_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)values, (const int32_t*)ids, (float*)out, total_rows, rows_per_batch,
      row_stride, d, num_segments);
  return (int)cudaGetLastError();
}

}  // namespace

// values: rows of d elements, row r at values + r * row_stride (column stride
// 1); dtype 0 = float32, 1 = bfloat16, 2 = float16. ids: (total_rows,) int32.
// out: (total_rows / rows_per_batch * num_segments, d) float32, zero-filled.
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue for an
// unknown dtype.
extern "C" int segment_reduce_launch(const void* values, int dtype, const void* ids, void* out,
                                     long long total_rows, long long rows_per_batch,
                                     long long row_stride, int d, int num_segments,
                                     void* stream) {
  if (total_rows <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(values, ids, out, total_rows, rows_per_batch, row_stride, d,
                           num_segments, s);
    case 1:
      return launch<__nv_bfloat16>(values, ids, out, total_rows, rows_per_batch, row_stride, d,
                                   num_segments, s);
    case 2:
      return launch<__half>(values, ids, out, total_rows, rows_per_batch, row_stride, d,
                            num_segments, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
