// segment_reduce: the p4mr switch REDUCER on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce.py
// (segment_reduce, body _kernel):
//   out[s] = sum over rows with ids == s of fp32(values[row]), ids outside
//   [0, num_segments) dropped.
//
// Bound on an H100: memory, one id and one value row read per row, and the
// output written once. The TPU kernel turns the scatter into a one-hot
// matmul on the MXU, n * nseg * d operations: at nseg = 8 * 50,000 that is
// absurd, so it is not carried over. What stands in its way here is the
// scatter's contention: Zipf words collide on one address, and on the token
// path one reducer receives every copy of a hot word (the top word is 6.4%
// of the stream). So the partial sums stay on chip:
//
// Shared-memory branch (the main paths: 50,000 segments, d 1, a stride-0
// broadcast of ones): each block takes one reducer (leading row) and a
// contiguous chunk of its ids, about one block per SM in all, and keeps a
// private histogram of all that reducer's segments in shared memory. It
//   1. zeroes its bins,
//   2. streams its ids with 16-byte loads (a scalar head up to the first
//      16-byte boundary and a scalar tail), and adds to the bins with shared
//      atomics; within a warp equal ids are aggregated first
//      (__match_any_sync: the lowest lane adds the count), so a hot word
//      costs one shared atomic per warp, not 32,
//   3. flushes each non-zero bin to out with one global fp32 atomicAdd per
//      column.
// Values that are a stride-0 broadcast along rows (a count) are counted in
// uint32 bins, num_segments * 4 bytes, and each bin is flushed as
// count * value: for a count of ones the sums are then exact, bitwise equal
// to sequential fp32 sums while every total stays below 2^24. Other values
// are summed in fp32 bins, num_segments * d * 4 bytes, and such sums depend
// on the order of the atomics.
//
// Global branch: where the bins do not fit in one block's shared memory
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 B on an H100: 58,112
// count bins or 58,112 / d fp32 bins), or for more than 65,535 reducers,
// one thread per (row, column) does one fp32 atomicAdd into out.
//
// out is zero-filled by the caller; ids are offset by
// (row / rows_per_batch) * nseg, so one launch covers every reducer.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;            // global branch
constexpr long long kMaxBlocks = 132LL * 32;
constexpr int kSmemThreads = 1024;       // shared-memory branch: one block an SM
constexpr long long kMinChunk = 4096;    // ids a block takes at least

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// ---------------------------------------------------------------------------
// global branch
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// shared-memory branch
// ---------------------------------------------------------------------------
// Rows [lo, hi) of block (chunk blockIdx.x, reducer blockIdx.y).
__device__ __forceinline__ void block_rows(long long rows_per_batch, long long chunk,
                                           long long* lo, long long* hi) {
  const long long r0 = (long long)blockIdx.y * rows_per_batch;
  *lo = r0 + (long long)blockIdx.x * chunk;
  *hi = min(*lo + chunk, r0 + rows_per_batch);
}

__device__ __forceinline__ void count_one(uint32_t* bins, int32_t id, int nseg) {
  if (id >= 0 && id < nseg) atomicAdd(&bins[id], 1u);
}

// Every lane of the warp calls this together (lanes without an id pass -1).
__device__ __forceinline__ void count_aggregated(uint32_t* bins, int32_t id, int nseg, int lane) {
  const bool ok = id >= 0 && id < nseg;
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? id : -1);
  if (ok && lane == __ffs(peers) - 1) atomicAdd(&bins[id], (uint32_t)__popc(peers));
}

// Counts of a stride-0 broadcast value row: uint32 bins, flushed as
// count * value per column.
template <typename T>
__global__ void __launch_bounds__(kSmemThreads)
    segment_count_smem(const T* __restrict__ values, const int32_t* __restrict__ ids,
                       float* __restrict__ out, long long rows_per_batch, long long chunk, int d,
                       int nseg) {
  extern __shared__ uint32_t bins[];
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  long long lo, hi;
  block_rows(rows_per_batch, chunk, &lo, &hi);
  if (lo < hi) {
    // scalar head up to the first 16-byte boundary, int4 body, scalar tail
    const long long head_end =
        min(hi, lo + (long long)(((16 - ((uintptr_t)(ids + lo) & 15)) & 15) / 4));
    const long long nvec = (hi - head_end) / 4;
    const long long tail = head_end + nvec * 4;
    for (long long i = lo + threadIdx.x; i < head_end; i += blockDim.x) count_one(bins, ids[i], nseg);
    for (long long i = tail + threadIdx.x; i < hi; i += blockDim.x) count_one(bins, ids[i], nseg);
    const int4* vec = reinterpret_cast<const int4*>(ids + head_end);
    const int lane = threadIdx.x & 31;
    const long long step = (long long)blockDim.x;
    const int4 none = make_int4(-1, -1, -1, -1);
    // two 16-byte loads in flight a thread; v0 is the same for the whole
    // warp, so its lanes stay converged
    for (long long v0 = threadIdx.x - lane; v0 < nvec; v0 += 2 * step) {
      const long long vi = v0 + lane, vj = vi + step;
      const int4 x = vi < nvec ? __ldg(vec + vi) : none;
      const int4 y = vj < nvec ? __ldg(vec + vj) : none;
      count_aggregated(bins, x.x, nseg, lane);
      count_aggregated(bins, x.y, nseg, lane);
      count_aggregated(bins, x.z, nseg, lane);
      count_aggregated(bins, x.w, nseg, lane);
      count_aggregated(bins, y.x, nseg, lane);
      count_aggregated(bins, y.y, nseg, lane);
      count_aggregated(bins, y.z, nseg, lane);
      count_aggregated(bins, y.w, nseg, lane);
    }
  }
  __syncthreads();
  float* dst = out + (long long)blockIdx.y * nseg * d;
  for (int s = threadIdx.x; s < nseg; s += blockDim.x) {
    const uint32_t c = bins[s];
    if (c == 0) continue;
    for (int col = 0; col < d; ++col) atomicAdd(&dst[(long long)s * d + col], (float)c * to_f32(values[col]));
  }
}

// Sums of value rows: fp32 bins of nseg * d.
template <typename T>
__global__ void __launch_bounds__(kSmemThreads)
    segment_sum_smem(const T* __restrict__ values, const int32_t* __restrict__ ids,
                     float* __restrict__ out, long long rows_per_batch, long long chunk,
                     long long row_stride, int d, int nseg) {
  extern __shared__ float fbins[];
  const int nbins = nseg * d;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) fbins[i] = 0.f;
  __syncthreads();
  long long lo, hi;
  block_rows(rows_per_batch, chunk, &lo, &hi);
  const long long total = hi > lo ? (hi - lo) * d : 0;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const long long r = lo + i / d;
    const int c = (int)(i % d);
    const int32_t s = ids[r];
    if (s >= 0 && s < nseg) atomicAdd(&fbins[s * d + c], to_f32(values[r * row_stride + c]));
  }
  __syncthreads();
  float* dst = out + (long long)blockIdx.y * nbins;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const float v = fbins[i];
    if (v != 0.f) atomicAdd(&dst[i], v);
  }
}

int max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <typename T>
int launch(const void* values, const void* ids, void* out, long long total_rows,
           long long rows_per_batch, long long row_stride, int d, int num_segments,
           cudaStream_t stream) {
  const long long reducers = total_rows / rows_per_batch;
  const bool count = row_stride == 0;
  const long long bin_bytes = (long long)num_segments * (count ? 1 : d) * 4;
  if (bin_bytes <= max_smem_bytes() && reducers <= 65535) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // one block an SM at most (the bins take most of an SM's shared memory),
    // so all blocks run in one wave
    long long chunks = sms / reducers;
    chunks = std::max(1LL, std::min(chunks, (rows_per_batch + kMinChunk - 1) / kMinChunk));
    const long long chunk = ((rows_per_batch + chunks - 1) / chunks + 3) / 4 * 4;
    chunks = (rows_per_batch + chunk - 1) / chunk;
    const dim3 grid((unsigned)chunks, (unsigned)reducers);
    const int smem = (int)bin_bytes;
    cudaError_t e;
    if (count) {
      e = cudaFuncSetAttribute(segment_count_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      segment_count_smem<T><<<grid, kSmemThreads, smem, stream>>>(
          (const T*)values, (const int32_t*)ids, (float*)out, rows_per_batch, chunk, d,
          num_segments);
    } else {
      e = cudaFuncSetAttribute(segment_sum_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      segment_sum_smem<T><<<grid, kSmemThreads, smem, stream>>>(
          (const T*)values, (const int32_t*)ids, (float*)out, rows_per_batch, chunk, row_stride,
          d, num_segments);
    }
    return (int)cudaGetLastError();
  }
  const long long total = total_rows * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_reduce_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)values, (const int32_t*)ids, (float*)out, total_rows, rows_per_batch,
      row_stride, d, num_segments);
  return (int)cudaGetLastError();
}

}  // namespace

// The most bytes of bins the shared-memory branch takes on the current
// device: num_segments * 4 for a stride-0 (count) value row, else
// num_segments * d * 4; larger shapes take the global branch.
extern "C" int segment_reduce_max_bin_bytes() { return max_smem_bytes(); }

// values: rows of d elements, row r at values + r * row_stride (column stride
// 1; row_stride 0 is a broadcast, counted); dtype 0 = float32, 1 = bfloat16,
// 2 = float16. ids: (total_rows,) int32. out: (total_rows / rows_per_batch *
// num_segments, d) float32, zero-filled. Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for an unknown dtype.
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
