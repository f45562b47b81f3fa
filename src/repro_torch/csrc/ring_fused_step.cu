// ring_fused_step: one S3 in-transit hop on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ring_fused_step.py
// (ring_fused_step, body _kernel):
//   acc' = acc + fp32(wire),   wire' = bf16(acc'), round to nearest even.
//
// Bound on an H100, on every route: memory, 12 B an element (4 B acc and
// 2 B wire read, 4 B acc' and 2 B wire' written once) against one add and
// one conversion. The add is one fp32 add, so acc' is bitwise what PyTorch
// computes; __float2bfloat16_rn is the same rounding as
// tensor.to(torch.bfloat16).
//
// The inputs are read where they lie. The wrapper (kernels/ring_fused_step.py,
// ``plan``) folds them into (batches B, rows R, cols C), cols the last dim of
// the logical shape, and passes each tensor's element strides over the three;
// the outputs are new row-major tensors of the logical shape (pitches o_b,
// o_r, unit stride along cols). Two routes:
//
// rows (unit stride along cols in acc and wire: flat hops, row-major and
// row-strided batches). A streaming pass over (row, 4-column vector) items,
// 16-B loads and stores, one vector a thread in a grid that covers the hop
// once: the most requests in flight that the card takes. An acc that sits K
// elements past a 16-B boundary (a process-mesh chunk view at an odd offset)
// is read as the two aligned 16-B segments around each vector and shifted in
// registers: neighbouring threads share the segments in L1, so device memory
// still sees each byte once, and each segment holds an element of acc, so no
// read leaves its pages. Where a pitch or the wire or an output is off 16-B
// alignment, the same pass moves 4-B elements.
//
// tiles (unit stride along rows of acc, along cols of wire: the transposed
// chunks that scatter_gradient cuts along a leaf's later dim, dense or inside
// the wider gradient). A row-major walk would read acc 4 B in a 128-B line.
// Each block instead takes a 64 x 64 tile: acc's 64 columns of 64 rows come
// into shared memory by cp.async (4 B a thread, a warp's 128 B contiguous
// along rows), the tile's pitch odd (65) so that the column-wise writes and
// the row-wise reads both hit 32 banks; wire is read into registers along
// cols while those copies fly; both outputs are written along cols. Ragged
// tiles are masked. Each byte again moves once; what is left between this
// route and the rows route is the transposed access itself (128-B pieces of
// acc a column, 256-B and 128-B pieces of the outputs a row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows route: threads a block
constexpr int kTileR = 64;     // tiles route: a kTileR x kTileC tile a block,
constexpr int kTileC = 64;     //   rows and cols multiples of 32
constexpr int kWarps = 8;      // tiles route: blockDim (32, kWarps)
constexpr int kRowsRoute = 0;
constexpr int kTilesRoute = 1;

struct __align__(8) Bf16x4 {
  __nv_bfloat16 v[4];
};

// (batches, rows, cols) and the element strides of each tensor over them
struct Layout {
  long long B, R, C;
  long long a_b, a_r, a_c;  // acc
  long long w_b, w_r, w_c;  // wire
  long long o_b, o_r;       // both outputs; unit stride along cols
};

__device__ __forceinline__ float4 add4(float4 a, Bf16x4 w, Bf16x4* o) {
  float4 s;
  s.x = a.x + __bfloat162float(w.v[0]);
  s.y = a.y + __bfloat162float(w.v[1]);
  s.z = a.z + __bfloat162float(w.v[2]);
  s.w = a.w + __bfloat162float(w.v[3]);
  o->v[0] = __float2bfloat16_rn(s.x);
  o->v[1] = __float2bfloat16_rn(s.y);
  o->v[2] = __float2bfloat16_rn(s.z);
  o->v[3] = __float2bfloat16_rn(s.w);
  return s;
}

// acc's four elements from q + K on, q 16-B aligned: lo = q[0..3], hi = q[4..7]
template <int K>
__device__ __forceinline__ float4 shifted(const float* q) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(q));
  if (K == 0) return lo;
  const float4 hi = __ldg(reinterpret_cast<const float4*>(q + 4));
  if (K == 1) return make_float4(lo.y, lo.z, lo.w, hi.x);
  if (K == 2) return make_float4(lo.z, lo.w, hi.x, hi.y);
  return make_float4(lo.w, hi.x, hi.y, hi.z);
}

// rows route, 16-B vectors, one a thread. acc - K is 16-B aligned and
// every pitch a multiple of 4, so each row's acc sits K elements past a
// boundary; the columns past the last whole vector of a row take the
// scalar loop below.
template <int K>
__global__ void __launch_bounds__(kThreads)
    rows_vec_kernel(const float* __restrict__ acc, const __nv_bfloat16* __restrict__ wire,
                    float* __restrict__ out_acc, __nv_bfloat16* __restrict__ out_wire,
                    Layout L) {
  const long long c4 = L.C / 4;
  const long long rows = L.B * L.R;
  const long long items = rows * c4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float* acc_al = acc - K;
  for (long long v = tid; v < items; v += stride) {
    long long b = 0, r = 0, j = v;
    if (rows > 1) {
      const long long row = v / c4;
      j = v - row * c4;
      b = row / L.R;
      r = row - b * L.R;
    }
    const float4 a = shifted<K>(acc_al + b * L.a_b + r * L.a_r + 4 * j);
    const Bf16x4 w = *reinterpret_cast<const Bf16x4*>(wire + b * L.w_b + r * L.w_r + 4 * j);
    const long long o = b * L.o_b + r * L.o_r + 4 * j;
    Bf16x4 ow;
    *reinterpret_cast<float4*>(out_acc + o) = add4(a, w, &ow);
    *reinterpret_cast<Bf16x4*>(out_wire + o) = ow;
  }
  const long long tail = L.C - 4 * c4;  // 0..3 columns a row
  for (long long t = tid; t < rows * tail; t += stride) {
    const long long row = t / tail, c = 4 * c4 + (t - row * tail);
    const long long b = row / L.R, r = row - b * L.R;
    const float s =
        acc[b * L.a_b + r * L.a_r + c] + __bfloat162float(wire[b * L.w_b + r * L.w_r + c]);
    out_acc[b * L.o_b + r * L.o_r + c] = s;
    out_wire[b * L.o_b + r * L.o_r + c] = __float2bfloat16_rn(s);
  }
}

// rows route, 4-B elements, one a thread: any strides (the wrapper sends
// it only layouts with unit stride along cols, which keeps it coalesced)
__global__ void __launch_bounds__(kThreads)
    rows_scalar_kernel(const float* __restrict__ acc, const __nv_bfloat16* __restrict__ wire,
                       float* __restrict__ out_acc, __nv_bfloat16* __restrict__ out_wire,
                       Layout L) {
  const long long rows = L.B * L.R;
  const long long items = rows * L.C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < items; e += stride) {
    long long b = 0, r = 0, c = e;
    if (rows > 1) {
      const long long row = e / L.C;
      c = e - row * L.C;
      b = row / L.R;
      r = row - b * L.R;
    }
    const float s = __ldg(acc + b * L.a_b + r * L.a_r + c * L.a_c) +
                    __bfloat162float(wire[b * L.w_b + r * L.w_r + c * L.w_c]);
    const long long o = b * L.o_b + r * L.o_r + c;
    out_acc[o] = s;
    out_wire[o] = __float2bfloat16_rn(s);
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// tiles route: acc along rows into shared memory, the rest along cols
__global__ void __launch_bounds__(32 * kWarps)
    tiles_kernel(const float* __restrict__ acc, const __nv_bfloat16* __restrict__ wire,
                 float* __restrict__ out_acc, __nv_bfloat16* __restrict__ out_wire, Layout L) {
  // [col in tile][row in tile]; the odd pitch puts a column's 32 rows and a
  // row's 32 columns each on 32 banks
  __shared__ float tile[kTileC][kTileR + 1];
  const long long rt_n = (L.R + kTileR - 1) / kTileR;
  const long long ct_n = (L.C + kTileC - 1) / kTileC;
  const long long tiles = L.B * rt_n * ct_n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    // row tiles fastest: neighbouring blocks read one column's pieces in turn
    const long long rt = t % rt_n;
    const long long ct = (t / rt_n) % ct_n;
    const long long b = t / (rt_n * ct_n);
    const long long r0 = rt * kTileR, c0 = ct * kTileC;
    const float* a = acc + b * L.a_b;
#pragma unroll
    for (int k = 0; k < kTileC / kWarps; ++k) {
#pragma unroll
      for (int i = 0; i < kTileR / 32; ++i) {
        const int cl = ty + k * kWarps, rl = tx + 32 * i;
        const long long r = r0 + rl, c = c0 + cl;
        if (r < L.R && c < L.C) cp_async4(&tile[cl][rl], a + r * L.a_r + c * L.a_c);
      }
    }
    __nv_bfloat16 w[kTileR / kWarps][kTileC / 32];
#pragma unroll
    for (int k = 0; k < kTileR / kWarps; ++k) {
#pragma unroll
      for (int j = 0; j < kTileC / 32; ++j) {
        const long long r = r0 + ty + k * kWarps, c = c0 + tx + 32 * j;
        w[k][j] = (r < L.R && c < L.C) ? wire[b * L.w_b + r * L.w_r + c * L.w_c]
                                       : __float2bfloat16_rn(0.0f);
      }
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileR / kWarps; ++k) {
#pragma unroll
      for (int j = 0; j < kTileC / 32; ++j) {
        const int rl = ty + k * kWarps, cl = tx + 32 * j;
        const long long r = r0 + rl, c = c0 + cl;
        if (r < L.R && c < L.C) {
          const float s = tile[cl][rl] + __bfloat162float(w[k][j]);
          const long long o = b * L.o_b + r * L.o_r + c;
          out_acc[o] = s;
          out_wire[o] = __float2bfloat16_rn(s);
        }
      }
    }
    __syncthreads();  // the tile is refilled on the next pass
  }
}

// blocks of kThreads that cover ``items`` once, one item a thread
unsigned covering_blocks(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
}

bool aligned(const void* p, uintptr_t bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

// acc fp32 and wire bf16 over (B, R, C) with the element strides given;
// out_acc fp32 and out_wire bf16 with pitches (o_b, o_r, 1). route 0: unit
// stride along cols in acc and wire; route 1: unit stride along rows in acc
// and along cols in wire (either route is right for any strides, and fast
// for its own). Returns the cudaError_t of the launch.
extern "C" int ring_fused_step_launch(const void* acc, const void* wire, void* out_acc,
                                      void* out_wire, int route, long long B, long long R,
                                      long long C, long long a_b, long long a_r, long long a_c,
                                      long long w_b, long long w_r, long long w_c, long long o_b,
                                      long long o_r, void* stream) {
  if (B <= 0 || R <= 0 || C <= 0) return (int)cudaSuccess;
  const Layout L{B, R, C, a_b, a_r, a_c, w_b, w_r, w_c, o_b, o_r};
  const cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)acc;
  const __nv_bfloat16* w = (const __nv_bfloat16*)wire;
  float* oa = (float*)out_acc;
  __nv_bfloat16* ow = (__nv_bfloat16*)out_wire;
  if (route == kTilesRoute) {
    const long long tiles = B * ((R + kTileR - 1) / kTileR) * ((C + kTileC - 1) / kTileC);
    const long long blocks = tiles < 0x7fffffffLL ? tiles : 0x7fffffffLL;
    tiles_kernel<<<(unsigned)blocks, dim3(32, kWarps), 0, s>>>(a, w, oa, ow, L);
    return (int)cudaGetLastError();
  }
  if (route != kRowsRoute) return (int)cudaErrorInvalidValue;
  // pitches of dims longer than 1 must keep every row on the same 16-B phase
  const bool pitches = (B == 1 || (a_b % 4 == 0 && w_b % 4 == 0 && o_b % 4 == 0)) &&
                       (R == 1 || (a_r % 4 == 0 && w_r % 4 == 0 && o_r % 4 == 0));
  const bool vec = a_c == 1 && w_c == 1 && C >= 4 && pitches && aligned(acc, 4) &&
                   aligned(wire, 8) && aligned(out_acc, 16) && aligned(out_wire, 8);
  if (vec) {
    const unsigned blocks = covering_blocks(B * R * (C / 4));
    switch (((uintptr_t)acc % 16) / 4) {
      case 0: rows_vec_kernel<0><<<blocks, kThreads, 0, s>>>(a, w, oa, ow, L); break;
      case 1: rows_vec_kernel<1><<<blocks, kThreads, 0, s>>>(a, w, oa, ow, L); break;
      case 2: rows_vec_kernel<2><<<blocks, kThreads, 0, s>>>(a, w, oa, ow, L); break;
      default: rows_vec_kernel<3><<<blocks, kThreads, 0, s>>>(a, w, oa, ow, L); break;
    }
    return (int)cudaGetLastError();
  }
  rows_scalar_kernel<<<covering_blocks(B * R * C), kThreads, 0, s>>>(a, w, oa, ow, L);
  return (int)cudaGetLastError();
}
