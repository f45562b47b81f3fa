// ring_fused_step: one S3 in-transit hop on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ring_fused_step.py
// (ring_fused_step, body _kernel):
//   acc' = acc + fp32(wire),   wire' = bf16(acc'), round to nearest even.
//
// Bound on an H100: memory, 12 B an element (4 B acc and 2 B wire read,
// 4 B acc' and 2 B wire' written) against one add and one conversion.
// Design: a grid-stride elementwise pass. Where all four pointers allow it,
// each thread moves four elements at once (16 B of fp32, 8 B of bf16), so
// the loads and stores are full-width; the ragged tail and unaligned inputs
// take the scalar loop. The add is one fp32 add, so acc' is bitwise what
// PyTorch computes; __float2bfloat16_rn is the same rounding as
// tensor.to(torch.bfloat16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

struct __align__(8) Bf16x4 {
  __nv_bfloat16 v[4];
};

__global__ void ring_fused_step_kernel(const float* __restrict__ acc,
                                       const __nv_bfloat16* __restrict__ wire,
                                       float* __restrict__ out_acc,
                                       __nv_bfloat16* __restrict__ out_wire,
                                       long long n, int vectorized) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long scalar_from = 0;
  if (vectorized) {
    const long long n4 = n / 4;
    const float4* acc4 = reinterpret_cast<const float4*>(acc);
    const Bf16x4* wire4 = reinterpret_cast<const Bf16x4*>(wire);
    float4* out_acc4 = reinterpret_cast<float4*>(out_acc);
    Bf16x4* out_wire4 = reinterpret_cast<Bf16x4*>(out_wire);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = acc4[i];
      const Bf16x4 w = wire4[i];
      float4 s;
      s.x = a.x + __bfloat162float(w.v[0]);
      s.y = a.y + __bfloat162float(w.v[1]);
      s.z = a.z + __bfloat162float(w.v[2]);
      s.w = a.w + __bfloat162float(w.v[3]);
      Bf16x4 o;
      o.v[0] = __float2bfloat16_rn(s.x);
      o.v[1] = __float2bfloat16_rn(s.y);
      o.v[2] = __float2bfloat16_rn(s.z);
      o.v[3] = __float2bfloat16_rn(s.w);
      out_acc4[i] = s;
      out_wire4[i] = o;
    }
    scalar_from = n4 * 4;
  }
  for (long long i = scalar_from + tid; i < n; i += stride) {
    const float s = acc[i] + __bfloat162float(wire[i]);
    out_acc[i] = s;
    out_wire[i] = __float2bfloat16_rn(s);
  }
}

}  // namespace

// acc, out_acc: (n,) float32; wire, out_wire: (n,) bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int ring_fused_step_launch(const void* acc, const void* wire, void* out_acc,
                                      void* out_wire, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int vectorized = ((uintptr_t)acc % 16 == 0) && ((uintptr_t)out_acc % 16 == 0) &&
                         ((uintptr_t)wire % 8 == 0) && ((uintptr_t)out_wire % 8 == 0);
  const long long work = vectorized ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ring_fused_step_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)acc, (const __nv_bfloat16*)wire, (float*)out_acc,
      (__nv_bfloat16*)out_wire, n, vectorized);
  return (int)cudaGetLastError();
}
