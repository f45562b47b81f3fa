// flash_attention: online-softmax block attention on Hopper, the LM stack's
// prefill attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:79
// (flash_attention, body _kernel at :21):
//   o = softmax(q k^T / sqrt(d) [+ causal mask kpos <= qpos]) v
// with running (m, l, acc) statistics in fp32 per query row, so the
// (sq x sk) score matrix never exists in device memory.
//
// Bound on an H100 at the main shape (b 8, h 16, s 4096, d 64, bf16,
// causal): operations. 4 d FLOPs per (q, k) pair inside the causal
// triangle, 275 GFLOP, is 0.278 ms on the bf16 tensor cores (989 TFLOP/s
// dense, H100 SXM data sheet); reading q, k, v and writing o once is
// 268 MB, 0.080 ms at 3.35 TB/s. What the design does about that: the two
// products of every tile run on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulate); q stays in registers for the whole kv loop; the
// next K tile is fetched with cp.async while the softmax and the P V
// product of the current one run; with causal the kv loop stops at the
// diagonal tile (the TPU kernel's nk_eff) and the longest query tiles are
// scheduled first. Faster forms (wgmma, TMA, warp specialisation) are
// later work.
//
// The Pallas kernel holds all of K/V for one (batch, head) in VMEM; a
// Hopper block has at most 227 KB of shared memory, so here one block per
// (query tile, batch x head) loops over K/V tiles staged through shared
// memory, and that loop replaces the TPU kernel's sequential grid
// dimension. Ragged last tiles are masked (zero-filled loads, scores of
// keys past sk set to -1e30), so any sequence length works.
//
// bf16 inputs: S = q k^T accumulates in fp32 and is scaled in fp32 (as the
// TPU kernel does); P is rounded to bf16 for the P V product, where the
// plain version keeps it in fp32 (within 3e-2 of it). fp32 inputs take a
// separate path in full fp32 on the CUDA cores (no TF32): four threads
// share one query row, each holding a quarter of its dims.
//
// q, k, v and o are read and written through (batch, head, seq) strides
// with unit stride along d, so the model's (b, s, h, d) layout needs no
// transposed copy; query head h reads kv head h / rep (grouped-query
// attention without a repeated copy of k and v).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, rep, sq, sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int causal;
  float scale;
};

// Number of kv tiles a query tile [q0, q0 + bm) needs: all of them, or with
// causal (sq == sk) those up to the diagonal.
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int bm, int bn) {
  const int nk = (a.sk + bn - 1) / bn;
  if (!a.causal) return nk;
  const int last_row = min(q0 + bm, a.sq) - 1;
  return min(nk, last_row / bn + 1);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), 4 warps x 16 query rows
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 in shared memory (element col in the low half).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from different rows, packed low = lo.
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy rows [row0, row0 + ROWS) of a (seq, D) slab with row stride ss into
// shared memory (row pitch LD), zero-filling rows at or past nrows.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int row0, int nrows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(dst + r * LD + cc * 8, src + (ok ? (long long)gr * ss : 0LL) + cc * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(Args a) {
  constexpr int BM = 64, BN = 64, LD = D + 8;  // +8: conflict-free fragment reads
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * LD];

  const int bh = blockIdx.x;
  const int qt = a.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads, hk = h / a.rep;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)a.q + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)a.k + b * a.ksb + hk * a.ksh;
  const __nv_bfloat16* vb = (const __nv_bfloat16*)a.v + b * a.vsb + hk * a.vsh;
  __nv_bfloat16* ob = (__nv_bfloat16*)a.o + b * a.osb + h * a.osh;
  const int q0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8

  // q tile, staged through Ks, kept in registers as mma A fragments
  load_tile<D, BM, LD>(Ks, qb, a.qss, q0, a.sq);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = Ks + kk * 16 + tig * 2;
    qf[kk][0] = ld_pair(p + r0 * LD);
    qf[kk][1] = ld_pair(p + (r0 + 8) * LD);
    qf[kk][2] = ld_pair(p + r0 * LD + 8);
    qf[kk][3] = ld_pair(p + (r0 + 8) * LD + 8);
  }
  __syncthreads();

  const int nk = kv_tiles(a, q0, BM, BN);
  const float scale = a.scale * kLog2e;  // scores in log2 units: exp2 below
  const int row_a = q0 + r0, row_b = row_a + 8;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  load_tile<D, BN, LD>(Ks, kb, a.kss, 0, a.sk);
  cp_async_commit();
  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    __syncthreads();  // K_j landed; every warp is done with V_{j-1}
    load_tile<D, BN, LD>(Vs, vb, a.vss, j * BN, a.sk);
    cp_async_commit();

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* p = Ks + (nt * 8 + g) * LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t bf[2] = {ld_pair(p + kk * 16), ld_pair(p + kk * 16 + 8)};
        mma_16816(s[nt], qf[kk], bf);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * BN + nt * 8 + tig * 2 + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        const bool ok = key < a.sk && (!a.causal || key <= row);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 64 scores live in the 4 threads of a quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m[0]);
      s[nt][1] = exp2f(s[nt][1] - m[0]);
      s[nt][2] = exp2f(s[nt][2] - m[1]);
      s[nt][3] = exp2f(s[nt][3] - m[1]);
      rs[0] += s[nt][0] + s[nt][1];
      rs[1] += s[nt][2] + s[nt][3];
    }
    l[0] = l[0] * alpha[0] + rs[0];  // this thread's part of the row sum
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    cp_async_wait_all();
    __syncthreads();  // V_j landed; every warp is done with K_j
    if (j + 1 < nk) load_tile<D, BN, LD>(Ks, kb, a.kss, (j + 1) * BN, a.sk);
    cp_async_commit();

    // O += P V: the S accumulators of two key octets form one A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* p = Vs + (kk * 16 + tig * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* c = p + dt * 8;
        const uint32_t bf[2] = {pack(c[0], c[LD]), pack(c[8 * LD], c[9 * LD])};
        mma_16816(acc[dt], pa, bf);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv_a = 1.f / fmaxf(l[0], 1e-30f), inv_b = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (row_a < a.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_a * a.oss + col) =
          pack_f32(acc[dt][0] * inv_a, acc[dt][1] * inv_a);
    if (row_b < a.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_b * a.oss + col) =
          pack_f32(acc[dt][2] * inv_b, acc[dt][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, full fp32; 32 query rows a block, 4 threads a row
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Args a) {
  constexpr int BM = kThreads / 4, BN = 32, DP = D / 4;
  __shared__ float Ks[BN][D];
  __shared__ float Vs[BN][D];

  const int bh = blockIdx.x;
  const int qt = a.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads, hk = h / a.rep;
  const float* qb = (const float*)a.q + b * a.qsb + h * a.qsh;
  const float* kb = (const float*)a.k + b * a.ksb + hk * a.ksh;
  const float* vb = (const float*)a.v + b * a.vsb + hk * a.vsh;
  float* ob = (float*)a.o + b * a.osb + h * a.osh;
  const int q0 = qt * BM;
  const int sub = threadIdx.x & 3;  // dims sub, sub + 4, ...: consecutive words in a quad
  const int row = q0 + (threadIdx.x >> 2);
  const bool row_ok = row < a.sq;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row_ok ? qb[(long long)row * a.qss + sub + 4 * i] * a.scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int nk = kv_tiles(a, q0, BM, BN);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BN * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int kr = j * BN + r;
      const bool ok = kr < a.sk;
      Ks[r][c] = ok ? kb[(long long)kr * a.kss + c] : 0.f;
      Vs[r][c] = ok ? vb[(long long)kr * a.vss + c] : 0.f;
    }
    __syncthreads();
    float s[BN];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < BN; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part = fmaf(qr[i], Ks[jj][sub + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = j * BN + jj;
      s[jj] = (key < a.sk && (!a.causal || key <= row)) ? part : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < BN; ++jj) {
      s[jj] = expf(s[jj] - m);
      rs += s[jj];
    }
    l = l * alpha + rs;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      float x = acc[i] * alpha;
#pragma unroll
      for (int jj = 0; jj < BN; ++jj) x = fmaf(s[jj], Vs[jj][sub + 4 * i], x);
      acc[i] = x;
    }
  }
  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i) ob[(long long)row * a.oss + sub + 4 * i] = acc[i] * inv;
  }
}

template <int D>
int launch_bf16(const Args& a, int bh, cudaStream_t s) {
  const dim3 grid((unsigned)bh, (unsigned)((a.sq + 63) / 64));
  flash_bf16_kernel<D><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, int bh, cudaStream_t s) {
  const dim3 grid((unsigned)bh, (unsigned)((a.sq + kThreads / 4 - 1) / (kThreads / 4)));
  flash_f32_kernel<D><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (batch, heads, sq, d), k/v (batch, heads / rep, sk, d), o (batch, heads,
// sq, d), each addressed through its (batch, head, seq) element strides with
// unit stride along d. dtype 0 = float32, 1 = bfloat16 (q, k, v and o share
// it); d is 64 or 128; causal needs sq == sk. For bfloat16, every seq stride
// is a multiple of 8 elements and every row 16-byte aligned (cp.async).
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue for an
// argument the kernels do not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int batch, int heads, int kv_heads, int sq,
                                      int sk, int d, long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss, long long vsb,
                                      long long vsh, long long vss, long long osb, long long osh,
                                      long long oss, int causal, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0) return (int)cudaSuccess;
  if (sk <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || (causal && sq != sk))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, heads, heads / kv_heads, sq, sk, qsb, qsh, qss, ksb, ksh, kss,
         vsb, vsh, vss, osb, osh, oss, causal, scale};
  const int bh = batch * heads;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && d == 64) return launch_bf16<64>(a, bh, s);
  if (dtype == 1 && d == 128) return launch_bf16<128>(a, bh, s);
  if (dtype == 0 && d == 64) return launch_f32<64>(a, bh, s);
  if (dtype == 0 && d == 128) return launch_f32<128>(a, bh, s);
  return (int)cudaErrorInvalidValue;
}
