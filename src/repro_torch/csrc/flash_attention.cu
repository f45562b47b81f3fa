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
// 268 MB, 0.080 ms at 3.35 TB/s.
//
// bf16 design (flash_tma_kernel), shaped for the tensor cores' only full-rate
// path, wgmma, fed by TMA:
//   * One block per (128-row query tile, batch x head): two consumer
//     warpgroups of 64 query rows each (wgmma takes 64 rows) and one
//     producer warp, 288 threads.
//   * The producer's lane 0 loads the q tile once and each K and V tile (128
//     keys at d 64, 64 at d 128) into a ring of 3 stages with
//     cp.async.bulk.tensor; completion goes to one "full" mbarrier per tile
//     and stage, and the consumers hand a stage back through an "empty"
//     mbarrier once both of its products are done. So the loads of the next
//     tiles run under the current tile's products and softmax, with no
//     block-wide barrier in the loop.
//   * The tensor maps describe q, k, v as the caller laid them out: rank 4
//     over (d, seq, head, batch) with byte strides, so the model's
//     (b, s, h, d) memory is read in place; query head h reads kv head
//     h / rep by its coordinate (grouped-query attention without a repeated
//     copy). TMA zero-fills rows past sq / sk, so a ragged last tile needs no
//     fill code; only its scores are masked. Boxes are 64 columns (128 bytes)
//     wide with the 128-byte swizzle, so d 128 is two column panels.
//   * S = q k^T: wgmma m64n{keys}k16 with q and K both read from shared memory
//     through descriptors (K-major, 128-byte swizzle, as TMA wrote them).
//   * O += P V: wgmma m64n{d}k16 with P from registers as the A operand (the
//     fp32 S accumulators of two key octets, rescaled and packed to bf16,
//     are exactly its fragment) and V from shared memory in its stored
//     (keys x d) layout, through wgmma's transpose of 16-bit B: no
//     transposed copy of V.
//   * Within a warpgroup, tile j's S product is issued together with tile
//     j-1's P V product, and tile j's softmax (exp2 on the multi-function
//     unit, as much time as the products at d 64) runs while P V is on the
//     tensor cores. The two warpgroups take turns to issue their products
//     (two named barriers, "ping-pong"), so one's softmax runs while the
//     other's products are on the tensor cores.
//   * Scores are scaled in fp32 (as the TPU kernel; folded into the FFMA
//     that feeds exp2); m, l and the O accumulators stay fp32. The causal
//     mask is applied only on tiles that reach past a warpgroup's first row,
//     and the key bound only on the last tile; every other tile runs
//     unmasked. With causal the kv loop stops at the diagonal tile (the TPU
//     kernel's nk_eff).
//   * Blocks are ordered so that all query tiles of one batch x head run
//     together, longest first: the blocks resident on the card share their
//     K/V tiles in L2. (One batch x head per SM at a time would read K/V from
//     device memory once per query tile, 2.2 GB at the prefill's shape.)
// P is rounded to bf16 for the P V product, where the plain version keeps it
// in fp32 (within 3e-2 of it).
//
// fp32 inputs take a separate path in full fp32 on the CUDA cores (no TF32):
// four threads share one query row, each holding a quarter of its dims; it
// reads q, k, v and o through (batch, head, seq) strides with unit stride
// along d.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // fp32 kernel

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
// bf16: TMA loads, mbarrier pipeline, wgmma
// ---------------------------------------------------------------------------
constexpr int kWGs = 2;             // consumer warpgroups of 64 query rows each
// one 8-key chunk of scores in this many takes ex2_fma, the rest the
// multi-function unit
constexpr int kPolyEvery = 3;
constexpr int kBM = 64 * kWGs;      // query rows per block
constexpr int kPanel = 64;          // bf16 columns per 128-byte swizzled panel
constexpr int kConsumers = 128 * kWGs;
constexpr int kTmaThreads = kConsumers + 32;  // and one producer warp

template <int D>
struct Tiles {
  // keys per K/V tile: 128 at d 64; 64 at d 128, where 128 would leave the
  // consumers too few registers for S, P and O together
  static constexpr int kBN = D == 64 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // one K or one V tile
  // q, then K and V of every stage, each a run of 1024-byte-aligned panels;
  // then the mbarriers: q full, K full[stages], V full[stages], empty[stages]
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A wait
// that has not completed after 2^25 polls (seconds; a legitimate one takes
// microseconds) traps, so a broken pipeline fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 25)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a rank-4 (d, seq, head, batch) tensor map into shared memory.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major operands
// (q, K) step 8 rows by sbo = 1024 bytes; the MN-major V steps 8 keys by sbo
// and 64 columns of d (one panel) by lbo.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Named barrier 1 + w between consumer warpgroup w, which syncs, and the
// one before it, which arrives (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie accumulator registers to this point, so the compiler moves no read or
// write of them across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for A fragments in registers: live until here, so the compiler
// reuses none of them while an issued wgmma may still read them.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the multi-function unit, flushing denormal results to zero: one
// instruction (exp2f adds a range fix-up around the same instruction).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x for x <= 0 on the FMA pipe, for the share of the softmax's exponentials
// that the multi-function unit, the softmax's bottleneck, does not take:
// x = n + f with n an integer and f in [-0.5, 0.5] (the 1.5 * 2^23 rounding
// trick), 2^f by a degree-3 polynomial (relative error 7.5e-5, below the
// bf16 rounding of P, 2^-9), and n added to the exponent bits. x is clamped
// at -126, so the exponent stays in range; 2^-126 is far below anything a
// row sum of P resolves.
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float j = x + 12582912.f;
  const float f = x - (j - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05517092f, f, 0.24260956f), f, 0.69326097f), f, 0.99992818f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(j) << 23));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D(64 x 128, fp32) (+)= A(64 x 16) B(16 x 128), A and B bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64, fp32) (+)= A(64 x 16) B(16 x 64), A and B bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64, fp32) += A(64 x 16) B(16 x 64): A bf16 in registers, B bf16 in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, fp32) += A(64 x 16) B(16 x 128): A bf16 in registers, B bf16 in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2], uint64_t dq, uint64_t dk, int acc) {
  if constexpr (BN == 64) {
    wgmma_ss_n64(s, dq, dk, acc);
  } else {
    wgmma_ss_n128(s, dq, dk, acc);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t dv) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, p, dv);
  } else {
    wgmma_rs_n128(o, p, dv);
  }
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_tma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const Args a) {
  using T = Tiles<D>;
  constexpr int S = T::kStages, BN = T::kBN;
  constexpr int kPanelQ = kBM * 128, kPanelKV = BN * 128;  // bytes of one 64-column panel
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = raw + ((1024 - (raw & 1023)) & 1023);  // swizzle atoms need 1024-byte alignment
  const uint32_t bars = qs + T::kBarOffset;
  const uint32_t q_full = bars;
  auto k_tile = [&](int st) { return qs + T::kQBytes + st * 2 * T::kKVBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + T::kKVBytes; };
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + S + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * S + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // blocks in launch order: every query tile of one batch x head before the
  // next, so the blocks resident at one time share their K/V tiles in L2
  // (one (b, h) at a time across the card would re-read K/V from device
  // memory once per query tile); with causal the longest tile of each
  // (b, h) first
  const int nq = (a.sq + kBM - 1) / kBM;
  const int bh = (int)(blockIdx.x / nq), qi = (int)(blockIdx.x % nq);
  const int qt = a.causal ? nq - 1 - qi : qi;
  const int b = bh / a.heads, h = bh % a.heads, hk = h / a.rep;
  const int q0 = qt * kBM;
  const int nk = kv_tiles(a, q0, kBM, BN);

  if (warp == kConsumers / 32) {  // producer warp: one thread issues every load
    if (lane == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p) tma_load4(qs + p * kPanelQ, &mq, q_full, p * kPanel, q0, h, b);
      for (int j = 0; j < nk; ++j) {
        const int st = j % S;
        if (j >= S) mbar_wait(empty(st), ((j / S) - 1) & 1);  // both warpgroups are done with it
        mbar_expect_tx(k_full(st), T::kKVBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load4(k_tile(st) + p * kPanelKV, &mk, k_full(st), p * kPanel, j * BN, hk, b);
        mbar_expect_tx(v_full(st), T::kKVBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load4(v_tile(st) + p * kPanelKV, &mv, v_full(st), p * kPanel, j * BN, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [row0, row0 + 64); this thread
  // holds rows row_a and row_b = row_a + 8 of its warp's 16, columns
  // 8c + 2t and 8c + 2t + 1 of every 8-column chunk c (the wgmma accumulator
  // layout). Tile j's S = q K_j^T is issued together with tile j-1's
  // O += P V_{j-1}, and tile j's softmax runs while the P V product is on
  // the tensor cores.
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * 64;
  const int row_a = row0 + (warp % 4) * 16 + g, row_b = row_a + 8;
  const uint32_t q_wg = qs + wg * 64 * 128;
  const float scale = a.scale * kLog2e;  // scores in log2 units: exp2 below
  float o[D / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  uint32_t p[BN / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

  // turns: warpgroup wg issues after syncing on barrier 1 + wg, then lets
  // the next one go; warpgroup 0 goes first
  const int my_turn = 1 + wg, their_turn = 1 + (wg + 1) % kWGs;
  if (wg == kWGs - 1) named_arrive(1);
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns of d a step, 4 steps a panel
      const uint32_t off = (kk / 4) * kPanelQ + (kk % 4) * 32;
      wgmma_qk<BN>(s, desc_sw128(q_wg + off, 16, 1024),
                    desc_sw128(k_tile(st) + (kk / 4) * kPanelKV + (kk % 4) * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys a step: 2 swizzle atoms of 8 rows
      wgmma_pv<D>(o, p[kk], desc_sw128(v_tile(st) + kk * 16 * 128, kPanelKV, 1024));
    wgmma_commit();
  };
  auto softmax = [&](int j) {  // s: raw scores of tile j -> unnormalised p
    const int k0 = j * BN;
    if (k0 + BN > a.sk || (a.causal && k0 + BN - 1 > row0)) {  // last or diagonal tile
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + c * 8 + t * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (key >= a.sk || (a.causal && key > row)) s[4 * c + e] = kNegInf;
        }
      }
    }
    // row max and row sum over four independent partials each (short
    // dependency chains: two warps a scheduler hide little latency)
    float mp[2][4], rp[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mp[0][i] = fmaxf(s[4 * i], s[4 * i + 1]);
      mp[1][i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
    }
#pragma unroll
    for (int c = 4; c < BN / 8; ++c) {
      mp[0][c & 3] = fmaxf(mp[0][c & 3], fmaxf(s[4 * c], s[4 * c + 1]));
      mp[1][c & 3] = fmaxf(mp[1][c & 3], fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's scores live in the 4 threads of a quad
      float mx = fmaxf(fmaxf(m[i], fmaxf(mp[i][0], mp[i][1])), fmaxf(mp[i][2], mp[i][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = ex2((m[i] - mx) * scale);
      m[i] = mx;
    }
    // exp2(s * scale - m * scale): the fp32 scaling folded into one FFMA
    const float ms[2] = {m[0] * scale, m[1] * scale};
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[4 * c + e], scale, -ms[e >> 1]);
        s[4 * c + e] = (c % kPolyEvery == kPolyEvery - 1) ? ex2_fma(x) : ex2(x);
        if (c < 4) {
          rp[e >> 1][c] = (e & 1) ? rp[e >> 1][c] + s[4 * c + e] : s[4 * c + e];
        } else {
          rp[e >> 1][c & 3] += s[4 * c + e];
        }
      }
    }
    const float rs[2] = {(rp[0][0] + rp[0][1]) + (rp[0][2] + rp[0][3]),
                         (rp[1][0] + rp[1][1]) + (rp[1][2] + rp[1][3])};
    l[0] = l[0] * alpha[0] + rs[0];  // this thread's part of the row sum
    l[1] = l[1] * alpha[1] + rs[1];
  };
  auto pack_p = [&]() {  // P as wgmma A fragments: 16 keys (two accumulator chunks) each
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      p[kk][0] = pack_f32(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_qk(0);
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  pack_p();
  for (int j = 1; j < nk; ++j) {
    const int st = j % S, prev = (j - 1) % S;
    mbar_wait(k_full(st), (j / S) & 1);
    mbar_wait(v_full(prev), ((j - 1) / S) & 1);
    fence_regs(o);
    fence_frags(p);
    named_sync(my_turn);
    wgmma_fence();
    issue_qk(st);
    issue_pv(prev);
    named_arrive(their_turn);
    wgmma_wait<1>();  // S_j is in; P V_{j-1} may still run
    fence_regs(s);
    softmax(j);
    fence_regs(s);  // keeps the compiler from sinking the softmax below the wait
    fence_regs(l);
    wgmma_wait<0>();
    fence_regs(o);
    fence_frags(p);  // the P V product has read p: it may be overwritten now
    if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[4 * c] *= alpha[0];
      o[4 * c + 1] *= alpha[0];
      o[4 * c + 2] *= alpha[1];
      o[4 * c + 3] *= alpha[1];
    }
    pack_p();
  }
  const int last = (nk - 1) % S;
  mbar_wait(v_full(last), ((nk - 1) / S) & 1);
  fence_regs(o);
  fence_frags(p);
  named_sync(my_turn);
  wgmma_fence();
  issue_pv(last);
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs(o);
  if (wg == 0) named_sync(my_turn);  // the last warpgroup's last arrival: all barriers end empty

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv_a = 1.f / fmaxf(l[0], 1e-30f), inv_b = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* ob = (__nv_bfloat16*)a.o + b * a.osb + h * a.osh;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + t * 2;
    if (row_a < a.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_a * a.oss + col) =
          pack_f32(o[4 * c] * inv_a, o[4 * c + 1] * inv_a);
    if (row_b < a.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_b * a.oss + col) =
          pack_f32(o[4 * c + 2] * inv_b, o[4 * c + 3] * inv_b);
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
int launch_f32(const Args& a, int bh, cudaStream_t s) {
  const dim3 grid((unsigned)bh, (unsigned)((a.sq + kThreads / 4 - 1) / (kThreads / 4)));
  flash_f32_kernel<D><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// A rank-4 (d, seq, head, batch) bf16 tensor map with the caller's element
// strides, boxes of 64 columns x `rows` rows, 128-byte swizzle; rows past
// `seq` read as zeros. A dimension of size 1 gets a stride TMA takes (it is
// never stepped). Returns the CUresult.
int encode_map(CUtensorMap* map, const void* base, int d, int seq, int heads, int batch,
               long long ss, long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const long long st[3] = {ss, sh, sb};
  const int n[3] = {seq, heads, batch};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)(n[i] > 1 ? st[i] : d) * 2;
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return (int)cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                                     dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch_bf16(const Args& a, int batch, int kv_heads, int bh, cudaStream_t s) {
  using T = Tiles<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  int r = encode_map(&mq, a.q, D, a.sq, a.heads, batch, a.qss, a.qsh, a.qsb, kBM);
  if (r == 0) r = encode_map(&mk, a.k, D, a.sk, kv_heads, batch, a.kss, a.ksh, a.ksb, T::kBN);
  if (r == 0) r = encode_map(&mv, a.v, D, a.sk, kv_heads, batch, a.vss, a.vsh, a.vsb, T::kBN);
  if (r != 0) return -r;
  const long long blocks = (long long)bh * ((a.sq + kBM - 1) / kBM);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  flash_tma_kernel<D><<<(unsigned)blocks, kTmaThreads, T::kSmem, s>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (batch, heads, sq, d), k/v (batch, heads / rep, sk, d), o (batch, heads,
// sq, d), each addressed through its (batch, head, seq) element strides with
// unit stride along d. dtype 0 = float32, 1 = bfloat16 (q, k, v and o share
// it); d is 64 or 128; causal needs sq == sk. For bfloat16 (TMA), q, k and v
// start 16-byte aligned and every stride of a dimension longer than 1 is a
// positive multiple of 8 elements. Returns the cudaError_t of the launch,
// cudaErrorInvalidValue for an argument the kernels do not take, or minus the
// CUresult of cuTensorMapEncodeTiled where it refuses a tensor's layout.
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
  if (dtype == 1 && d == 64) return launch_bf16<64>(a, batch, kv_heads, bh, s);
  if (dtype == 1 && d == 128) return launch_bf16<128>(a, batch, kv_heads, bh, s);
  if (dtype == 0 && d == 64) return launch_f32<64>(a, bh, s);
  if (dtype == 0 && d == 128) return launch_f32<128>(a, bh, s);
  return (int)cudaErrorInvalidValue;
}
