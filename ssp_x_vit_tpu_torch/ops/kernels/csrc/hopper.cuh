// Hopper (sm_90a) building blocks of the wgmma + TMA pipelines:
// csrc/qgemm_tile.cuh (the dequant GEMM tiles) and the bf16 kernels of
// csrc/flash_attention.cu, csrc/flash_attention_bwd.cu, csrc/gemm.cu,
// csrc/attention.cu and csrc/quant_fused_mlp.cu, and the bulk copies of
// csrc/paged_attention.cu.
//
//   - shared-memory addresses, the 128-byte swizzle as TMA writes it;
//   - mbarriers: init, arrive, arrive with an expected byte count, and a
//     wait that traps after ~2^35 cycles (~18 s) instead of hanging the card;
//   - TMA tile loads (2D and 3D) and plain bulk copies of contiguous bytes
//     that complete on an mbarrier;
//   - the 4 x 4 exchange of 32-bit values within a quad (16-byte stores
//     and loads of an accumulator's rows);
//   - wgmma: fence / commit / wait, shared-memory descriptors (K-major, and
//     MN-major for a B operand read transposed), the products
//     m64nNk16 bf16 -> fp32 with A in registers (wgmma_rs, N = 16..256) or in
//     shared memory (wgmma_ss, N = 32 and 64; N = 128 and 256 with B K- or
//     MN-major);
//   - on the host: cuTensorMapEncodeTiled looked up from the driver (no
//     -lcuda link), 2D and 3D tensor maps with a 128-byte swizzle, and the
//     launch-register check that setmaxnreg needs.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace ssp {
namespace hopper {
// Internal linkage: each library that includes this header owns its copies
// (a static of a function with external linkage would be one object across
// every loaded library, and the second library would skip its own set-up).
namespace {

constexpr long long WAIT_LIMIT_CYCLES = 1LL << 35;  // ~18 s: a stuck pipeline traps, never hangs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, byte col) in a tile of 128-byte rows, 128-byte swizzled
// as TMA writes it (16-byte chunk index XOR row % 8; tiles are 1024-aligned).
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 4) ^ (row & 7)) << 4) | (col & 15));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait for the completion of the barrier's phase with this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > WAIT_LIMIT_CYCLES)
      __trap();
  }
}

// Shared-memory writes of the generic proxy (element loads) become visible
// to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2D TMA load of the box at (c0 inner, c1 outer) into dst; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// 3D TMA load of the box at (c0, c1, c2), innermost first; completes on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Bulk copy of `bytes` contiguous bytes (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory; completes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator register across
// the wgmma fences and waits around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a K-major bf16 tile of 128-byte rows, 128-byte
// swizzle: 8-row groups 1024 bytes apart. Advancing K by 16 inside the
// swizzle atom adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Descriptor of an MN-major (transposed) B operand, 128-byte swizzle: the
// tile is stored as K rows of 128 bytes (64 values of N), boxes of 64 N
// values `box_bytes` apart (the leading byte offset), 8-row K groups 1024
// bytes apart (the stride byte offset). Advancing K by 16 adds 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t box_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((box_bytes >> 4) & 0x3FFF) << 16) | (64ull << 32) | (1ull << 62);
}

// bf16x2 of (lo, hi), round to nearest even: one A-fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; -inf gives +0), as exp2f would
// with its range handling left out.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the four threads of a quad (the threads that hold one
// accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage rows [row0, row0 + ROWS) of matrix `mat` of a [mats, s, hd] bf16
// tensor into HDP / 64 boxes of [ROWS][128 bytes], 128-byte swizzled as TMA
// writes them, zeros past s and hd: element loads by NTHREADS threads
// (threadIdx.x < NTHREADS), for shapes TMA cannot take. Neighbouring threads
// take neighbouring columns and walk rows, four loads in flight, so few
// registers stay live (the producer warpgroup runs on a small budget). The caller makes the
// writes visible to wgmma (fence_proxy_async) before it signals the stage.
template <int ROWS, int HDP, int NTHREADS>
__device__ __forceinline__ void fill_rows(const void* src, unsigned char* dst, int mat, int row0,
                                          int s, int hd) {
  constexpr int LANES = NTHREADS < HDP ? NTHREADS : HDP;  // threads along a row
  constexpr int STEP = NTHREADS / LANES;                  // rows in flight
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src) + (size_t)mat * s * hd;
  const int r0 = threadIdx.x / LANES, rows = min(ROWS, s - row0);
#pragma unroll
  for (int j = 0; j < HDP / LANES; ++j) {
    const int c = threadIdx.x % LANES + j * LANES;
    unsigned char* col = dst + (c / 64) * (ROWS * 128);
#pragma unroll 4
    for (int r = r0; r < ROWS; r += STEP) {
      const __nv_bfloat16 v = r < rows && c < hd ? base[(size_t)(row0 + r) * hd + c] : __float2bfloat16(0.f);
      *reinterpret_cast<__nv_bfloat16*>(col + swz(r, (c % 64) * 2)) = v;
    }
  }
}

// Lane t of a quad holds v[k] = (pair k) of its own; afterwards it holds pair
// t of quad lane k in v[k] (a 4 x 4 transpose of 32-bit values by shuffles).
// Every index is a constant or a select: a register array indexed by the
// lane would live in local memory.
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const int base = (threadIdx.x & 31) & ~3;
  uint32_t out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = v[k];  // out[t] = v[t] stays; the rest is replaced
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int from = (t + r) & 3;
    const uint32_t got = __shfl_sync(0xffffffffu, pick(v, (t - r) & 3), base | from);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = k == from ? got : out[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = out[k];
}

// Store a warpgroup's fp32 accumulator (64 rows x 2N columns, this thread's
// rows row_a and row_a + 8) times mul_a / mul_b as bf16 into columns
// [c0, c0 + 2N) of a row-major [s, hd] matrix: rows past s and columns past
// hd are not written.
template <int N>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* out, const float (&acc)[N], float mul_a,
                                               float mul_b, int row_a, int s, int hd, int c0, int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      if (row >= s) continue;
      const float mul = h ? mul_b : mul_a;
      const float v0 = acc[4 * j + 2 * h] * mul, v1 = acc[4 * j + 2 * h + 1] * mul;
      __nv_bfloat16* dst = out + (size_t)row * hd + col;
      if (hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        if (col + 1 < hd) dst[1] = __float2bfloat16(v1);
      }
    }
  }
}

// The consumer loop of a warpgroup over n tiles that arrive in ring stages,
// each tile going through two products: A (fresh accumulators, e.g. the
// logits), an elementwise step on A's result, then B (accumulated across
// tiles, its register A operand made by that step). B of tile i is issued
// after A of tile i+1, so the elementwise step of tile i+1 (`overlap`) runs
// while the tensor cores do B of tile i; what must wait for B (rescaling its
// accumulators, packing the next operand) is `finish`. `stage(i)` waits for
// tile i and returns its stage, `release(s)` hands a stage back, and
// fence_a / fence_b pin A's and B's registers around the waits. No wgmma
// sits under a per-tile condition: ptxas serializes every wgmma of a kernel
// where one does.
template <typename Stage, typename FenceA, typename FenceB, typename IssueA, typename Overlap,
          typename IssueB, typename Finish, typename Release>
__device__ __forceinline__ void two_product_pipeline(int n, Stage stage, FenceA fence_a,
                                                     FenceB fence_b, IssueA issue_a,
                                                     Overlap overlap, IssueB issue_b,
                                                     Finish finish, Release release) {
  if (n <= 0) return;
  int prev = stage(0);
  fence_a();
  wgmma_fence();
  issue_a(prev);
  wgmma_commit();
  wgmma_wait<0>();
  fence_a();
  overlap(0);
  finish(0);
  for (int i = 1; i < n; ++i) {
    const int s = stage(i);
    fence_a();
    fence_b();
    wgmma_fence();
    issue_a(s);
    wgmma_commit();
    issue_b(prev);
    wgmma_commit();
    wgmma_wait<1>();  // A of tile i is done; B of tile i - 1 may run on
    fence_a();
    overlap(i);
    wgmma_wait<0>();
    fence_b();
    release(prev);
    finish(i);
    prev = s;
  }
  fence_b();
  wgmma_fence();
  issue_b(prev);
  wgmma_commit();
  wgmma_wait<0>();
  fence_b();
  release(prev);
}

// D[64, N] (+)= A[64, 16] B[16, N], fp32 D in registers, scale_d = 0
// overwrites D. wgmma_rs: A as bf16 fragments in registers (thread g*4+t of
// warp w holds rows 16w+g and 16w+g+8, columns 2t, 2t+1, 2t+8, 2t+9), B from
// shared memory, K-major (TRANS_B = 0) or MN-major (1). wgmma_ss: A and B
// K-major in shared memory. D's layout: d[4j + 2h + e] is row 16w + g + 8h,
// column 8j + 2t + e, so the first 16 columns of an accumulator are, rounded
// to bf16 in pairs, the A fragment of a next product.

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64, 128] (+)= A[64, 16] B[16, 128] with A and B in shared memory: A
// K-major, B K-major (TRANS_B = 0) or MN-major (1, e.g. a tile of a row-major
// [K, N] weight read as it lies; smem_desc_mn).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// The same at N = 256.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// ------------------------------------------------------------------ host ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (no -lcuda link).
inline EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> cached{nullptr};
  EncodeTiled fn = cached.load(std::memory_order_acquire);
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
    cached.store(fn, std::memory_order_release);
  }
  return fn;
}

// A 2D tensor map [outer, inner] with rows row_bytes apart, boxes of
// box_inner x box_outer elements landing 128-byte swizzled, zeros outside.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
                      uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3D bf16 tensor map over [mats, rows, cols] (contiguous), boxes of
// 64 cols x box_rows rows x 1 landing 128-byte swizzled; zeros past rows and
// cols, so a box never reads the next matrix.
inline bool encode_3d_bf16(CUtensorMap* map, const void* base, uint64_t mats, uint64_t rows,
                           uint64_t cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, mats}, strides[2] = {2 * cols, 2 * cols * rows};
  const cuuint32_t box[3] = {64, box_rows, 1}, elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// setmaxnreg only redistributes the registers a block was launched with: a
// kernel compiled to fewer than `need` registers a thread would leave its
// consumers waiting forever in setmaxnreg.inc, so its launcher refuses it
// (checked once per kernel; `checked` is the launcher's own flag).
template <typename Kernel>
cudaError_t check_launch_regs(Kernel kernel, int need, std::atomic<int>& checked) {
  if (checked.load(std::memory_order_acquire) != 0) return cudaSuccess;
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < need) return cudaErrorInvalidConfiguration;
  checked.store(1, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace
}  // namespace hopper
}  // namespace ssp
