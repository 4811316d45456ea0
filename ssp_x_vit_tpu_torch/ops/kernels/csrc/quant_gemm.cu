// Weight-only quantized GEMM: out[M, N] = (x[M, K] @ dequant(w)) * scale[N].
//
// Replaces the Pallas kernels of ssp_x_vit_tpu/ops/pallas/quant_matmul.py
// (_run: quant_matmul / _qmm_kernel, quant4_matmul / _qmm4_kernel and its two
// float-unpack variants, which exist only because that compiler lacks int8
// shifts; one integer unpack is enough here).
//
//   bits = 8: w is int8 [K, N].
//   bits = 4: w is int8 [K/2, N], split-half packed: byte = 16*hi + (lo + 8),
//             row r of the byte holds logical row r in its low nibble (biased
//             by +8) and logical row r + K/2 in its high nibble (two's
//             complement). lo = (byte & 15) - 8, hi = byte >> 4 (arithmetic).
//
// x and out are fp32 or bf16 (one dtype), scale is fp32 per output column.
// The product accumulates x @ w.to(x.dtype) in fp32 (integers up to 127 are
// exact in bf16), the epilogue multiplies each column by its scale and stores
// in x's dtype. The dequantised weight never exists in device memory: a K
// tile's bytes are copied to shared memory as they are and turned into bf16
// (or fp32) there on the way to the product. The K loop walks logical rows, so
// for int4 each stored row is fetched twice, once for logical row r (low
// nibble) and once for r + K/2 (high nibble): K*N bytes pass through L2 and
// shared memory for either width, and int4 halves only the weight's footprint
// in device memory (K*N/2 bytes, which a second fetch finds in L2 when the
// weight fits there). Walking stored rows and feeding both halves from one
// staged tile is later work.
//
// The tiles, the cp.async ring, the convert and split-K are the pipeline of
// qgemm_tile.cuh (bf16: 128x128x64 on WMMA 16x16x16; fp32: 64x64x32 SIMT),
// which the wide path of quant_fused_mlp.cu shares; split-K covers M = 1 up to
// a few hundred rows, where the output tiles make less than two waves.
//
// What bounds it on the H100: 2*M*N*K FLOPs against M*K + M*N activations and
// K*N (or K*N/2) stored weight bytes. At the perplexity path's M = 2048 and up
// it is operations-bound (Llama-2-7B gate projection: 185 GFLOP against
// 22.5 MB of int4 weights plus 62 MB of activations); at M = 1 it is bound by
// the weight bytes it fetches, which for int4 is K*N as long as each stored
// row is fetched twice. WMMA on mma.sync and the extra shared-memory pass of the convert
// keep it below the tensor-core peak; wgmma with in-register dequant is later
// work.

#include "qgemm_tile.cuh"

// fp32 workspace (in floats) that ssp_quant_gemm needs for these shapes; 0 = none.
extern "C" long long ssp_quant_gemm_workspace_floats(int dtype, int m, int n, int k) {
  return ssp::qtile::workspace_floats(ssp::qtile::plan(dtype, m, n, k), m, n);
}

// out[m, n] = (x[m, k] @ dequant(w)) * scale; bits 8: w [k, n], bits 4: w [k/2, n] packed.
extern "C" int ssp_quant_gemm(int dtype, int bits, const void* x, const void* w,
                              const float* scale, void* out, int m, int n, int k,
                              float* workspace, void* stream) {
  using namespace ssp;
  if ((bits != 8 && bits != 4) || (bits == 4 && k % 2 != 0) || m <= 0 || n <= 0 || k <= 0 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const qtile::Plan pl = workspace ? qtile::plan(dtype, m, n, k) : qtile::no_split(k);
  const qtile::Args p{x, static_cast<const signed char*>(w), nullptr, scale, nullptr, out,
                      m, n, k, bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == kF32
                              ? qtile::launch<float>(p, pl, workspace, s)
                              : qtile::launch<__nv_bfloat16>(p, pl, workspace, s);
  return static_cast<int>(err);
}
