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
// tile's bytes are staged in shared memory as they are stored and become bf16
// in registers on the way into the product (fp32 tiles: in shared memory).
// bf16 int4 walks stored rows, so each packed byte passes through L2 and
// shared memory once and feeds both of its logical rows.
//
// The tiles, the TMA ring, the in-register dequant and split-K are the
// pipeline of qgemm_tile.cuh (bf16: wgmma with the weight as the A operand
// and the activation rows as N, 16 to 128 per tile; fp32: 64x64x32 SIMT),
// which the wide path of quant_fused_mlp.cu shares; split-K covers M = 1 up
// to a few hundred rows, where the output tiles leave SMs idle.
//
// What bounds it on the H100: 2*M*N*K FLOPs against M*K + M*N activations and
// K*N (or K*N/2) stored weight bytes. At the perplexity path's M = 2048 and up
// it is operations-bound (Llama-2-7B gate projection: 185 GFLOP against
// 22.5 MB of int4 weights plus 62 MB of activations, 0.19 ms at 989 TFLOP/s);
// at M = 1 to 16 it is bound by the weight bytes it streams (int8 4096 x
// 11008: 45 MB, 0.0135 ms at 3.35 TB/s).

#include "qgemm_tile.cuh"

// fp32 workspace (in floats) that ssp_quant_gemm needs for these shapes; 0 = none.
extern "C" long long ssp_quant_gemm_workspace_floats(int dtype, int bits, int m, int n, int k) {
  return ssp::qtile::workspace_floats(ssp::qtile::plan(dtype, bits, m, n, k), m, n);
}

// out[m, n] = (x[m, k] @ dequant(w)) * scale; bits 8: w [k, n], bits 4: w [k/2, n] packed.
extern "C" int ssp_quant_gemm(int dtype, int bits, const void* x, const void* w,
                              const float* scale, void* out, int m, int n, int k,
                              float* workspace, void* stream) {
  using namespace ssp;
  if ((bits != 8 && bits != 4) || (bits == 4 && k % 2 != 0) || m <= 0 || n <= 0 || k <= 0 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const qtile::Plan pl = workspace ? qtile::plan(dtype, bits, m, n, k) : qtile::no_split(k);
  const qtile::Args p{x, static_cast<const signed char*>(w), nullptr, scale, nullptr, out,
                      m, n, k, bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = bits == 4 ? qtile::launch<float, 4>(p, pl, workspace, s)
                    : qtile::launch<float, 8>(p, pl, workspace, s);
  else
    err = bits == 4 ? qtile::launch<__nv_bfloat16, 4>(p, pl, workspace, s)
                    : qtile::launch<__nv_bfloat16, 8>(p, pl, workspace, s);
  return static_cast<int>(err);
}
