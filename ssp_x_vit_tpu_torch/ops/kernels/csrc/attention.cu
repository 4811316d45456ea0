// Non-causal multi-head attention core of the ViT block: softmax(q k^T / sqrt(hd)) v
// over a fused [b*s, 3d] QKV buffer, full-row fp32 softmax.
//
// Replaces the attention core of the Pallas kernels
//   ssp_x_vit_tpu/ops/pallas/fused_attn_block.py : _kernel_v2 (head-pair core)
//   ssp_x_vit_tpu/ops/pallas/fused_attn_block.py : _kernel    (per-head core)
// Both compute, per head: logits in fp32, keys >= s masked, full-row softmax,
// P divided by its row sum and cast to the operand dtype, P @ V accumulated in
// fp32 and cast to the operand dtype. These kernels keep those numerics. The
// Pallas kernels padded s to a multiple of 128 and masked the padded keys;
// here the padded keys are zero rows excluded from the softmax, which is the
// same function.
//
// - bf16 with head_dim % 16 == 0, <= 128 (every ViT here; namespace wg):
//   Hopper's wgmma with TMA loads. A block is one warpgroup and owns one
//   (image, head), or a group of its 64-row query tiles when the (image,
//   head) pairs alone make under two blocks per SM; at head_dim 64 three
//   blocks share an SM, so one block's softmax runs under another's
//   products. One thread loads the head's K and V once (64 x 64 boxes
//   through a 3-D tensor map over [b, s, 3d], 128-byte swizzled as wgmma
//   reads them; rows past s arrive as zeros) and each query tile into one
//   slot, the next as soon as the logits of the last are computed. Per query
//   tile, S = Q K^T of all keys goes into fp32 registers (padded keys <= 256:
//   64 x 256 is 128 registers a thread); the softmax runs there (a thread
//   holds rows g and g+8 of its warp's 16, so the row max and sum are quad
//   shuffles; 8-key groups wholly past s take no exp), P = e / sum is
//   rounded to bf16 in registers (S's accumulator layout is wgmma's
//   A-fragment layout) and O = P V takes P as the register A operand and V
//   MN-major from the staged tile. Past 256 keys the same
//   rounding point is kept by two exact passes over 64-key chunks: the row
//   max and the rescaled row sum, then S again, p = exp(s - m) / l in bf16,
//   and P V. Head dims pad to 64 / 128 in shared memory; the query columns
//   past hd (the next head's) are zeroed there, so the box's extra columns
//   never enter a logit, and O's extra columns are not stored.
// - fp32 (exact, no TF32) and other head sizes: a SIMT kernel with the head's
//   K (transposed, so lanes read consecutive keys) and V in shared memory;
//   lanes split the keys for the logits and the head dimension for P @ V.
//   When 64-query tiles would leave SMs idle (small batches) it takes 16-query
//   tiles instead.
//
// What bounds it on the H100: at ViT sequence lengths the core is ~11% of the
// block's FLOPs (4*b*h*s^2*hd vs 8*b*s*d^2) and moves q/k/v and o once (ViT-B
// b=64: 7.6 GFLOP against 77.5 MB), so it is bytes-bound; the design reads
// each head's K and V from device memory once and keeps the logits, the
// softmax and P in registers.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace ssp {

constexpr int kQueryTile = 64, kWarps = 4, kMaxHeadDim = 128;

// ------------------------------------------------------------- SIMT path ---
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const T* qkv, T* out, int s, int heads, int hd, float scale, int q_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = heads * hd, ld = 3 * d;
  const int img = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * q_tile;
  T* kt = reinterpret_cast<T*>(smem);  // [hd][s]
  T* v = kt + (size_t)hd * s;          // [s][hd]
  const size_t kv_bytes = ((2 * (size_t)hd * s * sizeof(T)) + 15) / 16 * 16;
  float* prob = reinterpret_cast<float*>(smem + kv_bytes);  // [kWarps][s]
  float* qrow = prob + kWarps * s;                           // [kWarps][hd]

  const T* base = qkv + (size_t)img * s * ld;
  if (std::is_same<T, float>::value && hd % 4 == 0) {
    // 16-byte loads (d and hd multiples of 4 keep every row aligned)
    const int chunks = hd / 4;
    for (int e = threadIdx.x; e < s * chunks; e += blockDim.x) {
      const int j = e / chunks, c = (e % chunks) * 4;
      const T* row = base + (size_t)j * ld + h * hd + c;
      const float4 k4 = *reinterpret_cast<const float4*>(row + d);
      const float4 v4 = *reinterpret_cast<const float4*>(row + 2 * d);
      kt[(size_t)(c + 0) * s + j] = from_f<T>(k4.x);
      kt[(size_t)(c + 1) * s + j] = from_f<T>(k4.y);
      kt[(size_t)(c + 2) * s + j] = from_f<T>(k4.z);
      kt[(size_t)(c + 3) * s + j] = from_f<T>(k4.w);
      *reinterpret_cast<float4*>(v + (size_t)j * hd + c) = v4;
    }
  } else {
    for (int e = threadIdx.x; e < s * hd; e += blockDim.x) {
      const int j = e / hd, c = e % hd;
      kt[(size_t)c * s + j] = base[(size_t)j * ld + d + h * hd + c];
      v[e] = base[(size_t)j * ld + 2 * d + h * hd + c];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = prob + warp * s;
  float* q = qrow + warp * hd;
  const int q_end = min(q0 + q_tile, s);
  for (int qi = q0 + warp; qi < q_end; qi += kWarps) {
    for (int c = lane; c < hd; c += 32) q[c] = to_f(base[(size_t)qi * ld + h * hd + c]);
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < s; j += 32) {
      float acc = 0.f;
      for (int c = 0; c < hd; ++c) acc = fmaf(q[c], to_f(kt[(size_t)c * s + j]), acc);
      acc *= scale;
      p[j] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < s; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < s; j += 32) p[j] = to_f(from_f<T>(p[j] / sum));
    __syncwarp();

    float o[kMaxHeadDim / 32];
#pragma unroll
    for (int u = 0; u < kMaxHeadDim / 32; ++u) o[u] = 0.f;
    for (int j = 0; j < s; ++j) {
      const float pj = p[j];
      const T* vj = v + (size_t)j * hd;
#pragma unroll
      for (int u = 0; u < kMaxHeadDim / 32; ++u) {
        const int c = lane + 32 * u;
        if (c < hd) o[u] = fmaf(pj, to_f(vj[c]), o[u]);
      }
    }
    T* orow = out + ((size_t)img * s + qi) * d + h * hd;
#pragma unroll
    for (int u = 0; u < kMaxHeadDim / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < hd) orow[c] = from_f<T>(o[u]);
    }
    __syncwarp();
  }
}

size_t simt_smem_bytes(size_t elem, int s, int hd) {
  const size_t kv = (2 * (size_t)hd * s * elem + 15) / 16 * 16;
  return kv + sizeof(float) * kWarps * ((size_t)s + hd);
}

// ------------------------------------------------ bf16: wgmma + TMA ------
namespace wg {
// Internal linkage: the launchers' once-per-device statics belong to this library.
namespace {
using namespace ::ssp::hopper;
using T = __nv_bfloat16;
constexpr int THREADS = 128;   // one warpgroup: 64 query rows at a time
constexpr int BOX = 64 * 128;  // a TMA box: 64 rows x 64 columns (128 bytes)
constexpr int MAX_CHUNKS = 4;  // 64-key chunks whose logits stay in registers (256 keys)
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int key_chunks(int s) { return (s + 63) / 64; }
__host__ __device__ inline int hd_pad(int hd) { return hd <= 64 ? 64 : 128; }

// K and V of the head (per 64-column box: [64 * chunks rows][128 bytes]), the
// query-tile slot, 3 mbarriers and the 1024-byte alignment of the swizzle.
__host__ __device__ inline size_t smem_bytes(int s, int hd) {
  const size_t nb = hd_pad(hd) / 64;
  return 2 * nb * key_chunks(s) * BOX + nb * BOX + 3 * sizeof(uint64_t) + 1024;
}

struct Args {
  const T* qkv;  // [b * s, 3d]
  T* out;        // [b * s, d]
  int b, s, heads, hd;
  float scale;
  int q_tiles;   // 64-row query tiles per block
};

// Zero columns [hd, HDP) of a staged 64-row query tile (the next head's
// columns, which TMA brought in with the box).
template <int HDP>
__device__ __forceinline__ void zero_q_tail(unsigned char* q, int hd) {
  const int width = HDP - hd;
  for (int e = threadIdx.x; e < 64 * width; e += THREADS) {
    const int r = e / width, c = hd + e % width;
    *reinterpret_cast<T*>(q + (c / 64) * BOX + swz(r, (c % 64) * 2)) = __float2bfloat16(0.f);
  }
}

// Logits of keys >= s become -inf in the 64-key chunk c of a thread's rows.
__device__ __forceinline__ void mask_keys(float (&sc)[32], int c, int s, int t) {
  if (64 * c + 64 <= s) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (64 * c + 8 * j + 2 * t + e >= s) {
        sc[4 * j + e] = -INFINITY;
        sc[4 * j + 2 + e] = -INFINITY;
      }
}

// The row maxima of a chunk (rows a and b), over the quad.
__device__ __forceinline__ void chunk_max(const float (&sc)[32], float& mx_a, float& mx_b) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx_a = fmaxf(mx_a, sc[4 * j + e]);
      mx_b = fmaxf(mx_b, sc[4 * j + 2 + e]);
    }
}

// sc <- 2^(sc * sl2 - base) and the thread's part of the row sums for the
// 64-key chunk c; groups of 8 keys wholly past s give 0 without an exp.
__device__ __forceinline__ void chunk_exp(float (&sc)[32], int c, int s, float sl2, float base_a,
                                          float base_b, float& sum_a, float& sum_b) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (64 * c + 8 * j >= s) {
        sc[4 * j + e] = sc[4 * j + 2 + e] = 0.f;
        continue;
      }
      sc[4 * j + e] = fast_exp2(fmaf(sc[4 * j + e], sl2, -base_a));
      sc[4 * j + 2 + e] = fast_exp2(fmaf(sc[4 * j + 2 + e], sl2, -base_b));
      sum_a += sc[4 * j + e];
      sum_b += sc[4 * j + 2 + e];
    }
}

// P = e / sum of a chunk, rounded to bf16: the A fragments of its four
// 16-key steps (registers r = 0, 2 hold row a, r = 1, 3 row b).
__device__ __forceinline__ void chunk_pack(const float (&sc)[32], float inv_a, float inv_b,
                                           uint32_t (&pf)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float inv = r % 2 ? inv_b : inv_a;
      pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r] * inv, sc[8 * kk + 2 * r + 1] * inv);
    }
}

// grid (heads, images, query groups). NCH > 0: the keys make NCH chunks of 64
// whose logits stay in registers (one pass); NCH == 0: two passes over the chunks.
template <int HDP, int NCH>
__global__ void __launch_bounds__(THREADS, HDP == 64 ? 3 : 1)
    core_kernel(const __grid_constant__ CUtensorMap map, const Args p) {
  constexpr int NB = HDP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_kc = NCH > 0 ? NCH : key_chunks(p.s);
  const int kv_box = n_kc * BOX;  // one 64-column box of K or V: all keys
  unsigned char* ks = smem;
  unsigned char* vs = ks + NB * kv_box;
  unsigned char* qs = vs + NB * kv_box;  // the query tile's NB boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(qs + NB * BOX);  // K, V, Q
  const int head = blockIdx.x, img = blockIdx.y, tid = threadIdx.x;
  const int d = p.heads * p.hd, qc = head * p.hd;  // this head's q columns start at qc
  const int qt0 = blockIdx.z * p.q_tiles;
  const int n_my = min(key_chunks(p.s), qt0 + p.q_tiles) - qt0;  // this block's query tiles
  const auto load_q = [&](int i) {
    mbar_expect_tx(&bars[2], NB * BOX);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load_3d(qs + b * BOX, &map, qc + 64 * b, 64 * (qt0 + i), img, &bars[2]);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    load_q(0);  // the first logits need Q and K; V streams in behind them
#pragma unroll
    for (int m = 0; m < 2; ++m) {  // K, then V: every key of the head, once
      mbar_expect_tx(&bars[m], NB * kv_box);
      for (int c = 0; c < n_kc; ++c)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tma_load_3d((m ? vs : ks) + b * kv_box + c * BOX, &map, (m + 1) * d + qc + 64 * b,
                      64 * c, img, &bars[m]);
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float sl2 = p.scale * LOG2E;  // logits in log2 units
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  const auto desc_q = [&](uint32_t q_addr, int kk) {
    return smem_desc(q_addr + (kk / 4) * BOX + (kk % 4) * 32);
  };
  const auto desc_k = [&](int c, int kk) {
    return smem_desc(k_addr + (kk / 4) * kv_box + c * BOX + (kk % 4) * 32);
  };
  const auto desc_v = [&](int c, int kk) { return smem_desc_mn(v_addr + c * BOX + kk * 2048, kv_box); };
  // S = Q K^T of chunk c into sc (issued and waited for)
  const auto logits = [&](float (&sc)[32], uint32_t q_addr, int c) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) wgmma_ss(sc, desc_q(q_addr, kk), desc_k(c, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
  };
  // O += P V of chunk c (issued, not waited for)
  const auto issue_pv = [&](float (&o)[HDP / 2], const uint32_t (&pf)[4][4], int c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pf[kk], desc_v(c, kk), 1);
  };

  const uint32_t q_addr = smem_u32(qs);
  for (int i = 0; i < n_my; ++i) {
    mbar_wait(&bars[2], i & 1);
    if (p.hd < HDP) {
      zero_q_tail<HDP>(qs, p.hd);
      fence_proxy_async();
      __syncthreads();
    }
    // the slot's last product is done in every warp: load tile i + 1 into it
    const auto release_q = [&] {
      __syncthreads();
      if (tid == 0 && i + 1 < n_my) load_q(i + 1);
    };
    mbar_wait(&bars[0], 0);
    float o[HDP / 2];
#pragma unroll
    for (int k = 0; k < HDP / 2; ++k) o[k] = 0.f;
    if constexpr (NCH > 0) {
      float sc[NCH][32];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int k = 0; k < 32; ++k) sc[c][k] = 0.f;
        logits(sc[c], q_addr, c);
      }
      release_q();
      float mx_a = -INFINITY, mx_b = -INFINITY, sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        mask_keys(sc[c], c, p.s, t);
        chunk_max(sc[c], mx_a, mx_b);
      }
      const float base_a = quad_max(mx_a) * sl2, base_b = quad_max(mx_b) * sl2;
#pragma unroll
      for (int c = 0; c < NCH; ++c) chunk_exp(sc[c], c, p.s, sl2, base_a, base_b, sum_a, sum_b);
      const float inv_a = 1.f / quad_sum(sum_a), inv_b = 1.f / quad_sum(sum_b);
      uint32_t pf[NCH][4][4];
#pragma unroll
      for (int c = 0; c < NCH; ++c) chunk_pack(sc[c], inv_a, inv_b, pf[c]);
      mbar_wait(&bars[1], 0);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c) issue_pv(o, pf[c], c);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    } else {
      float sc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) sc[k] = 0.f;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // max in log2 units
      for (int c = 0; c < n_kc; ++c) {  // pass 1: the row max and the rescaled row sum
        logits(sc, q_addr, c);
        mask_keys(sc, c, p.s, t);
        float mx_a = -INFINITY, mx_b = -INFINITY;
        chunk_max(sc, mx_a, mx_b);
        const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl2), mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
        float sum_a = 0.f, sum_b = 0.f;
        chunk_exp(sc, c, p.s, sl2, mn_a, mn_b, sum_a, sum_b);
        l_a = l_a * fast_exp2(m_a - mn_a) + sum_a;  // exp2(-inf) = 0 on the first chunk
        l_b = l_b * fast_exp2(m_b - mn_b) + sum_b;
        m_a = mn_a;
        m_b = mn_b;
      }
      const float inv_a = 1.f / quad_sum(l_a), inv_b = 1.f / quad_sum(l_b);
      mbar_wait(&bars[1], 0);
      for (int c = 0; c < n_kc; ++c) {  // pass 2: p = exp(s - m) / l in bf16, then P V
        logits(sc, q_addr, c);
        mask_keys(sc, c, p.s, t);
        float sum_a = 0.f, sum_b = 0.f;  // taken in pass 1
        chunk_exp(sc, c, p.s, sl2, m_a, m_b, sum_a, sum_b);
        uint32_t pf[4][4];
        chunk_pack(sc, inv_a, inv_b, pf);
        wgmma_fence();
        issue_pv(o, pf, c);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      release_q();
    }
    // o[4j + 2h + e] is query row 16 * warp + g + 8h of the tile, column 8j + 2t + e
    const int q0 = 64 * (qt0 + i);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.hd) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 16 * warp + g + 8 * h;
        if (row < p.s)
          *reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)img * p.s + row) * d + qc + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int HDP, int NCH>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const auto kern = core_kernel<HDP, NCH>;
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_shared_blocks(kern, smem_allowed);
  if (err != cudaSuccess) return err;
  CUtensorMap map{};
  if (!encode_3d_bf16(&map, p.qkv, p.b, p.s, 3ull * p.heads * p.hd, 64)) return cudaErrorNotSupported;
  const int groups = (key_chunks(p.s) + p.q_tiles - 1) / p.q_tiles;
  kern<<<dim3(p.heads, p.b, groups), THREADS, smem_bytes(p.s, p.hd), stream>>>(map, p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_hd(const Args& p, cudaStream_t stream) {
  switch (key_chunks(p.s)) {
    case 1: return launch<HDP, 1>(p, stream);
    case 2: return launch<HDP, 2>(p, stream);
    case 3: return launch<HDP, 3>(p, stream);
    case MAX_CHUNKS: return launch<HDP, MAX_CHUNKS>(p, stream);
    default: return launch<HDP, 0>(p, stream);
  }
}

// Query tiles per block: all of a head's, unless the (image, head) pairs
// alone make under two blocks per SM; then they split into groups.
int query_tiles(int b, int s, int heads) {
  const int n_qt = key_chunks(s);
  const long long pairs = (long long)b * heads, want = 2LL * sm_count();
  if (pairs >= want) return n_qt;
  const int groups = static_cast<int>(std::min<long long>(n_qt, (want + pairs - 1) / pairs));
  return (n_qt + groups - 1) / groups;
}
}  // namespace
}  // namespace wg

bool use_tensor_cores(int dtype, int hd) { return dtype == kBF16 && hd % 16 == 0; }

template <typename T>
int launch_simt(const void* qkv, void* out, int b, int s, int heads, int hd, float scale,
                size_t smem, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err = allow_max_dynamic_smem(attention_kernel<T>, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-row query tiles when 64-row tiles would leave SMs idle (small batches)
  const long long tiles64 = (long long)b * heads * ((s + kQueryTile - 1) / kQueryTile);
  const int q_tile = tiles64 < 2LL * sm_count() ? 16 : kQueryTile;
  const dim3 grid((s + q_tile - 1) / q_tile, heads, b);
  attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), s, heads, hd, scale, q_tile);
  return static_cast<int>(cudaGetLastError());
}

int launch_wg(const void* qkv, void* out, int b, int s, int heads, int hd, float scale,
              cudaStream_t stream) {
  // TMA reads the fused buffer: a 16-byte aligned base (3d % 8 == 0 keeps the rows aligned)
  if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0 || b > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::Args p{static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), b, s,
                   heads, hd, scale, wg::query_tiles(b, s, heads)};
  return static_cast<int>(hd <= 64 ? wg::launch_hd<64>(p, stream) : wg::launch_hd<128>(p, stream));
}

}  // namespace ssp

// Dynamic shared memory the kernel for (dtype, s, hd) needs; the wrapper checks
// it against the card's per-block limit before launching.
extern "C" long long ssp_attention_smem_bytes(int dtype, int s, int hd) {
  using namespace ssp;
  if (use_tensor_cores(dtype, hd)) return static_cast<long long>(wg::smem_bytes(s, hd));
  return static_cast<long long>(simt_smem_bytes(dtype == kF32 ? 4 : 2, s, hd));
}

extern "C" int ssp_attention(int dtype, const void* qkv, void* out, int b, int s, int heads,
                             int hd, float scale, void* stream) {
  using namespace ssp;
  if (hd > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_tensor_cores(dtype, hd)) return launch_wg(qkv, out, b, s, heads, hd, scale, st);
  const size_t smem = static_cast<size_t>(ssp_attention_smem_bytes(dtype, s, hd));
  if (dtype == kF32) return launch_simt<float>(qkv, out, b, s, heads, hd, scale, smem, st);
  return launch_simt<__nv_bfloat16>(qkv, out, b, s, heads, hd, scale, smem, st);
}
