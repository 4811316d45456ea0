// Paged decode attention and the paged pool write (replace
// ssp_x_vit_tpu/ops/pallas/paged_attention.py: _paged_pallas_grouped,
// _paged_pallas_perhead, _paged_pallas_grouped_q8, _pool_write_pallas_array,
// _pool_write_pallas_q8).
//
// Attention: one query token per sequence against the keys
// [start, seq_len) of that sequence, which live in fixed-size pages of a pool
// [A, nkv, P, ps, hd] named by the sequence's row of the page table. What
// bounds it: every K and V row of the live range is read once and used for
// 4 * rep * hd operations, about 1 operation per byte at rep = 1, so it is
// bytes-bound at every GQA ratio the models use. The design therefore keeps
// many row loads in flight and nothing else: one block per (sequence, KV
// head) holds the whole query group (the TPU's grouped / per-head split was a
// VMEM budget and has no counterpart), its 8 warps take keys in groups of 4,
// each lane owning EPL contiguous head dims of every row (one 4..16-byte load
// per row and lane), so a warp has 8 row loads in flight per step. Each warp
// runs its own online softmax in fp32 registers; the warps' states are merged
// through shared memory in warp order, so the result does not depend on
// scheduling. Offsets into the pool are 64-bit (a Llama-2-7B pool of 512
// pages of 64 has 4.29e9 elements). int8 pools fold the key scale into the
// score before the softcap and the value scale into the weights.
//
// Write: one warp per (sequence, KV head) row writes hd elements (and, for
// int8 pools, the row's scale) at (layer, page_table[i, pos / ps], pos % ps),
// K and V in one launch, in place; nothing else of the pool is touched.
#include "common.cuh"

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace ssp {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;          // keys a warp scores before one softmax update
constexpr float kMin = -FLT_MAX;   // finfo(float32).min, the reference's mask value
constexpr int kWriteWarps = 4;

// Must match POOL_CODES in ops/kernels/build.py.
enum PoolType { kPoolF32 = 0, kPoolBF16 = 1, kPoolI8 = 2 };

template <typename T> __device__ __forceinline__ float as_float(T v);
template <> __device__ __forceinline__ float as_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float as_float<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// p as the second product sees it: rounded to V's dtype for float pools (the
// TPU kernel casts p to V's dtype), untouched fp32 for int8 pools.
template <typename T> __device__ __forceinline__ float round_like(float p) { return p; }
template <> __device__ __forceinline__ float round_like<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// out[e] = row[d0 + e] as fp32, zero past hd. `vec`: hd is a multiple of N and
// the base pointers are 32-byte aligned, so a lane's N elements are one
// aligned vector that lies wholly inside or outside the row.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int hd, int d0, bool vec,
                                         float (&out)[N]) {
  if (vec) {
    if (d0 < hd) {
      const Vec<T, N> raw = *reinterpret_cast<const Vec<T, N>*>(row + d0);
#pragma unroll
      for (int e = 0; e < N; ++e) out[e] = as_float<T>(raw.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) out[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = d0 + e < hd ? as_float<T>(row[d0 + e]) : 0.f;
  }
}

template <typename TQ, typename TP, int EPL, int REP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                       const TP* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ page_table,
                       const int* __restrict__ seq_lens, const int* __restrict__ start_lens,
                       TQ* __restrict__ out, int nq, int nkv, int rep, int hd, int ps, int mp,
                       long long num_pages, int layer, float scale, float softcap, int vec) {
  constexpr bool kQ8 = std::is_same<TP, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm_o = reinterpret_cast<float*>(smem_raw);  // [REP * hd] merged accumulator
  int* sm_pt = reinterpret_cast<int*>(sm_o + REP * hd);  // [mp] this sequence's pages
  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_inv[REP];

  const int h = blockIdx.x, i = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * EPL;
  const int seq_len = min(seq_lens[i], mp * ps);
  const int start = start_lens != nullptr ? max(start_lens[i], 0) : 0;
  const int n_keys = seq_len - start;

  // Only the pages that overlap [start, seq_len) are read: unused entries of
  // the table are 0 (the trash page) and are never taken as data.
  if (n_keys > 0) {
    const int j1 = (seq_len + ps - 1) / ps;
    for (int j = start / ps + threadIdx.x; j < j1; j += kThreads)
      sm_pt[j] = page_table[static_cast<long long>(i) * mp + j];
  }

  float qr[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < rep) {
      load_row<TQ, EPL>(q + (static_cast<long long>(i) * nq + h * rep + r) * hd, hd, d0, vec,
                        qr[r]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
    }
  }
  __syncthreads();

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kMin;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const long long head_page0 = (static_cast<long long>(layer) * nkv + h) * num_pages;
  for (int t0 = warp * kGroup; t0 < n_keys; t0 += kWarps * kGroup) {
    float kv[kGroup][EPL], vv[kGroup][EPL], ksc[kGroup], vsc[kGroup];
    bool ok[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      ok[g] = t0 + g < n_keys;
      ksc[g] = 1.f;
      vsc[g] = 1.f;
      if (ok[g]) {
        const int kpos = start + t0 + g;
        const int j = kpos / ps;
        const long long row = (head_page0 + sm_pt[j]) * ps + (kpos - j * ps);
        load_row<TP, EPL>(k_pool + row * hd, hd, d0, vec, kv[g]);
        load_row<TP, EPL>(v_pool + row * hd, hd, d0, vec, vv[g]);
        if (kQ8) {
          ksc[g] = k_scale[row];
          vsc[g] = v_scale[row];
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kv[g][e] = 0.f;
          vv[g][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) continue;
      float s[kGroup];
      float m_new = m[r];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qr[r][e] * kv[g][e];
        dot = warp_sum(dot);
        if (kQ8) dot *= ksc[g];
        if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
        s[g] = ok[g] ? dot : kMin;
        m_new = fmaxf(m_new, s[g]);
      }
      const float alpha = expf(m[r] - m_new);
      float p[kGroup], p_sum = 0.f;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        p[g] = ok[g] ? expf(s[g] - m_new) : 0.f;
        p_sum += p[g];  // the row sum takes p before the value scale and the rounding
        p[g] = kQ8 ? p[g] * vsc[g] : round_like<TP>(p[g]);
      }
      l[r] = l[r] * alpha + p_sum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) a += p[g] * vv[g][e];
        acc[r][e] = a;
      }
      m[r] = m_new;
    }
  }

  // Merge the warps' softmax states in warp order (deterministic).
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  __syncthreads();
  float factor[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float m_all = kMin;
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w][r]);
    factor[r] = expf(m[r] - m_all);
    if (threadIdx.x == 0) {
      float l_all = 0.f;
      for (int w = 0; w < kWarps; ++w) l_all += sm_l[w][r] * expf(sm_m[w][r] - m_all);
      sm_inv[r] = 1.f / fmaxf(l_all, 1e-30f);
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= rep) continue;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = d0 + e;
          if (d < hd) {
            const float part = acc[r][e] * factor[r];
            sm_o[r * hd + d] = w == 0 ? part : sm_o[r * hd + d] + part;
          }
        }
      }
    }
    __syncthreads();
  }
  TQ* out_row = out + (static_cast<long long>(i) * nq + h * rep) * hd;
  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads)
    out_row[idx] = from_f<TQ>(sm_o[idx] * sm_inv[idx / hd]);
}

template <typename TQ, typename TP, int EPL, int REP>
cudaError_t launch_attention(const void* q, const void* k_pool, const void* v_pool,
                             const void* k_scale, const void* v_scale, const void* page_table,
                             const void* seq_lens, const void* start_lens, void* out, int b, int nq,
                             int nkv, int hd, int ps, int mp, long long num_pages, int layer,
                             float scale, float softcap, int vec, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<TQ, TP, EPL, REP>;
  const size_t smem = (static_cast<size_t>(REP) * hd + mp) * sizeof(float);
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> done{0};
    const cudaError_t err = allow_max_dynamic_smem(kernel, done);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nkv, b), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool), static_cast<const TP*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<const int*>(start_lens), static_cast<TQ*>(out), nq, nkv, nq / nkv, hd, ps, mp,
      num_pages, layer, scale, softcap, vec);
  return cudaGetLastError();
}

#define SSP_PAGED_ARGS                                                                          \
  q, k_pool, v_pool, k_scale, v_scale, page_table, seq_lens, start_lens, out, b, nq, nkv, hd,  \
      ps, mp, num_pages, layer, scale, softcap, vec, stream

template <typename TQ, typename TP, int EPL>
cudaError_t dispatch_rep(const void* q, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, const void* page_table,
                         const void* seq_lens, const void* start_lens, void* out, int b, int nq,
                         int nkv, int hd, int ps, int mp, long long num_pages, int layer,
                         float scale, float softcap, int vec, cudaStream_t stream) {
  const int rep = nq / nkv;
  // three group sizes keep the build short: a group of 2 or 3 runs as 4 (idle
  // registers, no extra bytes moved), 5 to 7 as 8
  if (rep <= 1) return launch_attention<TQ, TP, EPL, 1>(SSP_PAGED_ARGS);
  if (rep <= 4) return launch_attention<TQ, TP, EPL, 4>(SSP_PAGED_ARGS);
  return launch_attention<TQ, TP, EPL, 8>(SSP_PAGED_ARGS);
}

template <typename TQ, typename TP>
cudaError_t dispatch_hd(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale, const void* page_table,
                        const void* seq_lens, const void* start_lens, void* out, int b, int nq,
                        int nkv, int hd, int ps, int mp, long long num_pages, int layer,
                        float scale, float softcap, int vec, cudaStream_t stream) {
  // A lane's EPL contiguous dims must be one vector: fall back to scalar
  // loads where hd is not a multiple of EPL (hd = 80 is, with EPL = 4).
  if (hd <= 64) {
    if (hd % 2) vec = 0;
    return dispatch_rep<TQ, TP, 2>(SSP_PAGED_ARGS);
  }
  if (hd <= 128) {
    if (hd % 4) vec = 0;
    return dispatch_rep<TQ, TP, 4>(SSP_PAGED_ARGS);
  }
  if (hd % 8) vec = 0;
  return dispatch_rep<TQ, TP, 8>(SSP_PAGED_ARGS);
}

template <typename TN, typename TP>
__global__ void __launch_bounds__(kWriteWarps * 32)
paged_pool_write_kernel(const TN* __restrict__ k_new, const TN* __restrict__ v_new,
                        TP* __restrict__ k_pool, TP* __restrict__ v_pool,
                        float* __restrict__ k_scale, float* __restrict__ v_scale,
                        const int* __restrict__ page_table, const int* __restrict__ positions,
                        int nkv, int hd, int ps, int mp, long long num_pages, int layer) {
  constexpr bool kQ8 = std::is_same<TP, int8_t>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWriteWarps + warp;
  if (h >= nkv) return;  // the whole warp leaves together
  const int i = blockIdx.y;
  const bool is_v = blockIdx.z == 1;
  const TN* src = (is_v ? v_new : k_new) + (static_cast<long long>(i) * nkv + h) * hd;
  TP* pool = is_v ? v_pool : k_pool;
  float* pool_scale = is_v ? v_scale : k_scale;

  // A position outside the table goes to the trash page, as an inactive slot does.
  const int pos = positions[i];
  const int j = pos >= 0 ? pos / ps : mp;
  const int phys = j < mp ? page_table[static_cast<long long>(i) * mp + j] : 0;
  const int off = j < mp ? pos - j * ps : 0;
  const long long row = ((static_cast<long long>(layer) * nkv + h) * num_pages + phys) * ps + off;
  TP* dst = pool + row * hd;

  if constexpr (kQ8) {
    // per token and KV head: scale = amax / 127 (1 where amax == 0),
    // code = clip(round-half-to-even(x / scale), +-127)
    float amax = 0.f;
    for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(as_float<TN>(src[d])));
    amax = warp_max(amax);
    const float sc = amax > 0.f ? amax / 127.0f : 1.0f;
    for (int d = lane; d < hd; d += 32) {
      const float code = fminf(fmaxf(rintf(as_float<TN>(src[d]) / sc), -127.f), 127.f);
      dst[d] = static_cast<int8_t>(code);
    }
    if (lane == 0) pool_scale[row] = sc;
  } else {
    for (int d = lane; d < hd; d += 32) dst[d] = from_f<TP>(as_float<TN>(src[d]));
  }
}

template <typename TN, typename TP>
cudaError_t launch_write(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                         void* k_scale, void* v_scale, const void* page_table,
                         const void* positions, int b, int nkv, int hd, int ps, int mp,
                         long long num_pages, int layer, cudaStream_t stream) {
  const dim3 grid((nkv + kWriteWarps - 1) / kWriteWarps, b, v_new != nullptr ? 2 : 1);
  paged_pool_write_kernel<TN, TP><<<grid, kWriteWarps * 32, 0, stream>>>(
      static_cast<const TN*>(k_new), static_cast<const TN*>(v_new), static_cast<TP*>(k_pool),
      static_cast<TP*>(v_pool), static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(positions), nkv, hd, ps, mp,
      num_pages, layer);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ssp

// out[b, nq, hd] (q's dtype) = softmax over the keys [start_lens[i], seq_lens[i])
// of sequence i of softcap(q k^T / sqrt(hd)) times v, K/V read from layer
// `layer` of pools [A, nkv, num_pages, ps, hd] through page_table [b, mp].
// pool_type 2 (int8) takes the fp32 scales [A, nkv, num_pages, ps] and bf16
// queries; float pools have q's dtype. start_lens may be null (0); softcap <= 0 means none. `vec`:
// every base pointer is 32-byte aligned. b <= 65535.
extern "C" int ssp_paged_attention(int q_dtype, int pool_type, const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* seq_lens,
                                   const void* start_lens, void* out, int b, int nq, int nkv,
                                   int hd, int ps, int mp, long long num_pages, int layer,
                                   float scale, float softcap, int vec, void* stream_ptr) {
  using namespace ssp;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b <= 0 || nkv <= 0 || hd <= 0 || hd > 256 || nq % nkv != 0 || nq / nkv > 8 || b > 65535)
    return cudaErrorInvalidValue;
  if (pool_type == kPoolI8)  // an int8 cache computes in bf16
    return q_dtype == kBF16 ? dispatch_hd<__nv_bfloat16, int8_t>(SSP_PAGED_ARGS)
                            : cudaErrorInvalidValue;
  if (q_dtype == kF32 && pool_type == kPoolF32) return dispatch_hd<float, float>(SSP_PAGED_ARGS);
  if (q_dtype == kBF16 && pool_type == kPoolBF16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(SSP_PAGED_ARGS);
  return cudaErrorInvalidValue;
}

// In place: pool[layer, :, page_table[i, positions[i] / ps], positions[i] % ps, :]
// = new[i] for every sequence i, for K and (v_new non-null) V in one launch.
// int8 pools quantize per token and KV head and write the fp32 scale too.
extern "C" int ssp_paged_pool_write(int new_dtype, int pool_type, const void* k_new,
                                    const void* v_new, void* k_pool, void* v_pool, void* k_scale,
                                    void* v_scale, const void* page_table, const void* positions,
                                    int b, int nkv, int hd, int ps, int mp, long long num_pages,
                                    int layer, void* stream_ptr) {
  using namespace ssp;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b <= 0 || nkv <= 0 || hd <= 0 || b > 65535) return cudaErrorInvalidValue;
#define SSP_WRITE_ARGS                                                                       \
  k_new, v_new, k_pool, v_pool, k_scale, v_scale, page_table, positions, b, nkv, hd, ps, mp, \
      num_pages, layer, stream
  if (new_dtype == kF32) {
    if (pool_type == kPoolF32) return launch_write<float, float>(SSP_WRITE_ARGS);
    if (pool_type == kPoolBF16) return launch_write<float, __nv_bfloat16>(SSP_WRITE_ARGS);
    return launch_write<float, int8_t>(SSP_WRITE_ARGS);
  }
  if (pool_type == kPoolF32) return launch_write<__nv_bfloat16, float>(SSP_WRITE_ARGS);
  if (pool_type == kPoolBF16) return launch_write<__nv_bfloat16, __nv_bfloat16>(SSP_WRITE_ARGS);
  return launch_write<__nv_bfloat16, int8_t>(SSP_WRITE_ARGS);
#undef SSP_WRITE_ARGS
}
