// Paged decode attention and the paged pool write (replace
// ssp_x_vit_tpu/ops/pallas/paged_attention.py: _paged_pallas_grouped,
// _paged_pallas_perhead, _paged_pallas_grouped_q8, _pool_write_pallas_array,
// _pool_write_pallas_q8).
//
// Attention: one query token per sequence against the keys [start, seq_len)
// of that sequence, which live in fixed-size pages of a pool
// [A, nkv, P, ps, hd] named by the sequence's row of the page table. What
// bounds it: every K and V row of the live range is read once and used for
// 4 * rep * hd operations, about 1 operation per byte at rep = 1, so bytes,
// at every GQA ratio the models use (Llama-2-7B, b=8, 2048 keys: 268 MB in
// bf16, 0.080 ms at 3.35 TB/s). The design keeps the bytes in flight with few
// threads and no per-key round trip:
//   - the key range is split across blocks (flash-decoding): grid (KV head,
//     sequence, run), a run a fixed number of whole pages (about 512 keys).
//     The plan comes from the shapes alone (paged_attention.py split_plan: b,
//     nkv, nq, hd, ps, the table width and the SM count): lengths are device
//     tensors and a decode step never syncs with the host. A run past the
//     live range or below the window start stores an empty state (m =
//     finfo.min, l = 0) and leaves at once;
//   - a page of one KV head is contiguous ([ps, hd] rows), so one producer
//     thread copies runs of whole K and V rows (8 KB each, and the fp32 scales
//     of int8 pools) with cp.async.bulk, addressed through the page table,
//     into a 4-stage mbarrier ring; a block holds ~64 KB, three blocks an SM
//     (a register bound keeps them at a query group of one). Rows whose bytes
//     break the 16-byte rules of a bulk copy (fp32 hd = 20 at ps = 12, int8
//     hd = 40, odd pages of int8 scales) are loaded by the producer warp's 32
//     lanes into the same stages, rows padded to 16 bytes;
//   - eight consumer warps score and accumulate from shared memory: `group`
//     lanes hold one key row as 8- or 16-byte vectors (so a warp reads whole
//     rows and no bank twice), the query group (up to 8 heads, which share one
//     read of K and V) in registers; a warp takes up to four steps of 32 / group
//     keys a batch: their dots, one shuffle tree for all of them, one max and
//     one rescale of its online softmax. Warps merge in warp order, runs in
//     run order: the last block of a (sequence, head) to finish (a ticket
//     counter, set back to 0) combines the runs' fp32 partial states. So the
//     result is the same bits on every run. What holds it back now: bf16 pools
//     stream at most of the card's rate; int8 pools spend more on converting
//     codes (two instructions a value) and scoring than on bytes.
// Rounding as the TPU kernel: fp32 scores of q / sqrt(hd) (times the key
// scale for int8 pools), then the softcap; p rounded to V's dtype for float
// pools, fp32 with the value scale folded in for int8 pools; the row sum
// takes p before either. Pool offsets are 64-bit (a Llama-2-7B pool of 512
// pages of 64 has 4.29e9 elements). A row with no key in range is 0.
//
// Write-and-attend (the decode step's layer: write the new token's K and V at
// slot pos = positions[i], then attend pos + 1 keys): the attention kernel
// above with the write folded in, one launch where the step made two. The
// write moves a few hundred KB, far under a launch's latency, so what the
// separate write cost was a launch and a wrapper call per layer and step. Key
// pos lies in exactly one run. In the block that owns it, the producer warp,
// once the ring's first copies are in flight, writes the K and V rows of its
// KV head to the pools (a slot outside the table goes to row 0 of trash page
// 0, which split 0 writes and no block scores) and the same values to a
// one-row stage in shared memory after the ring; consumer warp 0, after its
// stream, scores the key last from that stage (an mbarrier orders the two),
// as a later read of the pool would give it (pool dtype; int8 codes and their
// scale). The stream's loop is the attention's own. The block streams only
// [k_lo, pos), so nothing in the launch reads what it writes: the bulk copies
// need no proxy fence, and the last chunk may hold row pos only masked. Live
// sequences own disjoint pages, and prefix-cached pages are full and never
// written; dead slots (table rows zeroed) write and read trash page 0, and
// only their own rows read it.
//
// Write alone: one warp per (sequence, KV head) row writes hd elements (and,
// for int8 pools, the row's scale) at (layer, page_table[i, pos / ps], pos % ps),
// K and V in one launch, in place; nothing else of the pool is touched. Both
// write kernels quantize through kv_scale and kv_code.
#include "common.cuh"
#include "hopper.cuh"

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace ssp {
namespace {
using namespace ::ssp::hopper;

constexpr float kMin = -FLT_MAX;   // finfo(float32).min, the reference's mask value
constexpr int kWriteWarps = 4;

// Must match POOL_CODES in ops/kernels/build.py.
enum PoolType { kPoolF32 = 0, kPoolBF16 = 1, kPoolI8 = 2 };

template <typename T> __device__ __forceinline__ float as_float(T v);
template <> __device__ __forceinline__ float as_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// p as the second product sees it: rounded to V's dtype for float pools (the
// TPU kernel casts p to V's dtype), untouched fp32 for int8 pools.
template <typename T> __device__ __forceinline__ float round_like(float p) { return p; }
template <> __device__ __forceinline__ float round_like<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// The quantizer of int8 pools, per token and KV head, which both write
// kernels use: scale = amax / 127 (1 where amax == 0), code =
// clip(round-half-to-even(x / scale), +-127).
__device__ __forceinline__ float kv_scale(float amax) { return amax > 0.f ? amax / 127.0f : 1.0f; }
__device__ __forceinline__ int8_t kv_code(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

// One new row of hd elements into the pool row `dst` by the 32 lanes of a
// warp; int8 pools quantize it and store its scale at *dst_scale.
template <typename TN, typename TP>
__device__ __forceinline__ void write_row(const TN* src, TP* dst, float* dst_scale, int hd,
                                          int lane) {
  if constexpr (std::is_same<TP, int8_t>::value) {
    float amax = 0.f;
    for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(as_float<TN>(src[d])));
    const float sc = kv_scale(warp_max(amax));
    for (int d = lane; d < hd; d += 32) dst[d] = kv_code(as_float<TN>(src[d]), sc);
    if (lane == 0) *dst_scale = sc;
  } else {
    for (int d = lane; d < hd; d += 32) dst[d] = from_f<TP>(as_float<TN>(src[d]));
  }
}

namespace pa {
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // and one producer warp
constexpr int kStages = 4;
constexpr int kStageRowBytes = 8192;   // K (and V) bytes of one stage
constexpr int kMaxPagesPerSplit = 256;  // must match MAX_PAGES_PER_SPLIT in paged_attention.py

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* seq_lens;
  const int* start_lens;  // or null
  void* out;
  float* partial;         // [b, nkv, splits, rep * (hd + 2)] when splits > 1
  int* tickets;           // [b, nkv] when splits > 1, 0 on entry and on exit
  int nq, nkv, rep, hd, ps, mp;
  long long num_pages;
  int layer;
  float scale, softcap;
  int pps, splits;        // pages per split, splits
  int rows;               // key rows of one stage (a page in ceil(ps / rows) stages)
  int rs;                 // bytes of one K / V row in a stage (a multiple of 16)
  int group;              // lanes that hold one key row (a power of two)
  int stage_bytes;
  int bulk;               // the producer copies with cp.async.bulk (else element loads)
  // write-and-attend only: the new rows [b, nkv, hd] (fp32 when new_f32, else
  // bf16) and their slots; the keys are then [start, positions[i] + 1)
  const void* k_new;
  const void* v_new;
  const int* positions;
  int new_f32;
};

// Write-and-attend's shared memory after the ring: an mbarrier, then from
// byte 16 the one-row stage of the written key: K row, V row (rs bytes each,
// rs <= 256 elements), then the K and V scales of int8 pools.
template <typename TP>
constexpr int kNewStageBytes = 16 + 2 * 256 * static_cast<int>(sizeof(TP)) + 32;

// The producer warp of the block that owns slot `pos` of sequence i: the K
// and V rows of KV head h (hd <= 256) into the pools at that slot (row 0 of
// trash page 0 outside the table), and the same values into the one-row
// stage `st` (K row, V row rs bytes on, zeros past hd; the int8 scales after
// them). Every load is issued before the first store: one trip to memory.
template <typename TN, typename TP>
__device__ __forceinline__ void write_new_rows(const Params& p, int i, int h, int pos,
                                               unsigned char* st, int lane) {
  constexpr bool kQ8 = std::is_same<TP, int8_t>::value;
  constexpr int T = 256 / 32;  // elements of a row per lane
  const bool in_table = pos >= 0 && pos < p.mp * p.ps;
  const int j = in_table ? pos / p.ps : 0;
  const int phys = in_table ? p.page_table[static_cast<long long>(i) * p.mp + j] : 0;
  const long long src = (static_cast<long long>(i) * p.nkv + h) * p.hd;
  const TN* ksrc = static_cast<const TN*>(p.k_new) + src;
  const TN* vsrc = static_cast<const TN*>(p.v_new) + src;
  float kx[T], vx[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int d = lane + 32 * t;
    kx[t] = d < p.hd ? as_float<TN>(ksrc[d]) : 0.f;
    vx[t] = d < p.hd ? as_float<TN>(vsrc[d]) : 0.f;
  }
  const long long row =
      ((static_cast<long long>(p.layer) * p.nkv + h) * p.num_pages + phys) * p.ps +
      (in_table ? pos - j * p.ps : 0);
  TP* kd = const_cast<TP*>(static_cast<const TP*>(p.k_pool)) + row * p.hd;
  TP* vd = const_cast<TP*>(static_cast<const TP*>(p.v_pool)) + row * p.hd;
  TP* kc = reinterpret_cast<TP*>(st);
  TP* vc = reinterpret_cast<TP*>(st + p.rs);
  const int copy_len = p.rs / static_cast<int>(sizeof(TP));
  float sk = 1.f, sv = 1.f;
  if constexpr (kQ8) {
    float ak = 0.f, av = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      ak = fmaxf(ak, fabsf(kx[t]));
      av = fmaxf(av, fabsf(vx[t]));
    }
    sk = kv_scale(warp_max(ak));
    sv = kv_scale(warp_max(av));
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int d = lane + 32 * t;
    if (d < p.hd) {
      TP kq, vq;
      if constexpr (kQ8) {
        kq = kv_code(kx[t], sk);
        vq = kv_code(vx[t], sv);
      } else {
        kq = from_f<TP>(kx[t]);
        vq = from_f<TP>(vx[t]);
      }
      kd[d] = kq;
      vd[d] = vq;
      kc[d] = kq;
      vc[d] = vq;
    } else if (d < copy_len) {
      kc[d] = TP{};
      vc[d] = TP{};
    }
  }
  if (kQ8 && lane == 0) {
    const_cast<float*>(p.k_scale)[row] = sk;
    const_cast<float*>(p.v_scale)[row] = sv;
    float* scales = reinterpret_cast<float*>(st + 2 * p.rs);
    scales[0] = sk;
    scales[4] = sv;
  }
  __syncwarp();
}

// write_new_rows for the new rows' dtype (fp32 or bf16, a launch argument).
template <typename TP>
__device__ __forceinline__ void write_new(const Params& p, int i, int h, int pos,
                                          unsigned char* st, int lane) {
  if (p.new_f32)
    write_new_rows<float, TP>(p, i, h, pos, st, lane);
  else
    write_new_rows<__nv_bfloat16, TP>(p, i, h, pos, st, lane);
}

// A lane's vector of a row: 8 elements (bf16, int8) or 4 (fp32), read from
// shared memory as W 32-bit words and turned into floats (exactly).
template <typename TP> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4, BYTES = 16, W = 4;
  __device__ static void to_float(const uint32_t (&w)[W], float (&out)[N]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8, BYTES = 16, W = 4;
  __device__ static void to_float(const uint32_t (&w)[W], float (&out)[N]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 8, BYTES = 8, W = 2;
  // 0x4B000000 | u is the float 2^23 + u: with u = code + 128 (the xor), subtracting
  // 2^23 + 128 leaves the code
  __device__ static void to_float(const uint32_t (&w)[W], float (&out)[N]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) - 8388736.f;
    }
  }
};

template <int W>
__device__ __forceinline__ void load_words(const unsigned char* src, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x; w[1] = v.y;
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// Stage layout: K rows [rows][rs], V rows [rows][rs], then for int8 pools the
// K and V scales [rows] fp32 (each 16-byte aligned).
__host__ __device__ inline int scale_bytes(int rows) { return (rows * 4 + 15) / 16 * 16; }

// The ticket of a finished run of (sequence i, head h): true for the last of
// its splits to arrive, which sets the counter back to 0 for the next call.
__device__ __forceinline__ bool take_ticket(const Params& p, int i, int h) {
  int* ticket = p.tickets + static_cast<long long>(i) * p.nkv + h;
  __threadfence();
  const bool last = atomicAdd(ticket, 1) == p.splits - 1;
  if (last) {
    *ticket = 0;
    __threadfence();
  }
  return last;
}

// The last run of (sequence i, head h) combines the runs' partial states in
// split order: their weights exp(m_z - m) (0 for an empty run, whose values
// are never used) into shared memory `sm_w`, then each output element sums
// its runs' values. `nthreads` threads 0.. of the block take part.
template <typename TQ>
__device__ void combine(const Params& p, int i, int h, TQ* out, float* sm_w, int nthreads) {
  const int tid = threadIdx.x, n_out = p.rep * p.hd, stride = p.rep * (p.hd + 2);
  const float* part0 = p.partial + (static_cast<long long>(i) * p.nkv + h) * p.splits *
                                       static_cast<long long>(stride);
  if (tid < p.rep) {
    const int r = tid;
    float m_all = kMin;
#pragma unroll 8
    for (int z = 0; z < p.splits; ++z) {
      const float mz = __ldcg(part0 + static_cast<long long>(z) * stride + r);
      const float lz = __ldcg(part0 + static_cast<long long>(z) * stride + p.rep + r);
      if (lz > 0.f) m_all = fmaxf(m_all, mz);
    }
    float l_all = 0.f;
#pragma unroll 8
    for (int z = 0; z < p.splits; ++z) {
      const float mz = __ldcg(part0 + static_cast<long long>(z) * stride + r);
      const float lz = __ldcg(part0 + static_cast<long long>(z) * stride + p.rep + r);
      const float w = lz > 0.f ? expf(mz - m_all) : 0.f;
      l_all += lz * w;
      sm_w[z * p.rep + r] = w;
    }
    sm_w[p.splits * p.rep + r] = 1.f / fmaxf(l_all, 1e-30f);
  }
  asm volatile("bar.sync 2, %0;\n" ::"r"(nthreads) : "memory");
  for (int idx = tid; idx < n_out; idx += nthreads) {
    const int r = idx / p.hd;
    float o = 0.f;
#pragma unroll 8
    for (int z = 0; z < p.splits; ++z) {
      const float v = __ldcg(part0 + static_cast<long long>(z) * stride + 2 * p.rep + idx);
      const float w = sm_w[z * p.rep + r];
      o += w != 0.f ? v * w : 0.f;
    }
    out[idx] = from_f<TQ>(o * sm_w[p.splits * p.rep + r]);
  }
}

// grid (nkv, b, splits); a run with no live key leaves at once. Three blocks
// share an SM for a query group of one (the register bound keeps them).
// NV: vectors per lane and row (2 only for fp32 rows
// over 512 bytes); REP: query heads of the group the registers hold (>= rep);
// WRITE: write-and-attend (positions instead of seq_lens, see the note at the top).
template <typename TQ, typename TP, int NV, int REP, bool WRITE>
__global__ void __launch_bounds__(kThreads, REP == 1 ? 3 : 1)
    split_kernel(const Params p) {
  constexpr bool kQ8 = std::is_same<TP, int8_t>::value;
  using V = Vec<TP>;
  constexpr int VN = V::N;
  constexpr int U = REP >= 8 ? 1 : REP >= 4 ? 2 : 4;  // warp steps a batch (registers)
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int pages[kMaxPagesPerSplit];
  __shared__ float sm_m[kConsumerWarps][REP], sm_l[kConsumerWarps][REP];
  __shared__ int last_flag;
  // write-and-attend: after the ring, an mbarrier the writer's producer warp
  // arrives on once it has written the key's one-row stage (16 bytes on)
  unsigned char* const new_stage = smem + kStages * p.stage_bytes;
  uint64_t* const new_full = reinterpret_cast<uint64_t*>(new_stage);

  const int h = blockIdx.x, i = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int seq_len, pos = 0;
  if constexpr (WRITE) {
    pos = p.positions[i];
    seq_len = pos >= p.mp * p.ps ? p.mp * p.ps : pos + 1;
  } else {
    seq_len = min(p.seq_lens[i], p.mp * p.ps);
  }
  const int start = p.start_lens != nullptr ? max(p.start_lens[i], 0) : 0;
  const int span = p.pps * p.ps;
  bool writer = false, fold = false;  // fold: this block scores key pos from its stage
  if constexpr (WRITE) {
    const bool in_table = pos >= 0 && pos < p.mp * p.ps;
    writer = split == (in_table ? pos / span : 0);
    fold = writer && in_table && pos >= start;
  }
  const int k_lo = max(start, split * span), k_hi = min(seq_len, (split + 1) * span);
  const int k_end = fold ? pos : k_hi;  // the streamed keys are [k_lo, k_end)
  const int tid = threadIdx.x, n_out = p.rep * p.hd;
  if (k_lo >= k_end && !fold) {  // no key of this run is live: an empty state, and leave
    if constexpr (WRITE)
      if (writer && warp == 0) write_new<TP>(p, i, h, pos, new_stage + 16, lane);
    TQ* out = static_cast<TQ*>(p.out) + (static_cast<long long>(i) * p.nq + h * p.rep) * p.hd;
    if (p.splits == 1) {
      for (int idx = tid; idx < n_out; idx += kThreads) out[idx] = from_f<TQ>(0.f);
      return;
    }
    float* part = p.partial + ((static_cast<long long>(i) * p.nkv + h) * p.splits + split) *
                                  static_cast<long long>(p.rep) * (p.hd + 2);
    if (tid < p.rep) {
      part[tid] = kMin;
      part[p.rep + tid] = 0.f;
    }
    __syncthreads();
    if (tid == 0) last_flag = take_ticket(p, i, h);
    __syncthreads();
    if (last_flag) combine<TQ>(p, i, h, out, reinterpret_cast<float*>(smem), kThreads);
    return;
  }
  // the stages: chunks of `rows` rows of each page, in key order
  // (none when the block only scores its written key)
  const bool any = !WRITE || k_lo < k_end;
  const int cpp = (p.ps + p.rows - 1) / p.rows;
  const int j_lo = k_lo / p.ps, j_last = any ? (k_end - 1) / p.ps : j_lo - 1;
  const int c_lo = j_lo * cpp + (k_lo - j_lo * p.ps) / p.rows;
  const int c_n = any ? j_last * cpp + (k_end - 1 - j_last * p.ps) / p.rows - c_lo + 1 : 0;
  for (int j = j_lo + threadIdx.x; j <= j_last; j += kThreads)
    pages[j - j_lo] = p.page_table[static_cast<long long>(i) * p.mp + j];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], p.bulk ? 1 : 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    if constexpr (WRITE) mbar_init(new_full, 32);
    mbar_init_fence();
  }
  __syncthreads();
  const int stage_kv = p.rows * p.rs;
  const long long head_page0 = (static_cast<long long>(p.layer) * p.nkv + h) * p.num_pages;

  if (warp == kConsumerWarps) {  // the producer warp
    const TP* kp = static_cast<const TP*>(p.k_pool);
    const TP* vp = static_cast<const TP*>(p.v_pool);
    // stage n of the stream into ring slot n % kStages (bulk copies: lane 0 alone)
    const auto copy_stage = [&](int n) {
      const int s = n % kStages;
      const int c = c_lo + n, j = c / cpp, r0 = (c - j * cpp) * p.rows;
      const int rows = min(p.rows, p.ps - r0);
      const long long row0 = (head_page0 + pages[j - j_lo]) * p.ps + r0;  // pool row
      unsigned char* st = smem + s * p.stage_bytes;
      float* ks = reinterpret_cast<float*>(st + 2 * stage_kv);
      float* vs = reinterpret_cast<float*>(st + 2 * stage_kv + scale_bytes(p.rows));
      if (p.bulk) {
        const uint32_t kv = static_cast<uint32_t>(rows * p.rs);
        mbar_expect_tx(&full[s], 2 * kv + (kQ8 ? 8u * rows : 0u));
        bulk_load(st, kp + row0 * p.hd, kv, &full[s]);
        bulk_load(st + stage_kv, vp + row0 * p.hd, kv, &full[s]);
        if constexpr (kQ8) {
          bulk_load(ks, p.k_scale + row0, 4u * rows, &full[s]);
          bulk_load(vs, p.v_scale + row0, 4u * rows, &full[s]);
        }
        return;
      }
      // element loads into rows of rs bytes, zeros past hd
      const int rse = p.rs / static_cast<int>(sizeof(TP));
      TP* kd = reinterpret_cast<TP*>(st);
      TP* vd = reinterpret_cast<TP*>(st + stage_kv);
      for (int e = lane; e < rows * rse; e += 32) {
        const int r = e / rse, col = e - r * rse;
        const long long src = (row0 + r) * p.hd + col;
        kd[e] = col < p.hd ? kp[src] : TP{};
        vd[e] = col < p.hd ? vp[src] : TP{};
      }
      if constexpr (kQ8) {
        for (int r = lane; r < rows; r += 32) {
          ks[r] = p.k_scale[row0 + r];
          vs[r] = p.v_scale[row0 + r];
        }
      }
      mbar_arrive(&full[s]);
    };
    int n = 0;
    if constexpr (WRITE) {
      if (writer) {  // the write, behind the ring's first fill: off the consumers' way
        if (p.bulk && lane == 0)
          for (; n < min(c_n, kStages); ++n) copy_stage(n);
        __syncwarp();
        write_new<TP>(p, i, h, pos, new_stage + 16, lane);
        mbar_arrive(new_full);
      }
    }
    if (p.bulk && lane != 0) return;
    for (; n < c_n; ++n) {
      if (n >= kStages) mbar_wait(&empty[n % kStages], ((n / kStages) + 1) & 1);
      copy_stage(n);
    }
    return;
  }

  // consumers: lane group a holds key a of each warp step, lanes gl of it the
  // vectors gl, gl + G, ... of the row
  const int G = p.group, kpw = 32 / G, a = lane / G, gl = lane % G;
  const int nvec = p.rs / V::BYTES;
  float qv[REP][NV][VN];
  {
    const TQ* q = static_cast<const TQ*>(p.q) + (static_cast<long long>(i) * p.nq + h * p.rep) * p.hd;
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          const int d = (gl + v * G) * VN + e;
          qv[r][v][e] = r < p.rep && d < p.hd ? as_float<TQ>(q[r * p.hd + d]) * p.scale : 0.f;
        }
  }
  float m[REP], l[REP], acc[REP][NV][VN];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kMin;
    l[r] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[r][v][e] = 0.f;
  }

  for (int n = 0; n < c_n; ++n) {
    const int s = n % kStages;
    mbar_wait(&full[s], (n / kStages) & 1);
    const int c = c_lo + n, j = c / cpp, r0 = (c - j * cpp) * p.rows;
    const int rows = min(p.rows, p.ps - r0), key0 = j * p.ps + r0;
    const unsigned char* st = smem + s * p.stage_bytes;
    const float* ks = reinterpret_cast<const float*>(st + 2 * stage_kv);
    const float* vs = reinterpret_cast<const float*>(st + 2 * stage_kv + scale_bytes(p.rows));
    // U steps of kpw keys a batch: their dots, one shuffle tree, one max and
    // one rescale for all of them, then their values
    for (int kb = warp * kpw * U; kb < rows; kb += kConsumerWarps * kpw * U) {
      float sc[U][REP], vx[U][NV][VN], ksc[U], vsc[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kr = kb + u * kpw + a, key = key0 + kr;
        ok[u] = kr < rows && key >= k_lo && key < k_end;
        float kx[NV][VN];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int vi = gl + v * G;
          uint32_t kw[V::W], vw[V::W];
          if (kr < rows && vi < nvec) {
            load_words(st + kr * p.rs + vi * V::BYTES, kw);
            load_words(st + stage_kv + kr * p.rs + vi * V::BYTES, vw);
          } else {
#pragma unroll
            for (int w = 0; w < V::W; ++w) kw[w] = vw[w] = 0u;
          }
          V::to_float(kw, kx[v]);
          V::to_float(vw, vx[u][v]);
        }
        ksc[u] = kQ8 && kr < rows ? ks[kr] : 1.f;
        vsc[u] = kQ8 && kr < rows ? vs[kr] : 1.f;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < VN; ++e) dot = fmaf(qv[r][v][e], kx[v][e], dot);
          sc[u][r] = dot;
        }
      }
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < REP; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], o);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= p.rep) continue;
        float mx = kMin;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = kQ8 ? sc[u][r] * ksc[u] : sc[u][r];
          if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
          sc[u][r] = ok[u] ? dot : kMin;
          mx = fmaxf(mx, sc[u][r]);
        }
        for (int o = G; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        l[r] *= alpha;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[r][v][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pr = ok[u] ? expf(sc[u][r] - m_new) : 0.f;
          l[r] += pr;  // the row sum takes p before the value scale and the rounding
          const float pw = kQ8 ? pr * vsc[u] : round_like<TP>(pr);
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < VN; ++e) acc[r][v][e] = fmaf(pw, vx[u][v][e], acc[r][v][e]);
        }
        m[r] = m_new;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if constexpr (WRITE) {
    if (fold && warp == 0) {  // the written key, last: one key of the loop's update
      mbar_wait(new_full, 0);
      const unsigned char* st = new_stage + 16;
      float kx[NV][VN], vx[NV][VN];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = gl + v * G;
        uint32_t kw[V::W], vw[V::W];
        if (a == 0 && vi < nvec) {
          load_words(st + vi * V::BYTES, kw);
          load_words(st + p.rs + vi * V::BYTES, vw);
        } else {
#pragma unroll
          for (int w = 0; w < V::W; ++w) kw[w] = vw[w] = 0u;
        }
        V::to_float(kw, kx[v]);
        V::to_float(vw, vx[v]);
      }
      const float* scales = reinterpret_cast<const float*>(st + 2 * p.rs);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VN; ++e) dot = fmaf(qv[r][v][e], kx[v][e], dot);
        for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (r >= p.rep) continue;
        if (kQ8) dot *= scales[0];
        if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
        const float mx = __shfl_sync(0xffffffffu, dot, 0);
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        const float pr = a == 0 ? expf(mx - m_new) : 0.f;
        l[r] = l[r] * alpha + pr;
        const float pw = kQ8 ? pr * scales[4] : round_like<TP>(pr);
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[r][v][e] = fmaf(pw, vx[v][e], acc[r][v][e] * alpha);
        m[r] = m_new;
      }
    }
  }

  // the warp's lane groups, then the warps in order (the ring is free: every
  // stage was consumed)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    for (int o = G; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[r][v][e] += __shfl_xor_sync(0xffffffffu, acc[r][v][e], o);
    }
  }
  consumer_sync();
  TQ* out = static_cast<TQ*>(p.out) + (static_cast<long long>(i) * p.nq + h * p.rep) * p.hd;
  float* part = p.partial + ((static_cast<long long>(i) * p.nkv + h) * p.splits + split) *
                                static_cast<long long>(p.rep) * (p.hd + 2);
  float* sm_acc = reinterpret_cast<float*>(smem);  // [warps][rep][hd]
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= p.rep) continue;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          const int d = (gl + v * G) * VN + e;
          if (d < p.hd) sm_acc[(warp * p.rep + r) * p.hd + d] = acc[r][v][e];
        }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  consumer_sync();
  for (int idx = tid; idx < n_out + p.rep; idx += kConsumerWarps * 32) {
    const int r = idx < n_out ? idx / p.hd : idx - n_out;
    float m_all = kMin;
    for (int w = 0; w < kConsumerWarps; ++w) m_all = fmaxf(m_all, sm_m[w][r]);
    float l_all = 0.f, o = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float f = expf(sm_m[w][r] - m_all);
      l_all += sm_l[w][r] * f;
      if (idx < n_out) o += sm_acc[w * n_out + idx] * f;
    }
    if (p.splits == 1) {
      if (idx < n_out) out[idx] = from_f<TQ>(o * (1.f / fmaxf(l_all, 1e-30f)));
    } else if (idx < n_out) {
      part[2 * p.rep + idx] = o;
    } else {
      part[r] = m_all;
      part[p.rep + r] = l_all;
    }
  }
  if (p.splits == 1) return;
  __threadfence();
  consumer_sync();
  if (tid == 0) last_flag = take_ticket(p, i, h);
  consumer_sync();
  if (last_flag) combine<TQ>(p, i, h, out, reinterpret_cast<float*>(smem), kConsumerWarps * 32);
}

// Rows of one stage, their stride in shared memory, lanes per row and the
// producer's mode for these shapes and pointers.
template <typename TP>
Params layout(Params p) {
  constexpr bool kQ8 = std::is_same<TP, int8_t>::value;
  const auto al16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int row_bytes = p.hd * static_cast<int>(sizeof(TP));
  p.rs = (row_bytes + 15) / 16 * 16;
  p.rows = std::min(p.ps, std::max(1, kStageRowBytes / p.rs));
  p.bulk = row_bytes % 16 == 0 && al16(p.k_pool) && al16(p.v_pool);
  if (kQ8)
    p.bulk = p.bulk && p.ps % 4 == 0 && p.rows % 4 == 0 && al16(p.k_scale) && al16(p.v_scale);
  const int nvec = p.rs / Vec<TP>::BYTES;
  int g = 1;
  while (g < nvec && g < 32) g *= 2;
  p.group = g;
  p.stage_bytes = 2 * p.rows * p.rs + (kQ8 ? 2 * scale_bytes(p.rows) : 0);
  return p;
}

template <typename TQ, typename TP, int NV, int REP, bool WRITE>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const auto kernel = split_kernel<TQ, TP, NV, REP, WRITE>;
  // the ring (and the written key's stage after it), reused by the warps'
  // merge and the combine's split weights
  const size_t smem = std::max({(size_t)kStages * p.stage_bytes + (WRITE ? kNewStageBytes<TP> : 0),
                                (size_t)kConsumerWarps * p.rep * p.hd * sizeof(float),
                                (size_t)(p.splits + 1) * p.rep * sizeof(float)});
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_shared_blocks(kernel, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nkv, b, p.splits), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TP, int NV, bool WRITE>
cudaError_t dispatch_rep(const Params& p, int b, cudaStream_t stream) {
  // three group sizes keep the build short: a group of 2 or 3 runs as 4 (idle
  // registers, no extra bytes moved), 5 to 7 as 8
  if (p.rep <= 1) return launch<TQ, TP, NV, 1, WRITE>(p, b, stream);
  if (p.rep <= 4) return launch<TQ, TP, NV, 4, WRITE>(p, b, stream);
  return launch<TQ, TP, NV, 8, WRITE>(p, b, stream);
}

template <typename TQ, typename TP, bool WRITE>
cudaError_t dispatch(Params p, int b, cudaStream_t stream) {
  p = layout<TP>(p);
  const int nvec = p.rs / Vec<TP>::BYTES;
  if (nvec <= p.group) return dispatch_rep<TQ, TP, 1, WRITE>(p, b, stream);
  if constexpr (std::is_same<TP, float>::value)  // fp32 rows of 132-256 elements
    if (nvec <= 2 * p.group) return dispatch_rep<TQ, TP, 2, WRITE>(p, b, stream);
  return cudaErrorInvalidValue;
}

// Params of one call from the C entry points' arguments; false if the kernel
// does not take them.
inline bool make_params(Params& p, const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale, const void* page_table,
                        const void* seq_lens, const void* start_lens, void* out, int b, int nq,
                        int nkv, int hd, int ps, int mp, long long num_pages, int layer,
                        float scale, float softcap, int pages_per_split, int splits,
                        float* workspace, int* tickets) {
  if (b <= 0 || nkv <= 0 || hd <= 0 || hd > 256 || nq % nkv != 0 || nq / nkv > 8 || b > 65535 ||
      ps <= 0 || mp <= 0 || pages_per_split <= 0 || pages_per_split > kMaxPagesPerSplit ||
      splits <= 0 || splits > 65535 || (long long)pages_per_split * splits < mp ||
      (long long)mp * ps > 0x7fffffff || (splits > 1 && (workspace == nullptr || tickets == nullptr)))
    return false;
  p = Params{q, k_pool, v_pool, static_cast<const float*>(k_scale),
             static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
             static_cast<const int*>(seq_lens), static_cast<const int*>(start_lens), out,
             workspace, tickets, nq, nkv, nq / nkv, hd, ps, mp, num_pages, layer, scale,
             softcap, pages_per_split, splits};
  return true;
}

// The attention (WRITE: with the write) for the dtypes the kernels take.
template <bool WRITE>
cudaError_t dispatch_dtypes(int q_dtype, int pool_type, const Params& p, int b,
                            cudaStream_t stream) {
  if (pool_type == kPoolI8)  // an int8 cache computes in bf16
    return q_dtype == kBF16 ? dispatch<__nv_bfloat16, int8_t, WRITE>(p, b, stream)
                            : cudaErrorInvalidValue;
  if (q_dtype == kF32 && pool_type == kPoolF32) return dispatch<float, float, WRITE>(p, b, stream);
  if (q_dtype == kBF16 && pool_type == kPoolBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16, WRITE>(p, b, stream);
  return cudaErrorInvalidValue;
}
}  // namespace pa

template <typename TN, typename TP>
__global__ void __launch_bounds__(kWriteWarps * 32)
paged_pool_write_kernel(const TN* __restrict__ k_new, const TN* __restrict__ v_new,
                        TP* __restrict__ k_pool, TP* __restrict__ v_pool,
                        float* __restrict__ k_scale, float* __restrict__ v_scale,
                        const int* __restrict__ page_table, const int* __restrict__ positions,
                        int nkv, int hd, int ps, int mp, long long num_pages, int layer) {
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
  write_row<TN, TP>(src, pool + row * hd, pool_scale != nullptr ? pool_scale + row : nullptr, hd,
                    lane);
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
// queries; float pools have q's dtype. start_lens may be null (0); softcap <= 0
// means none. The keys are split into `splits` runs of `pages_per_split`
// pages; splits > 1 takes `workspace` (fp32, b * nkv * splits * rep * (hd + 2))
// and `tickets` (int32 [b * nkv], all 0; they are 0 again after the kernel).
// b <= 65535.
extern "C" int ssp_paged_attention(int q_dtype, int pool_type, const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* seq_lens,
                                   const void* start_lens, void* out, int b, int nq, int nkv,
                                   int hd, int ps, int mp, long long num_pages, int layer,
                                   float scale, float softcap, int pages_per_split, int splits,
                                   float* workspace, int* tickets, void* stream_ptr) {
  using namespace ssp;
  pa::Params p;
  if (seq_lens == nullptr ||
      !pa::make_params(p, q, k_pool, v_pool, k_scale, v_scale, page_table, seq_lens, start_lens,
                       out, b, nq, nkv, hd, ps, mp, num_pages, layer, scale, softcap,
                       pages_per_split, splits, workspace, tickets))
    return cudaErrorInvalidValue;
  return pa::dispatch_dtypes<false>(q_dtype, pool_type, p, b, static_cast<cudaStream_t>(stream_ptr));
}

// Write-and-attend, one launch: the K and V rows k_new / v_new [b, nkv, hd]
// (new_dtype, fp32 or bf16; int8 pools quantize them per token and KV head) go
// to slot positions[i] of sequence i in layer `layer` of the pools, as
// ssp_paged_pool_write writes them (a slot outside the table: row 0 of trash
// page 0), and out = the attention of ssp_paged_attention over the keys
// [start_lens[i], positions[i] + 1), the written key included. The other
// arguments are ssp_paged_attention's.
extern "C" int ssp_paged_attention_write(int q_dtype, int pool_type, int new_dtype, const void* q,
                                         const void* k_new, const void* v_new, void* k_pool,
                                         void* v_pool, void* k_scale, void* v_scale,
                                         const void* page_table, const void* positions,
                                         const void* start_lens, void* out, int b, int nq,
                                         int nkv, int hd, int ps, int mp, long long num_pages,
                                         int layer, float scale, float softcap,
                                         int pages_per_split, int splits, float* workspace,
                                         int* tickets, void* stream_ptr) {
  using namespace ssp;
  pa::Params p;
  if (k_new == nullptr || v_new == nullptr || positions == nullptr ||
      (new_dtype != kF32 && new_dtype != kBF16) ||
      !pa::make_params(p, q, k_pool, v_pool, k_scale, v_scale, page_table, nullptr, start_lens,
                       out, b, nq, nkv, hd, ps, mp, num_pages, layer, scale, softcap,
                       pages_per_split, splits, workspace, tickets))
    return cudaErrorInvalidValue;
  p.k_new = k_new;
  p.v_new = v_new;
  p.positions = static_cast<const int*>(positions);
  p.new_f32 = new_dtype == kF32;
  return pa::dispatch_dtypes<true>(q_dtype, pool_type, p, b, static_cast<cudaStream_t>(stream_ptr));
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
