// Heap-based BPE merge engine, O(n log n) per word.
//
// A word is a doubly linked list of symbols; every adjacent pair that has a
// merge sits in a min-heap keyed by (rank, position). Popping the top merges
// the pair in place, marks the right symbol removed and pushes the pairs the
// new symbol forms with its neighbours; a popped entry whose pair has changed
// since it was pushed is skipped. This is the order of HF tokenizers'
// `Word::merge_all`: lowest rank first, then the leftmost position. Unlike
// the rescanning loop of native/bpe.cc, a word of 10^6 symbols (a whole
// corpus when the tokenizer has no pre-tokenizer) merges in about a second.
//
// The merge table maps (left id, right id) -> (rank, merged id). Ranks need
// not be distinct: SentencePiece's score order gives equal-scored pieces one
// rank, and the position breaks the tie.
//
// Used by ssp_x_vit_tpu_torch/llm/hf_tokenizer.py through ctypes (C ABI).

#include <cstddef>
#include <cstdint>
#include <queue>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct Engine {
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> merges;
};

inline uint64_t pair_key(int32_t l, int32_t r) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(l)) << 32) |
         static_cast<uint32_t>(r);
}

struct Entry {
  int32_t rank;
  int64_t pos;
  int32_t merged;
};

// std::priority_queue pops the largest: invert so the lowest rank, then the
// lowest position, comes first.
struct Later {
  bool operator()(const Entry& a, const Entry& b) const {
    if (a.rank != b.rank) return a.rank > b.rank;
    return a.pos > b.pos;
  }
};

struct Symbol {
  int32_t id;
  int64_t prev;
  int64_t next;
  bool removed;
};

void merge_word(const Engine& e, const int32_t* syms, int64_t n, std::vector<int32_t>& out) {
  std::vector<Symbol> s(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) s[i] = {syms[i], i - 1, i + 1 < n ? i + 1 : -1, false};
  std::priority_queue<Entry, std::vector<Entry>, Later> heap;
  auto push = [&](int64_t pos) {
    const int64_t nx = s[pos].next;
    if (nx < 0) return;
    auto it = e.merges.find(pair_key(s[pos].id, s[nx].id));
    if (it != e.merges.end()) heap.push({it->second.first, pos, it->second.second});
  };
  for (int64_t i = 0; i + 1 < n; ++i) push(i);
  while (!heap.empty()) {
    const Entry top = heap.top();
    heap.pop();
    Symbol& left = s[top.pos];
    if (left.removed || left.next < 0) continue;
    const int64_t right_pos = left.next;
    auto it = e.merges.find(pair_key(left.id, s[right_pos].id));
    if (it == e.merges.end() || it->second.second != top.merged) continue;  // stale
    left.id = top.merged;
    s[right_pos].removed = true;
    left.next = s[right_pos].next;
    if (left.next >= 0) s[left.next].prev = top.pos;
    if (left.prev >= 0) push(left.prev);
    push(top.pos);
  }
  for (int64_t i = 0; i < n; ++i)
    if (!s[i].removed) out.push_back(s[i].id);
}

}  // namespace

extern "C" {

void* bpe_heap_init(int64_t n_merges, const int32_t* left, const int32_t* right,
                    const int32_t* rank, const int32_t* merged) {
  auto* e = new Engine();
  e->merges.reserve(static_cast<size_t>(n_merges) * 2);
  // a pair listed twice keeps its last entry, as HF's merge map does
  for (int64_t i = 0; i < n_merges; ++i)
    e->merges[pair_key(left[i], right[i])] = {rank[i], merged[i]};
  return e;
}

void bpe_heap_free(void* h) { delete static_cast<Engine*>(h); }

// Merge a batch of words.
//   syms:        flattened initial symbol ids
//   offsets:     [n_words + 1] word boundaries into syms
//   out:         output ids, capacity >= offsets[n_words]
//   out_offsets: [n_words + 1] word boundaries into out
// Returns the total output length.
int64_t bpe_heap_encode_batch(void* h, const int32_t* syms, const int64_t* offsets,
                              int64_t n_words, int32_t* out, int64_t* out_offsets) {
  const auto* e = static_cast<const Engine*>(h);
  std::vector<int32_t> buf;
  int64_t w = 0;
  for (int64_t wi = 0; wi < n_words; ++wi) {
    buf.clear();
    merge_word(*e, syms + offsets[wi], offsets[wi + 1] - offsets[wi], buf);
    out_offsets[wi] = w;
    for (int32_t id : buf) out[w++] = id;
  }
  out_offsets[n_words] = w;
  return w;
}

}  // extern "C"
