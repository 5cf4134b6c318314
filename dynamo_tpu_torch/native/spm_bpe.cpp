// Native SentencePiece-BPE encoder (score-driven bigram merging).
//
// Copied from dynamo_tpu/native/spm_bpe.cpp: the C++ twin of
// dynamo_tpu_torch/llm/gguf.py _spm_encode, the tokenize hot path when
// serving llama / mistral / gemma GGUFs (the gpt2-model path is llm/bpe.py).
// Exact algorithm parity with the Python implementation: repeatedly merge
// the adjacent piece pair whose concatenation is a vocab token with the
// highest score (ties: leftmost), starting from single Unicode codepoints;
// unmatched pieces fall back to <0xXX> byte tokens, then unk.
//
// C ABI (ctypes, see native/spm.py):
//   spm_new(tok_blob, tok_offsets, n_tokens, scores, byte_ids, unk) -> handle
//   spm_encode(handle, text_utf8, text_len, out_ids, max_out) -> n_ids
//   spm_free(handle)
//
// The vocab blob is all token strings concatenated; offsets[i]..offsets[i+1]
// delimit token i (n_tokens+1 offsets). byte_ids is 256 ints (-1 = absent).

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Spm {
  std::unordered_map<std::string, int32_t> ids;
  std::vector<float> scores;
  int32_t byte_ids[256];
  int32_t unk;
};

struct HeapEnt {
  float score;    // higher merges first
  int32_t left;   // left piece index (ties: smaller index first)
  std::string merged;
};

struct HeapCmp {
  bool operator()(const HeapEnt& a, const HeapEnt& b) const {
    if (a.score != b.score) return a.score < b.score;  // max-heap on score
    return a.left > b.left;                            // then leftmost
  }
};

// split UTF-8 into codepoint-sized chunks (byte spans; invalid bytes pass
// through as single-byte pieces — the byte-fallback emits them verbatim)
void split_utf8(const char* s, int64_t n, std::vector<std::string>* out) {
  int64_t i = 0;
  while (i < n) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    int len = 1;
    if ((c & 0xF8) == 0xF0) len = 4;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xE0) == 0xC0) len = 2;
    if (i + len > n) len = 1;
    out->emplace_back(s + i, len);
    i += len;
  }
}

}  // namespace

extern "C" {

void* spm_new(const char* tok_blob, const int64_t* tok_offsets,
              int64_t n_tokens, const float* scores, const int32_t* byte_ids,
              int32_t unk) {
  Spm* h = new Spm();
  h->ids.reserve(static_cast<size_t>(n_tokens) * 2);
  h->scores.assign(scores, scores + n_tokens);
  for (int64_t i = 0; i < n_tokens; ++i) {
    std::string tok(tok_blob + tok_offsets[i],
                    tok_offsets[i + 1] - tok_offsets[i]);
    // first occurrence wins, matching dict(zip(tokens, ids)) lookup by
    // lowest id in the Python twin (later duplicates never shadow)
    h->ids.emplace(std::move(tok), static_cast<int32_t>(i));
  }
  std::memcpy(h->byte_ids, byte_ids, sizeof(h->byte_ids));
  h->unk = unk;
  return h;
}

void spm_free(void* handle) { delete static_cast<Spm*>(handle); }

int64_t spm_encode(void* handle, const char* text, int64_t text_len,
                   int32_t* out_ids, int64_t max_out) {
  Spm* h = static_cast<Spm*>(handle);
  std::vector<std::string> piece;
  split_utf8(text, text_len, &piece);
  const int64_t n = static_cast<int64_t>(piece.size());
  if (n == 0) return 0;

  std::vector<int64_t> nxt(n), prv(n);
  std::vector<char> alive(n, 1);
  for (int64_t i = 0; i < n; ++i) {
    nxt[i] = (i + 1 < n) ? i + 1 : -1;
    prv[i] = i - 1;
  }
  std::priority_queue<HeapEnt, std::vector<HeapEnt>, HeapCmp> heap;
  auto push = [&](int64_t i) {
    if (i < 0) return;
    int64_t j = nxt[i];
    if (j < 0) return;
    std::string merged = piece[i] + piece[j];
    auto it = h->ids.find(merged);
    if (it != h->ids.end())
      heap.push({h->scores[it->second], static_cast<int32_t>(i),
                 std::move(merged)});
  };
  for (int64_t i = 0; i + 1 < n; ++i) push(i);
  while (!heap.empty()) {
    HeapEnt e = heap.top();
    heap.pop();
    int64_t i = e.left;
    if (!alive[i]) continue;
    int64_t j = nxt[i];
    if (j < 0 || piece[i].size() + piece[j].size() != e.merged.size() ||
        piece[i] + piece[j] != e.merged)
      continue;  // stale: a neighbor already merged away
    piece[i] = std::move(e.merged);
    alive[j] = 0;
    nxt[i] = nxt[j];
    if (nxt[j] >= 0) prv[nxt[j]] = i;
    push(prv[i]);
    push(i);
  }

  int64_t count = 0;
  for (int64_t idx = 0; idx != -1; idx = nxt[idx]) {
    auto it = h->ids.find(piece[idx]);
    if (it != h->ids.end()) {
      if (count < max_out) out_ids[count] = it->second;
      ++count;
      continue;
    }
    bool got = false;
    for (unsigned char b : piece[idx]) {
      int32_t bid = h->byte_ids[b];
      if (bid >= 0) {
        if (count < max_out) out_ids[count] = bid;
        ++count;
        got = true;
      }
    }
    if (!got) {
      if (count < max_out) out_ids[count] = h->unk;
      ++count;
    }
  }
  return count;  // > max_out signals truncation (caller sizes 4*chars + 1)
}

}  // extern "C"
