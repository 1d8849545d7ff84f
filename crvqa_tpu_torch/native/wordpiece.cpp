// Native WordPiece encoder — the host-side bulk-tokenization fast path (the
// port's copy of crvqa_tpu/native/wordpiece.cpp, built by
// crvqa_tpu_torch/native/wordpiece.py).
//
// Implements exactly the ASCII subset of the BERT tokenization algorithm in
// crvqa_tpu_torch/data/tokenization.py (itself the vendored
// hg_transformers/tokenization_bert.py spec): clean (drop control chars,
// \t\n\r -> space), whitespace split, special-token passthrough, lowercase,
// punctuation split (the ASCII ranges 33-47/58-64/91-96/123-126), then
// greedy longest-match-first WordPiece with "##" continuations.
//
// Any input containing a non-ASCII byte (>= 0x80) is REJECTED (returns -1)
// so the Python implementation — which owns the unicode paths: NFD accent
// stripping, CJK isolation, unicode categories — handles it. VQA questions
// are overwhelmingly ASCII, so the C++ path carries the bulk startup
// tokenization of ~650k questions; equality with the Python tokenizer on
// both paths is tested in tests/test_torch_wordpiece.py.
//
// C ABI (ctypes; no pybind11 in this image):
//   void* wp_create(const char* vocab_blob, const char* specials_blob,
//                   int unk_id)
//   void  wp_destroy(void* h)
//   long  wp_encode_batch(void* h, const char** texts, long n, long cap,
//                         int* out_ids, long* out_lens)
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Handle {
  std::unordered_map<std::string, int> vocab;
  std::unordered_map<std::string, int> specials;  // token -> id
  int unk_id = 0;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// splits `blob` on '\n', inserting token -> running index (vocab order) or
// token -> vocab id (specials).
void split_blob(const char* blob, const Handle& lookup_in,
                std::unordered_map<std::string, int>* out, bool by_index) {
  const char* p = blob;
  int idx = 0;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
    if (len) {
      std::string tok(p, len);
      if (by_index) {
        out->emplace(std::move(tok), idx);
      } else {
        auto it = lookup_in.vocab.find(tok);
        if (it != lookup_in.vocab.end()) out->emplace(std::move(tok), it->second);
      }
    }
    ++idx;
    if (!nl) break;
    p = nl + 1;
  }
}

// Greedy longest-match-first WordPiece over one clean lowercase word.
// Appends ids; returns false only on internal overflow (never expected).
void wordpiece(const Handle& h, const std::string& word,
               std::vector<int>* out) {
  if (word.size() > 100) {
    out->push_back(h.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int match = -1;
    std::string sub;
    while (start < end) {
      sub.assign(start > 0 ? "##" : "");
      sub.append(word, start, end - start);
      auto it = h.vocab.find(sub);
      if (it != h.vocab.end()) {
        match = it->second;
        break;
      }
      --end;
    }
    if (match < 0) {
      out->push_back(h.unk_id);  // whole word -> [UNK]
      return;
    }
    pieces.push_back(match);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

// Returns -1 if the text needs the Python (unicode) path.
long encode_one(const Handle& h, const char* text, int* out_ids, long cap) {
  // pass 1: clean into a local buffer; reject non-ASCII
  std::string clean;
  for (const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
       *p; ++p) {
    unsigned char c = *p;
    if (c >= 0x80) return -1;          // unicode -> Python fallback
    if (c == '\t' || c == '\n' || c == '\r' || c == ' ') {
      clean.push_back(' ');
    } else if (c < 32 || c == 127) {
      // control chars dropped (tokenization.py:_clean)
    } else {
      clean.push_back(static_cast<char>(c));
    }
  }
  std::vector<int> ids;
  size_t i = 0, n = clean.size();
  std::string word;
  while (i < n) {
    while (i < n && clean[i] == ' ') ++i;
    size_t j = i;
    while (j < n && clean[j] != ' ') ++j;
    if (j > i) {
      word.assign(clean, i, j - i);
      auto sp = h.specials.find(word);  // exact match BEFORE lowercase
      if (sp != h.specials.end()) {
        ids.push_back(sp->second);
      } else {
        for (auto& ch : word)
          if (ch >= 'A' && ch <= 'Z') ch += 'a' - 'A';
        // punctuation split (tokenization.py:_split_punc)
        size_t s = 0;
        for (size_t k = 0; k <= word.size(); ++k) {
          bool brk = k == word.size() ||
                     is_ascii_punct(static_cast<unsigned char>(word[k]));
          if (brk) {
            if (k > s) wordpiece(h, word.substr(s, k - s), &ids);
            if (k < word.size()) wordpiece(h, word.substr(k, 1), &ids);
            s = k + 1;
          }
        }
      }
    }
    i = j;
  }
  long m = static_cast<long>(ids.size());
  if (m > cap) m = cap;
  std::memcpy(out_ids, ids.data(), m * sizeof(int));
  return m;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_blob, const char* specials_blob,
                int unk_id) {
  auto* h = new Handle();
  h->unk_id = unk_id;
  split_blob(vocab_blob, *h, &h->vocab, /*by_index=*/true);
  split_blob(specials_blob, *h, &h->specials, /*by_index=*/false);
  return h;
}

void wp_destroy(void* h) { delete static_cast<Handle*>(h); }

// out_ids: [n, cap] int32 row-major; out_lens[i]: ids written, or -1 when
// row i needs the Python fallback. Returns the number of fallback rows.
long wp_encode_batch(void* hv, const char** texts, long n, long cap,
                     int* out_ids, long* out_lens) {
  const Handle& h = *static_cast<Handle*>(hv);
  long fallbacks = 0;
  for (long i = 0; i < n; ++i) {
    long m = encode_one(h, texts[i], out_ids + i * cap, cap);
    out_lens[i] = m;
    if (m < 0) ++fallbacks;
  }
  return fallbacks;
}

}  // extern "C"
