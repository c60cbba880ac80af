// Native host runtime of leann_tpu_torch: the BM25 postings build.
//
// The graph and scan work runs on the GPU; what stays hot on the host at
// 1M-chunk scale is text processing. This library implements:
//
//   * BM25 corpus build: tokenization ([a-zA-Z0-9]+ runs, lowercased,
//     length > 1, the token grammar of index/bm25.py's `tokenize`) and
//     packed-postings construction. Its arrays equal the Python build's
//     exactly, so the `.bm25.npz` sidecar is the same whichever built it.
//   * JSONL line-offset scanning for the passage store.
//
// Exposed as a C ABI for ctypes (native/bm25_bridge.py). native/__init__.py
// compiles it on first use with
//   g++ -O3 -std=c++17 -shared -fPIC -o _build/libleann_native-<hash>.so
// where <hash> is the sha256 of this file.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Posting {
  int32_t doc;
  int32_t tf;
};

struct Bm25Index {
  // term -> postings, sorted by term at export time
  std::unordered_map<std::string, std::vector<Posting>> postings;
  std::vector<int32_t> doc_lengths;
  // cached export layout
  std::vector<const std::string*> sorted_terms;
  int64_t total_postings = 0;
  int64_t vocab_bytes = 0;

  void finalize() {
    sorted_terms.reserve(postings.size());
    for (auto& kv : postings) sorted_terms.push_back(&kv.first);
    std::sort(sorted_terms.begin(), sorted_terms.end(),
              [](const std::string* a, const std::string* b) { return *a < *b; });
    total_postings = 0;
    vocab_bytes = 0;
    for (auto* term : sorted_terms) {
      total_postings += static_cast<int64_t>(postings[*term].size());
      vocab_bytes += static_cast<int64_t>(term->size());
    }
  }
};

inline bool is_alnum_ascii(unsigned char c) {
  return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
         (c >= 'A' && c <= 'Z');
}

inline char lower_ascii(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c - 'A' + 'a')
                                : static_cast<char>(c);
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ BM25

// buf: UTF-8 concatenation of all documents; offsets: n_docs+1 int64
// boundaries into buf.
void* bm25_build(const char* buf, const int64_t* offsets, int64_t n_docs) {
  auto* index = new Bm25Index();
  index->doc_lengths.resize(static_cast<size_t>(n_docs));

  std::unordered_map<std::string, int32_t> tf;
  std::string token;
  for (int64_t d = 0; d < n_docs; ++d) {
    tf.clear();
    int32_t doc_len = 0;
    const char* p = buf + offsets[d];
    const char* end = buf + offsets[d + 1];
    while (p < end) {
      // skip to next alnum run
      while (p < end && !is_alnum_ascii(static_cast<unsigned char>(*p))) ++p;
      token.clear();
      while (p < end && is_alnum_ascii(static_cast<unsigned char>(*p))) {
        token.push_back(lower_ascii(static_cast<unsigned char>(*p)));
        ++p;
      }
      if (token.size() > 1) {  // single-char tokens dropped (bm25.rs:130)
        ++doc_len;
        ++tf[token];
      }
    }
    index->doc_lengths[static_cast<size_t>(d)] = doc_len;
    for (auto& kv : tf) {
      index->postings[kv.first].push_back(
          {static_cast<int32_t>(d), kv.second});
    }
  }
  index->finalize();
  return index;
}

int64_t bm25_vocab_size(void* h) {
  return static_cast<int64_t>(static_cast<Bm25Index*>(h)->sorted_terms.size());
}

int64_t bm25_total_postings(void* h) {
  return static_cast<Bm25Index*>(h)->total_postings;
}

int64_t bm25_vocab_bytes(void* h) {
  return static_cast<Bm25Index*>(h)->vocab_bytes;
}

// Copies the packed layout out:
//   vocab_buf      [vocab_bytes]   all terms concatenated (sorted)
//   vocab_offsets  [V+1]           boundaries into vocab_buf
//   post_offsets   [V+1]           boundaries into post_docs/post_tfs
//   post_docs      [P] int32
//   post_tfs       [P] int32
//   doc_lengths    [N] int32
void bm25_export(void* h, char* vocab_buf, int64_t* vocab_offsets,
                 int64_t* post_offsets, int32_t* post_docs,
                 int32_t* post_tfs, int32_t* doc_lengths) {
  auto* index = static_cast<Bm25Index*>(h);
  int64_t vb = 0, pp = 0;
  int64_t v = 0;
  vocab_offsets[0] = 0;
  post_offsets[0] = 0;
  for (auto* term : index->sorted_terms) {
    std::memcpy(vocab_buf + vb, term->data(), term->size());
    vb += static_cast<int64_t>(term->size());
    const auto& plist = index->postings[*term];
    for (const auto& post : plist) {
      post_docs[pp] = post.doc;
      post_tfs[pp] = post.tf;
      ++pp;
    }
    ++v;
    vocab_offsets[v] = vb;
    post_offsets[v] = pp;
  }
  std::memcpy(doc_lengths, index->doc_lengths.data(),
              index->doc_lengths.size() * sizeof(int32_t));
}

void bm25_free(void* h) { delete static_cast<Bm25Index*>(h); }

// ------------------------------------------------------- JSONL scanning

// Returns the number of line-start offsets written (lines beginning
// before buf+len). out must have room for max_out entries.
int64_t scan_line_offsets(const char* buf, int64_t len, int64_t* out,
                          int64_t max_out) {
  int64_t count = 0;
  if (len <= 0) return 0;
  if (count < max_out) out[count++] = 0;
  for (int64_t i = 0; i + 1 < len; ++i) {
    if (buf[i] == '\n') {
      if (count >= max_out) break;
      out[count++] = i + 1;
    }
  }
  return count;
}

}  // extern "C"
