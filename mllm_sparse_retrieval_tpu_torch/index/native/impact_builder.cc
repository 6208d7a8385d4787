// impact_builder.cc — native host-side builder for the port's impact index
// (the port's own copy of the JAX package's builder; same layouts).
//
// Parses the corpus jsonl ({"id": ..., "content": "", "vector": {term:
// int_weight, ...}} a line, the format the encode pipeline writes), assigns
// compact term ids in order of first appearance, and emits
//   - packed doc-major arrays [N, Kmax] (term idx + weight, zero padded),
//   - impact-ordered CSR postings (per term, (doc, weight) by descending
//     weight, ascending doc on ties).
// The Python side (index/impact.py) then relabels terms hot-first, as it
// does for its own builder, so both give one layout.
//
// A plain C ABI for ctypes; index/native/__init__.py builds it with one
// g++ call at first use.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Posting {
  int32_t term;
  int32_t doc;
  float weight;
};

struct Builder {
  std::unordered_map<std::string, int32_t> term_to_idx;
  std::vector<std::string> term_keys;
  std::vector<std::string> doc_ids;
  std::vector<std::vector<std::pair<int32_t, float>>> doc_vectors;

  // finalized layouts
  bool finalized = false;
  int32_t k_max = 1;
  std::vector<int32_t> doc_terms;     // [N * k_max]
  std::vector<float> doc_weights;     // [N * k_max]
  std::vector<int64_t> csr_offsets;   // [T + 1]
  std::vector<int32_t> csr_docs;      // [nnz]
  std::vector<float> csr_weights;     // [nnz]

  int32_t intern(const std::string& key) {
    auto it = term_to_idx.find(key);
    if (it != term_to_idx.end()) return it->second;
    int32_t idx = static_cast<int32_t>(term_keys.size());
    term_to_idx.emplace(key, idx);
    term_keys.push_back(key);
    return idx;
  }
};

// --- minimal JSON scanning specialized to the corpus line shape -------------
//
// We need: the value of "id" (string or number) and the flat object under
// "vector" whose values are integers. Strings may contain standard JSON
// escapes; \uXXXX is decoded to UTF-8 (term strings are lowercased vocab
// pieces and may contain arbitrary unicode).

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
  return p;
}

void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Parse a JSON string starting at '"'; advances p past the closing quote.
bool parse_string(const char*& p, const char* end, std::string& out) {
  if (p >= end || *p != '"') return false;
  ++p;
  out.clear();
  while (p < end && *p != '"') {
    if (*p == '\\') {
      ++p;
      if (p >= end) return false;
      switch (*p) {
        case '"': out.push_back('"'); break;
        case '\\': out.push_back('\\'); break;
        case '/': out.push_back('/'); break;
        case 'b': out.push_back('\b'); break;
        case 'f': out.push_back('\f'); break;
        case 'n': out.push_back('\n'); break;
        case 'r': out.push_back('\r'); break;
        case 't': out.push_back('\t'); break;
        case 'u': {
          if (end - p < 5) return false;
          uint32_t cp = 0;
          for (int i = 1; i <= 4; ++i) {
            char c = p[i];
            cp <<= 4;
            if (c >= '0' && c <= '9') cp |= c - '0';
            else if (c >= 'a' && c <= 'f') cp |= c - 'a' + 10;
            else if (c >= 'A' && c <= 'F') cp |= c - 'A' + 10;
            else return false;
          }
          p += 4;
          // surrogate pair
          if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 7 &&
              p[1] == '\\' && p[2] == 'u') {
            uint32_t lo = 0;
            bool ok = true;
            for (int i = 3; i <= 6; ++i) {
              char c = p[i];
              lo <<= 4;
              if (c >= '0' && c <= '9') lo |= c - '0';
              else if (c >= 'a' && c <= 'f') lo |= c - 'a' + 10;
              else if (c >= 'A' && c <= 'F') lo |= c - 'A' + 10;
              else { ok = false; break; }
            }
            if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              p += 6;
            }
          }
          append_utf8(out, cp);
          break;
        }
        default: return false;
      }
      ++p;
    } else {
      out.push_back(*p);
      ++p;
    }
  }
  if (p >= end) return false;
  ++p;  // closing quote
  return true;
}

// Parse a JSON number (we only need the integral/rounded value).
bool parse_number(const char*& p, const char* end, double& out) {
  char buf[64];
  int n = 0;
  while (p < end && n < 63 &&
         (*p == '-' || *p == '+' || *p == '.' || *p == 'e' || *p == 'E' ||
          (*p >= '0' && *p <= '9'))) {
    buf[n++] = *p++;
  }
  if (n == 0) return false;
  buf[n] = '\0';
  out = strtod(buf, nullptr);
  return true;
}

// Skip any JSON value (used for "content" and unknown keys).
bool skip_value(const char*& p, const char* end);

bool skip_object_or_array(const char*& p, const char* end, char open, char close) {
  int depth = 0;
  while (p < end) {
    if (*p == '"') {
      std::string tmp;
      if (!parse_string(p, end, tmp)) return false;
      continue;
    }
    if (*p == open) ++depth;
    if (*p == close) {
      --depth;
      if (depth == 0) { ++p; return true; }
    }
    ++p;
  }
  return false;
}

bool skip_value(const char*& p, const char* end) {
  p = skip_ws(p, end);
  if (p >= end) return false;
  if (*p == '"') { std::string tmp; return parse_string(p, end, tmp); }
  if (*p == '{') return skip_object_or_array(p, end, '{', '}');
  if (*p == '[') return skip_object_or_array(p, end, '[', ']');
  if (*p == 't' || *p == 'f' || *p == 'n') {
    while (p < end && *p != ',' && *p != '}' && *p != ']') ++p;
    return true;
  }
  double d;
  return parse_number(p, end, d);
}

// Parse one corpus line. Returns false on malformed input.
bool parse_line(Builder& b, const char* p, const char* end) {
  p = skip_ws(p, end);
  if (p >= end || *p != '{') return false;
  ++p;
  std::string doc_id;
  std::vector<std::pair<int32_t, float>> vec;
  std::string key, term;
  bool have_id = false;
  while (true) {
    p = skip_ws(p, end);
    if (p < end && *p == '}') break;
    if (!parse_string(p, end, key)) return false;
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return false;
    ++p;
    p = skip_ws(p, end);
    if (key == "id") {
      if (p < end && *p == '"') {
        if (!parse_string(p, end, doc_id)) return false;
      } else {
        double d;
        if (!parse_number(p, end, d)) return false;
        char buf[32];
        snprintf(buf, sizeof buf, "%lld", static_cast<long long>(d));
        doc_id = buf;
      }
      have_id = true;
    } else if (key == "vector") {
      if (p >= end || *p != '{') return false;
      ++p;
      while (true) {
        p = skip_ws(p, end);
        if (p < end && *p == '}') { ++p; break; }
        if (!parse_string(p, end, term)) return false;
        p = skip_ws(p, end);
        if (p >= end || *p != ':') return false;
        ++p;
        p = skip_ws(p, end);
        double w;
        if (!parse_number(p, end, w)) return false;
        if (w > 0) vec.emplace_back(b.intern(term), static_cast<float>(w));
        p = skip_ws(p, end);
        if (p < end && *p == ',') ++p;
      }
    } else {
      if (!skip_value(p, end)) return false;
    }
    p = skip_ws(p, end);
    if (p < end && *p == ',') { ++p; continue; }
  }
  if (!have_id) return false;
  b.doc_ids.push_back(std::move(doc_id));
  b.doc_vectors.push_back(std::move(vec));
  return true;
}

}  // namespace

extern "C" {

void* ib_create() { return new Builder(); }

void ib_destroy(void* h) { delete static_cast<Builder*>(h); }

// Feed newline-delimited JSON documents. Returns docs added, -1 on parse error.
long ib_add_jsonl(void* h, const char* data, long len) {
  Builder& b = *static_cast<Builder*>(h);
  const char* p = data;
  const char* end = data + len;
  long added = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* q = skip_ws(p, line_end);
    if (q < line_end) {
      if (!parse_line(b, p, line_end)) return -1;
      ++added;
    }
    p = nl ? nl + 1 : end;
  }
  b.finalized = false;
  return added;
}

// Add one document programmatically: term idx array + weights.
void ib_add_doc(void* h, const char* doc_id, const char* const* terms,
                const double* weights, int n) {
  Builder& b = *static_cast<Builder*>(h);
  std::vector<std::pair<int32_t, float>> vec;
  vec.reserve(n);
  for (int i = 0; i < n; ++i) {
    if (weights[i] > 0)
      vec.emplace_back(b.intern(terms[i]), static_cast<float>(weights[i]));
  }
  b.doc_ids.push_back(doc_id);
  b.doc_vectors.push_back(std::move(vec));
  b.finalized = false;
}

void ib_finalize(void* h) {
  Builder& b = *static_cast<Builder*>(h);
  if (b.finalized) return;
  const size_t n = b.doc_vectors.size();
  size_t k_max = 1, nnz = 0;
  for (const auto& v : b.doc_vectors) {
    k_max = std::max(k_max, v.size());
    nnz += v.size();
  }
  b.k_max = static_cast<int32_t>(k_max);
  b.doc_terms.assign(n * k_max, 0);
  b.doc_weights.assign(n * k_max, 0.0f);

  std::vector<Posting> postings;
  postings.reserve(nnz);
  for (size_t i = 0; i < n; ++i) {
    const auto& v = b.doc_vectors[i];
    for (size_t j = 0; j < v.size(); ++j) {
      b.doc_terms[i * k_max + j] = v[j].first;
      b.doc_weights[i * k_max + j] = v[j].second;
      postings.push_back({v[j].first, static_cast<int32_t>(i), v[j].second});
    }
  }
  // impact order: term asc, weight desc, doc asc for determinism
  std::sort(postings.begin(), postings.end(),
            [](const Posting& a, const Posting& c) {
              if (a.term != c.term) return a.term < c.term;
              if (a.weight != c.weight) return a.weight > c.weight;
              return a.doc < c.doc;
            });
  const size_t t = b.term_keys.size();
  b.csr_offsets.assign(t + 1, 0);
  b.csr_docs.resize(postings.size());
  b.csr_weights.resize(postings.size());
  for (size_t i = 0; i < postings.size(); ++i) {
    b.csr_offsets[postings[i].term + 1]++;
    b.csr_docs[i] = postings[i].doc;
    b.csr_weights[i] = postings[i].weight;
  }
  std::partial_sum(b.csr_offsets.begin(), b.csr_offsets.end(),
                   b.csr_offsets.begin());
  b.finalized = true;
}

long ib_num_docs(void* h) { return static_cast<Builder*>(h)->doc_ids.size(); }
long ib_num_terms(void* h) { return static_cast<Builder*>(h)->term_keys.size(); }
long ib_nnz(void* h) { return static_cast<Builder*>(h)->csr_docs.size(); }
int ib_kmax(void* h) { return static_cast<Builder*>(h)->k_max; }

void ib_get_doc_terms(void* h, int32_t* out) {
  Builder& b = *static_cast<Builder*>(h);
  memcpy(out, b.doc_terms.data(), b.doc_terms.size() * sizeof(int32_t));
}

void ib_get_doc_weights(void* h, float* out) {
  Builder& b = *static_cast<Builder*>(h);
  memcpy(out, b.doc_weights.data(), b.doc_weights.size() * sizeof(float));
}

void ib_get_csr_offsets(void* h, int64_t* out) {
  Builder& b = *static_cast<Builder*>(h);
  memcpy(out, b.csr_offsets.data(), b.csr_offsets.size() * sizeof(int64_t));
}

void ib_get_csr_docs(void* h, int32_t* out) {
  Builder& b = *static_cast<Builder*>(h);
  memcpy(out, b.csr_docs.data(), b.csr_docs.size() * sizeof(int32_t));
}

void ib_get_csr_weights(void* h, float* out) {
  Builder& b = *static_cast<Builder*>(h);
  memcpy(out, b.csr_weights.data(), b.csr_weights.size() * sizeof(float));
}

// Term keys / doc ids serialized as concatenated bytes + a lengths array
// (term strings can contain ANY byte, including newlines — vocab pieces are
// arbitrary unicode).
static size_t total_bytes(const std::vector<std::string>& v) {
  size_t total = 0;
  for (const auto& s : v) total += s.size();
  return total;
}

static void copy_concat(const std::vector<std::string>& v, char* out,
                        int64_t* lengths) {
  size_t pos = 0;
  for (size_t i = 0; i < v.size(); ++i) {
    memcpy(out + pos, v[i].data(), v[i].size());
    pos += v[i].size();
    lengths[i] = static_cast<int64_t>(v[i].size());
  }
}

long ib_terms_bytes(void* h) {
  return static_cast<long>(total_bytes(static_cast<Builder*>(h)->term_keys));
}

void ib_get_terms(void* h, char* out, int64_t* lengths) {
  copy_concat(static_cast<Builder*>(h)->term_keys, out, lengths);
}

long ib_docids_bytes(void* h) {
  return static_cast<long>(total_bytes(static_cast<Builder*>(h)->doc_ids));
}

void ib_get_docids(void* h, char* out, int64_t* lengths) {
  copy_concat(static_cast<Builder*>(h)->doc_ids, out, lengths);
}

}  // extern "C"
