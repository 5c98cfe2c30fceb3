// qrec_host: the port's host-side C++ library (plain C interface, loaded
// with ctypes by qrec_tpu_torch/native.py). Two host-bound paths:
//
//  1. the rating tokenizer: a rating file to dense first-appearance ids,
//     the names in that order and float32 ratings;
//  2. the weighted random walker of the walk models (CUNE_MF, CUNE_BPR):
//     xorshift128+ from a seed, one weighted step at a time over a CSR
//     graph.
//
// Both compute what the JAX package's native/qrec_native.cpp computes for
// the same input and seed, with two departures in the tokenizer: a '\r'
// is skipped like a delimiter (that library loops forever on a '\r'
// before the end of a line, so on every CRLF file), and a line with too
// few tokens or an unreadable rating is reported (its index after the
// header and its text) where that library skips it or reads 0, so that
// the caller raises as the plain Python parser does.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o <lib>.so qrec_host.cpp

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Rating tokenizer
// ---------------------------------------------------------------------------
// Tokens are the runs between [' ', ',', '\t'] (the reference's delimiter
// class, util/io.py:46); '\r' ends a token and is skipped. Columns u/i/r
// are selected (r < 0: every rating is 1); with ``binarize`` a record
// below ``threshold`` is dropped and the others get rating 1.

enum ParseStatus { kParsed = 0, kUnreadable = 1, kMalformed = 2 };

struct ParseResult {
  int status = kParsed;
  std::vector<int32_t> users;
  std::vector<int32_t> items;
  std::vector<float> ratings;
  std::string user_names;  // '\n'-joined, first-appearance order
  std::string item_names;
  int64_t n_users = 0;
  int64_t n_items = 0;
  int64_t bad_line = -1;  // index after the header of the first bad line
  std::string bad_text;
};

static inline bool is_delim(char c) {
  return c == ' ' || c == ',' || c == '\t' || c == '\r';
}

static bool read_file(const char* path, std::vector<char>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long size = ok ? ftell(f) : -1;
  ok = ok && size >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(size + 1);
    ok = fread(buf->data(), 1, size, f) == (size_t)size;
    (*buf)[size] = '\0';
    buf->resize(size);
  }
  fclose(f);
  return ok;
}

static int32_t intern(const std::string& name,
                      std::unordered_map<std::string, int32_t>* ids,
                      std::string* names) {
  auto it = ids->find(name);
  if (it != ids->end()) return it->second;
  int32_t id = (int32_t)ids->size();
  ids->emplace(name, id);
  *names += name;
  *names += '\n';
  return id;
}

void* qrec_host_parse(const char* path, int u_col, int i_col, int r_col,
                      int binarize, float threshold, int skip_header) {
  auto* res = new ParseResult();
  std::vector<char> buf;
  if (!read_file(path, &buf)) {
    res->status = kUnreadable;
    return res;
  }
  std::unordered_map<std::string, int32_t> user_ids, item_ids;
  user_ids.reserve(1 << 16);
  item_ids.reserve(1 << 16);

  const char* p = buf.data();
  const char* end = buf.data() + buf.size();
  int max_col = u_col > i_col ? u_col : i_col;
  if (r_col > max_col) max_col = r_col;
  std::vector<std::pair<const char*, int>> tokens;
  tokens.reserve(8);
  std::string rating_token;
  int64_t line_no = skip_header ? -1 : 0;

  for (; p < end; line_no++) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* line = p;
    p = line_end + 1;
    if (line_no < 0) continue;  // the header
    tokens.clear();
    const char* t = line;
    while (t < line_end) {
      while (t < line_end && is_delim(*t)) t++;
      const char* s = t;
      while (t < line_end && !is_delim(*t)) t++;
      if (t > s) tokens.push_back({s, (int)(t - s)});
    }
    bool ok = (int)tokens.size() > max_col;
    float rating = 1.0f;
    if (ok && r_col >= 0) {
      rating_token.assign(tokens[r_col].first, tokens[r_col].second);
      char* stop = nullptr;
      rating = strtof(rating_token.c_str(), &stop);
      ok = stop == rating_token.c_str() + rating_token.size();
    }
    if (!ok) {
      res->status = kMalformed;
      res->bad_line = line_no;
      res->bad_text.assign(line, line_end - line);
      break;
    }
    if (binarize) {
      if (rating < threshold) continue;
      rating = 1.0f;
    }
    std::string u(tokens[u_col].first, tokens[u_col].second);
    std::string i(tokens[i_col].first, tokens[i_col].second);
    res->users.push_back(intern(u, &user_ids, &res->user_names));
    res->items.push_back(intern(i, &item_ids, &res->item_names));
    res->ratings.push_back(rating);
  }
  res->n_users = (int64_t)user_ids.size();
  res->n_items = (int64_t)item_ids.size();
  return res;
}

// sizes[0..6]: records, users, items, bytes of the user names, of the item
// names, the bad line's index (-1 when none), its text's bytes; returns
// the status (0 parsed, 1 the file could not be read, 2 a bad line)
int qrec_host_parse_info(void* handle, int64_t* sizes) {
  auto* res = (ParseResult*)handle;
  sizes[0] = (int64_t)res->users.size();
  sizes[1] = res->n_users;
  sizes[2] = res->n_items;
  sizes[3] = (int64_t)res->user_names.size();
  sizes[4] = (int64_t)res->item_names.size();
  sizes[5] = res->bad_line;
  sizes[6] = (int64_t)res->bad_text.size();
  return res->status;
}

void qrec_host_parse_copy(void* handle, int32_t* users, int32_t* items,
                          float* ratings, char* user_names, char* item_names,
                          char* bad_text) {
  auto* res = (ParseResult*)handle;
  memcpy(users, res->users.data(), res->users.size() * sizeof(int32_t));
  memcpy(items, res->items.data(), res->items.size() * sizeof(int32_t));
  memcpy(ratings, res->ratings.data(), res->ratings.size() * sizeof(float));
  memcpy(user_names, res->user_names.data(), res->user_names.size());
  memcpy(item_names, res->item_names.data(), res->item_names.size());
  memcpy(bad_text, res->bad_text.data(), res->bad_text.size());
}

void qrec_host_parse_free(void* handle) { delete (ParseResult*)handle; }

// ---------------------------------------------------------------------------
// Weighted random walks over a CSR graph
// ---------------------------------------------------------------------------
// xorshift128+ seeded as the JAX package's library seeds it, so one seed
// gives the same walks in both packages.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ull + 1;
    s1 = (seed ^ 0xDEADBEEFCAFEBABEull) | 1;
    for (int k = 0; k < 8; k++) next();
  }
  inline uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  inline double uniform() {
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

// walks: (n_starts, walk_length) out. cum_weights: the cumulative sum of
// the CSR values over the whole array (double); a step draws target =
// base + u * total in the current row and takes the first entry whose
// cumulative weight exceeds it. A node with no edge stays in place.
void qrec_host_walks(const int32_t* indptr, const int32_t* indices,
                     const double* cum_weights, const int32_t* starts,
                     int64_t n_starts, int32_t walk_length, uint64_t seed,
                     int32_t* walks) {
  Rng rng(seed);
  for (int64_t w = 0; w < n_starts; w++) {
    int32_t cur = starts[w];
    int32_t* out = walks + w * walk_length;
    out[0] = cur;
    for (int32_t step = 1; step < walk_length; step++) {
      int32_t lo = indptr[cur], hi = indptr[cur + 1];
      if (hi <= lo) {
        out[step] = cur;
        continue;
      }
      double base = lo > 0 ? cum_weights[lo - 1] : 0.0;
      double total = cum_weights[hi - 1] - base;
      double target = base + rng.uniform() * total;
      int32_t a = lo, b = hi - 1;
      while (a < b) {
        int32_t mid = (a + b) >> 1;
        if (cum_weights[mid] <= target) a = mid + 1;
        else b = mid;
      }
      cur = indices[a];
      out[step] = cur;
    }
  }
}

}  // extern "C"
