// Host-side dictionary encoder for string ingest (the port's copy of the
// JAX package's native/ballista_native.cpp, with 64-bit offsets).
//
// A string column is a byte buffer and, per row, the span [start, end) of
// its bytes: an arrow string or large_string array (start = offsets[i],
// end = offsets[i + 1]) or a `.tbl` column's field spans. Bytes compare as
// unsigned chars, which is the code-point order of UTF-8 text, the order
// of the engine's sorted dictionaries.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (ballista_tpu_torch/native.py
// builds it at first use).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <vector>

namespace {

inline std::string_view view(const uint8_t* data, int64_t s, int64_t e) {
  return std::string_view(reinterpret_cast<const char*>(data) + s,
                          static_cast<size_t>(e - s));
}

inline uint64_t load_word(const uint8_t* p, int64_t len) {
  uint64_t w = 0;
  std::memcpy(&w, p, static_cast<size_t>(len < 8 ? len : 8));
  return w;
}

// A hash of a string's bytes, eight at a time.
inline uint64_t hash_bytes(const uint8_t* p, int64_t len) {
  uint64_t h = 0x9E3779B97F4A7C15ull ^ static_cast<uint64_t>(len);
  for (int64_t i = 0; i < len; i += 8) {
    h = (h ^ load_word(p + i, len - i)) * 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
  }
  h *= 0xC4CEB9FE1A85EC53ull;
  return h ^ (h >> 29);
}

// The first 8 bytes, big-endian, zero-padded: their order is the bytes'.
inline uint64_t prefix_of(const uint8_t* p, int64_t len) {
  uint64_t v = 0;
  const int64_t k = len < 8 ? len : 8;
  for (int64_t i = 0; i < k; i++) v |= uint64_t(p[i]) << (56 - 8 * i);
  return v;
}

}  // namespace

extern "C" {

// Encode n strings against their own sorted dictionary.
//   codes_out[n]       : the dictionary code of each row
//   dict_rows_out[<=n] : the first row holding each distinct value, the
//                        dictionary in sorted order
// Returns the dictionary's size. The distinct values are found first with
// an open-addressing hash table (a column of few values never sorts its
// rows), then only they are sorted.
int64_t bt_dict_encode(const uint8_t* data, const int64_t* starts,
                       const int64_t* ends, int64_t n, int32_t* codes_out,
                       int64_t* dict_rows_out) {
  if (n == 0) return 0;
  std::vector<int64_t> first;      // distinct id -> its first row
  std::vector<uint64_t> hashes;    // distinct id -> hash
  std::vector<int32_t> slots(1024, -1);
  uint64_t mask = slots.size() - 1;
  for (int64_t i = 0; i < n; i++) {
    const int64_t len = ends[i] - starts[i];
    const uint8_t* p = data + starts[i];
    const uint64_t h = hash_bytes(p, len);
    uint64_t at = h & mask;
    int32_t id;
    while (true) {
      id = slots[at];
      if (id < 0) {
        id = static_cast<int32_t>(first.size());
        slots[at] = id;
        first.push_back(i);
        hashes.push_back(h);
        break;
      }
      const int64_t r = first[id];
      if (hashes[id] == h && ends[r] - starts[r] == len &&
          std::memcmp(data + starts[r], p, static_cast<size_t>(len)) == 0)
        break;
      at = (at + 1) & mask;
    }
    codes_out[i] = id;
    if (2 * first.size() > slots.size()) {  // keep the load under 1/2
      std::vector<int32_t> grown(slots.size() * 2, -1);
      mask = grown.size() - 1;
      for (size_t d = 0; d < first.size(); d++) {
        uint64_t a = hashes[d] & mask;
        while (grown[a] >= 0) a = (a + 1) & mask;
        grown[a] = static_cast<int32_t>(d);
      }
      slots.swap(grown);
    }
  }
  // sort the distinct values by their first 16 bytes (two big-endian
  // words, zero-padded, kept beside the id so the sort stays in cache),
  // then the length where one ends within them, then the bytes past them
  struct Key {
    uint64_t p0, p1;
    int64_t id;
  };
  const int64_t nd = static_cast<int64_t>(first.size());
  std::vector<Key> keys(nd);
  for (int64_t d = 0; d < nd; d++) {
    const int64_t r = first[d], len = ends[r] - starts[r];
    const uint8_t* p = data + starts[r];
    keys[d] = {prefix_of(p, len), len > 8 ? prefix_of(p + 8, len - 8) : 0, d};
  }
  std::sort(keys.begin(), keys.end(), [&](const Key& a, const Key& b) {
    if (a.p0 != b.p0) return a.p0 < b.p0;
    if (a.p1 != b.p1) return a.p1 < b.p1;
    const int64_t ra = first[a.id], rb = first[b.id];
    const int64_t la = ends[ra] - starts[ra], lb = ends[rb] - starts[rb];
    if (la <= 16 || lb <= 16) return la < lb;
    return view(data, starts[ra] + 16, ends[ra]) <
           view(data, starts[rb] + 16, ends[rb]);
  });
  std::vector<int32_t> order(nd);
  for (int64_t k = 0; k < nd; k++) order[k] = static_cast<int32_t>(keys[k].id);
  std::vector<int32_t> rank(nd);
  for (int64_t k = 0; k < nd; k++) {
    rank[order[k]] = static_cast<int32_t>(k);
    dict_rows_out[k] = first[order[k]];
  }
  for (int64_t i = 0; i < n; i++) codes_out[i] = rank[codes_out[i]];
  return nd;
}

// Encode n strings against a sorted dictionary of dict_n values (bytes
// dict_data, 64-bit offsets dict_offsets[dict_n + 1]). A value the
// dictionary does not hold gets code -1. Returns 0.
int64_t bt_dict_encode_against(const uint8_t* data, const int64_t* starts,
                               const int64_t* ends, int64_t n,
                               const uint8_t* dict_data,
                               const int64_t* dict_offsets, int64_t dict_n,
                               int32_t* codes_out) {
  std::vector<std::string_view> dict(dict_n);
  for (int64_t i = 0; i < dict_n; i++)
    dict[i] = view(dict_data, dict_offsets[i], dict_offsets[i + 1]);
  for (int64_t i = 0; i < n; i++) {
    const std::string_view v = view(data, starts[i], ends[i]);
    auto it = std::lower_bound(dict.begin(), dict.end(), v);
    codes_out[i] = (it != dict.end() && *it == v)
                       ? static_cast<int32_t>(it - dict.begin())
                       : -1;
  }
  return 0;
}

// Copy the strings of rows[0..m) into out[m][width], zero-padded (a numpy
// 'S{width}' array). width is at least the longest of them.
void bt_gather_padded(const uint8_t* data, const int64_t* starts,
                      const int64_t* ends, const int64_t* rows, int64_t m,
                      int64_t width, uint8_t* out) {
  for (int64_t i = 0; i < m; i++) {
    const int64_t s = starts[rows[i]], len = ends[rows[i]] - s;
    uint8_t* dst = out + i * width;
    std::memcpy(dst, data + s, static_cast<size_t>(len));
    std::memset(dst + len, 0, static_cast<size_t>(width - len));
  }
}

}  // extern "C"
