// Native block decoder for TrainingExample-shaped Avro container files.
//
// The pure-Python codec (io/avro.py) is a correct from-spec
// implementation but decodes per-datum recursively; at the north-star
// dataset scale (SURVEY/BASELINE: MovieLens/KDD-class inputs) ingest
// wall-time dwarfs training. This decoder handles the hot shape — flat
// records of (possibly union-typed) scalars, feature arrays and string maps,
// the layouts of TrainingExampleAvro / the reference's integ-test fixtures
// (photon-avro-schemas, read by AvroDataReader.scala:85-220) — as a tight
// loop over container blocks.
//
// Parallelism: Avro container blocks are independent (each is
// count/size/payload/sync), so the decode fans out one worker thread per
// contiguous span of blocks — the TPU-native stand-in for the reference's
// executor-parallel block reads (AvroUtils.scala:47 mapred splits). Each
// worker owns its own Result (arrays + string interners); the merge
// concatenates workers in block order and re-interns their dictionaries, so
// the output — including interned-id assignment order — is bit-identical to
// a sequential decode.
//
// The Python side parses the schema (it owns the Avro type system) and
// compiles it into a flat op program; this file never interprets schema
// JSON. A schema the program cannot express is read by the Python codec,
// a route the caller picks before decoding; a file this decoder rejects is
// an error, never retried on another route. In quarantine mode the decoder
// itself skips a corrupt block whole and counts it, as the Python codec's
// quarantined read does.
//
// Op stream (int32), each op self-delimiting:
//   1 NUM_COL   target nb k...   union-typed numeric -> label/offset/weight
//   2 NUM_COL_P target k         plain numeric column
//   3 TAG       slot nb k...     union-typed tag (string/varint branches)
//   4 TAG_P     slot k           plain tag
//   5 FEATURES  bag nullable     array<record> via the feature op stream
//   6 META      nullable         map<string,string>: fill empty tag slots
//   7 SKIP      nb k...          union skip
//   8 SKIP_P    k                plain skip
//   9 SKIP_MAP  nullable nvk k.. map with union-typed values, skipped
//  10 SKIP_FARR nullable n sub.. array<record> skipped (sub = ops 7/8)
// Feature ops: 20 FNAME | 21 FTERM nb k... | 22 FTERM_P | 23 FVALUE nb k...
//  24 FVALUE_P k | plus 7/8 skips.
// Numeric/skip kinds: 0 null, 1 double, 2 float, 3 varint(int/long),
//  4 boolean, 5 string/bytes (numeric contexts parse with strtod; an
//  unparseable string aborts the decode so Python re-raises identically).

// Deflate containers need zlib. photon_ml_tpu_torch/native/build.py defines
// AVRO_WITH_ZLIB (and links -lz) where the host has zlib's headers and
// library; without it the decoder reads null-codec files only, and
// photon_avro_has_deflate() tells the binding so, which refuses a deflate
// file by name before calling in.
#ifdef AVRO_WITH_ZLIB
#include <zlib.h>
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if ((size_t)(end - p) < n) {
      ok = false;
      return false;
    }
    return true;
  }
  int64_t read_long() {
    // Fast path: almost every varint in real data is one byte.
    if (p < end && !(*p & 0x80)) {
      uint64_t n = *p++;
      return (int64_t)(n >> 1) ^ -(int64_t)(n & 1);
    }
    uint64_t n = 0;
    int shift = 0;
    while (true) {
      if (!need(1)) return 0;
      uint8_t b = *p++;
      n |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) {
        ok = false;
        return 0;
      }
    }
    return (int64_t)(n >> 1) ^ -(int64_t)(n & 1);
  }
  double read_double() {
    if (!need(8)) return 0.0;
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  float read_float() {
    if (!need(4)) return 0.0f;
    float v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  void skip(size_t n) {
    if (need(n)) p += n;
  }
  void skip_bytes() {
    int64_t n = read_long();
    if (n < 0) {
      ok = false;
      return;
    }
    skip((size_t)n);
  }
  std::pair<const char*, int64_t> read_str() {
    int64_t n = read_long();
    if (n < 0 || !need((size_t)n)) {
      ok = false;
      return {nullptr, 0};
    }
    const char* s = (const char*)p;
    p += n;
    return {s, n};
  }
};

// Array/map block count. A negative count encodes (-count, byte-size) per
// the Avro spec. INT64_MIN cannot be negated (signed-overflow UB), and a
// count exceeding the remaining bytes is structurally impossible (every
// item is at least one byte) — both abort the decode, and the caller
// raises.
int64_t read_block_count(Reader& r) {
  int64_t n = r.read_long();
  if (n < 0) {
    if (n == INT64_MIN) {
      r.ok = false;
      return 0;
    }
    r.read_long();  // byte size of the block, unused on this path
    n = -n;
  }
  if (n > (int64_t)(r.end - r.p)) r.ok = false;
  return r.ok ? n : 0;
}

// Skip one value of numeric/skip kind k.
void skip_kind(Reader& r, int32_t k) {
  switch (k) {
    case 0:
      break;
    case 1:
      r.read_double();
      break;
    case 2:
      r.read_float();
      break;
    case 3:
      r.read_long();
      break;
    case 4:
      r.skip(1);
      break;
    case 5:
      r.skip_bytes();
      break;
    default:
      r.ok = false;
  }
}

// Read one numeric value of kind k ("has" reports null).
double read_numeric_kind(Reader& r, int32_t k, bool* has) {
  *has = true;
  switch (k) {
    case 0:
      *has = false;
      return 0.0;
    case 1:
      return r.read_double();
    case 2:
      return (double)r.read_float();
    case 3:
      return (double)r.read_long();
    case 4: {
      if (!r.need(1)) return 0.0;
      return (double)*r.p++;
    }
    case 5: {
      auto s = r.read_str();
      if (!r.ok) return 0.0;
      std::string tmp(s.first, (size_t)s.second);
      char* endp = nullptr;
      double v = std::strtod(tmp.c_str(), &endp);
      if (endp == tmp.c_str() || *endp != '\0') r.ok = false;  // not numeric
      return v;
    }
    default:
      r.ok = false;
      return 0.0;
  }
}

// Open-addressing string interner over a byte arena: the decode-loop hot
// path (one intern per feature entry) must not pay std::string allocation
// or unordered_map bucket chasing. FNV-1a hash, linear probing, 2x growth.
struct Interner {
  std::vector<char> bytes;
  std::vector<int64_t> offsets{0};
  std::vector<int32_t> slots;
  size_t mask;

  Interner() : slots(1024, -1), mask(1023) {}

  // Word-at-a-time mix (feature keys are 4-30 bytes; a byte-wise FNV loop
  // was a measurable fraction of the whole decode).
  static uint64_t hash(const char* p, size_t n) {
    const uint64_t M = 0x9DDFEA08EB382D69ull;
    uint64_t h = 0x9E3779B97F4A7C15ull ^ (uint64_t)n;
    while (n >= 8) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      h = (h ^ w) * M;
      h ^= h >> 29;
      p += 8;
      n -= 8;
    }
    if (n) {
      uint64_t w = 0;
      std::memcpy(&w, p, n);
      h = (h ^ w) * M;
    }
    h ^= h >> 32;
    return h;
  }
  size_t size() const { return offsets.size() - 1; }
  const char* str(int32_t id, size_t* n) const {
    *n = (size_t)(offsets[id + 1] - offsets[id]);
    return bytes.data() + offsets[id];
  }
  bool eq(int32_t id, const char* p, size_t n) const {
    int64_t off = offsets[id];
    return (int64_t)n == offsets[id + 1] - off &&
           std::memcmp(bytes.data() + off, p, n) == 0;
  }
  int32_t intern(const char* p, size_t n) {
    size_t i = hash(p, n) & mask;
    while (true) {
      int32_t s = slots[i];
      if (s < 0) break;
      if (eq(s, p, n)) return s;
      i = (i + 1) & mask;
    }
    int32_t id = (int32_t)size();
    slots[i] = id;
    bytes.insert(bytes.end(), p, p + n);
    offsets.push_back((int64_t)bytes.size());
    if (size() * 2 > mask) grow();
    return id;
  }
  // Forget every id >= n (the keys a quarantined block interned). Ids are
  // assigned in insertion order and grow() re-inserts in id order, so no
  // probe chain of a kept id passes through a slot of a forgotten one.
  void truncate(size_t n) {
    if (n >= size()) return;
    bytes.resize((size_t)offsets[n]);
    offsets.resize(n + 1);
    for (auto& s : slots)
      if (s >= (int32_t)n) s = -1;
  }
  void grow() {
    size_t nm = (mask + 1) * 2;
    std::vector<int32_t> ns(nm, -1);
    for (int32_t id = 0; id < (int32_t)size(); ++id) {
      size_t n;
      const char* p = str(id, &n);
      size_t j = hash(p, n) & (nm - 1);
      while (ns[j] >= 0) j = (j + 1) & (nm - 1);
      ns[j] = id;
    }
    slots.swap(ns);
    mask = nm - 1;
  }
};

struct Bag {
  std::vector<int64_t> indptr{0};
  std::vector<int32_t> keys;
  std::vector<float> vals;
  bool has_row_dups = false;
};

struct Result {
  std::vector<double> labels, offsets, weights;
  std::vector<Bag> bags;
  Interner keys;
  Interner tag_vals;
  std::vector<int32_t> tag_ids;  // n_records * n_tags, -1 = absent
};

// The sizes of a Result before a block, so that a quarantined block can be
// dropped whole: no record, entry, key or tag value of it survives.
struct ResultMark {
  size_t n_records, n_tag_ids, n_keys, n_tag_vals;
  std::vector<size_t> indptr, entries;
  std::vector<bool> dups;

  explicit ResultMark(const Result& r)
      : n_records(r.labels.size()),
        n_tag_ids(r.tag_ids.size()),
        n_keys(r.keys.size()),
        n_tag_vals(r.tag_vals.size()) {
    for (const auto& b : r.bags) {
      indptr.push_back(b.indptr.size());
      entries.push_back(b.keys.size());
      dups.push_back(b.has_row_dups);
    }
  }
  void rollback(Result& r) const {
    r.labels.resize(n_records);
    r.offsets.resize(n_records);
    r.weights.resize(n_records);
    r.tag_ids.resize(n_tag_ids);
    r.keys.truncate(n_keys);
    r.tag_vals.truncate(n_tag_vals);
    for (size_t b = 0; b < r.bags.size(); ++b) {
      r.bags[b].indptr.resize(indptr[b]);
      r.bags[b].keys.resize(entries[b]);
      r.bags[b].vals.resize(entries[b]);
      r.bags[b].has_row_dups = dups[b];
    }
  }
};

// One feature-array item; appends (key id, value) to the bag.
void decode_feature_item(Reader& r, const int32_t* fops, int n_fops,
                         const std::string& delim, Result& out, Bag& bag,
                         std::string& keybuf) {
  keybuf.clear();
  double value = 0.0;
  for (int f = 0; f < n_fops && r.ok; ++f) {
    switch (fops[f]) {
      case 20: {
        auto s = r.read_str();
        if (r.ok) keybuf.assign(s.first, (size_t)s.second);
        break;
      }
      case 21: {  // FTERM union
        int nb = fops[++f];
        int64_t br = r.read_long();
        if (br < 0 || br >= nb) {
          r.ok = false;
          break;
        }
        int32_t k = fops[f + 1 + (int)br];
        if (k == 1) {
          auto s = r.read_str();
          // feature_key(name, term): empty/null term leaves the bare name.
          if (r.ok && s.second > 0) {
            keybuf += delim;
            keybuf.append(s.first, (size_t)s.second);
          }
        } else if (k != 0) {
          r.ok = false;
        }
        f += nb;
        break;
      }
      case 22: {  // FTERM plain string
        auto s = r.read_str();
        if (r.ok && s.second > 0) {
          keybuf += delim;
          keybuf.append(s.first, (size_t)s.second);
        }
        break;
      }
      case 23: {  // FVALUE union
        int nb = fops[++f];
        int64_t br = r.read_long();
        if (br < 0 || br >= nb) {
          r.ok = false;
          break;
        }
        bool has;
        value = read_numeric_kind(r, fops[f + 1 + (int)br], &has);
        if (!has) r.ok = false;  // Python float(None) raises; stay identical
        f += nb;
        break;
      }
      case 24: {
        bool has;
        value = read_numeric_kind(r, fops[++f], &has);
        if (!has) r.ok = false;
        break;
      }
      case 7: {
        int nb = fops[++f];
        int64_t br = r.read_long();
        if (br < 0 || br >= nb) {
          r.ok = false;
          break;
        }
        skip_kind(r, fops[f + 1 + (int)br]);
        f += nb;
        break;
      }
      case 8:
        skip_kind(r, fops[++f]);
        break;
      default:
        r.ok = false;
    }
  }
  if (r.ok) {
    bag.keys.push_back(out.keys.intern(keybuf.data(), keybuf.size()));
    bag.vals.push_back((float)value);
  }
}

// The two feature-record layouts that cover TrainingExampleAvro as written
// by photon-avro-schemas codegen (name, value, nullable term — the
// reference's fixtures) and by our own writer (name, term, value) get fused
// loops: no per-op switch, no union dispatch. Everything else runs the
// generic op interpreter above with identical semantics.
enum FeatPattern {
  FEAT_GENERIC = 0,
  FEAT_NAME_TERMP_VALD = 1,    // fops {20, 22, 24, 1}
  FEAT_NAME_VALD_TERMU01 = 2,  // fops {20, 24, 1, 21, 2, 0, 1}
};

FeatPattern detect_pattern(const int32_t* fops, int n_fops) {
  static const int32_t pat_b[4] = {20, 22, 24, 1};
  static const int32_t pat_a[7] = {20, 24, 1, 21, 2, 0, 1};
  if (n_fops == 4 && !std::memcmp(fops, pat_b, sizeof pat_b))
    return FEAT_NAME_TERMP_VALD;
  if (n_fops == 7 && !std::memcmp(fops, pat_a, sizeof pat_a))
    return FEAT_NAME_VALD_TERMU01;
  return FEAT_GENERIC;
}

inline void item_name_termp_vald(Reader& r, const std::string& delim,
                                 Result& out, Bag& bag, std::string& keybuf) {
  auto s = r.read_str();
  if (!r.ok) return;
  keybuf.assign(s.first, (size_t)s.second);
  auto t = r.read_str();
  if (!r.ok) return;
  if (t.second > 0) {
    keybuf += delim;
    keybuf.append(t.first, (size_t)t.second);
  }
  double v = r.read_double();
  if (!r.ok) return;
  bag.keys.push_back(out.keys.intern(keybuf.data(), keybuf.size()));
  bag.vals.push_back((float)v);
}

inline void item_name_vald_termu(Reader& r, const std::string& delim,
                                 Result& out, Bag& bag, std::string& keybuf) {
  auto s = r.read_str();
  if (!r.ok) return;
  keybuf.assign(s.first, (size_t)s.second);
  double v = r.read_double();
  int64_t br = r.read_long();
  if (br == 1) {
    auto t = r.read_str();
    if (r.ok && t.second > 0) {
      keybuf += delim;
      keybuf.append(t.first, (size_t)t.second);
    }
  } else if (br != 0) {
    r.ok = false;
  }
  if (!r.ok) return;
  bag.keys.push_back(out.keys.intern(keybuf.data(), keybuf.size()));
  bag.vals.push_back((float)v);
}

// Accumulate duplicate feature keys within one record's bag segment, in
// place: the first occurrence keeps its slot and duplicate values sum in
// FLOAT64 before one final cast — the same accumulate-then-round the
// Python path's np.add.at(float64) performs, so the two readers cannot
// diverge on records like [a:1e8, a:1, a:-1e8] (the reference sums
// repeated (name, term) pairs into one vector slot the same way). The
// decoder's output is therefore always per-record clean, letting the
// Python assembly take pack_csr_to_ell's assume_clean path — the former
// flag-only check pushed the whole dataset through a per-row dedup that
// was 94% of assembly wall (VERDICT r04 item 1). Short rows (the norm)
// use a first-occurrence scan; wide rows switch to a sort so a 50k-entry
// record costs O(n log n), not O(n^2).
void dedup_row(Bag& bag, size_t row_start, std::vector<double>& acc,
               std::vector<int64_t>& order) {
  size_t n = bag.keys.size() - row_start;
  if (n < 2) return;
  int32_t* keys = bag.keys.data() + row_start;
  float* vals = bag.vals.data() + row_start;
  size_t w;
  if (n < 64) {
    acc.clear();
    acc.push_back(vals[0]);
    w = 1;
    for (size_t i = 1; i < n; ++i) {
      int32_t k = keys[i];
      size_t j = 0;
      while (j < w && keys[j] != k) ++j;
      if (j < w) {
        acc[j] += (double)vals[i];
      } else {
        keys[w] = k;
        acc.push_back(vals[i]);
        ++w;
      }
    }
    if (w == n) return;  // no duplicates: vals untouched
    for (size_t j = 0; j < w; ++j) vals[j] = (float)acc[j];
  } else {
    // Wide record: sort (key, position), accumulate runs in position order
    // (so sums match the sequential np.add.at order), then place compacted
    // entries back at their first-occurrence positions.
    order.resize(n);
    for (size_t i = 0; i < n; ++i) order[i] = (int64_t)i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return keys[a] != keys[b] ? keys[a] < keys[b] : a < b;
    });
    acc.clear();
    std::vector<std::pair<int64_t, int32_t>> firsts;  // (first pos, key)
    size_t i = 0;
    while (i < n) {
      int32_t k = keys[order[i]];
      double s = vals[order[i]];
      int64_t first = order[i];
      for (++i; i < n && keys[order[i]] == k; ++i) s += (double)vals[order[i]];
      firsts.emplace_back(first, k);
      acc.push_back(s);
    }
    w = firsts.size();
    if (w == n) return;
    // Compact in first-occurrence order (stable record order).
    std::vector<size_t> by_pos(w);
    for (size_t j = 0; j < w; ++j) by_pos[j] = j;
    std::sort(by_pos.begin(), by_pos.end(), [&](size_t a, size_t b) {
      return firsts[a].first < firsts[b].first;
    });
    std::vector<int32_t> ck(w);
    std::vector<float> cv(w);
    for (size_t j = 0; j < w; ++j) {
      ck[j] = firsts[by_pos[j]].second;
      cv[j] = (float)acc[by_pos[j]];
    }
    std::memcpy(keys, ck.data(), w * sizeof(int32_t));
    std::memcpy(vals, cv.data(), w * sizeof(float));
  }
  bag.has_row_dups = true;  // informational: dups existed and were summed
  bag.keys.resize(row_start + w);
  bag.vals.resize(row_start + w);
}

bool decode_block(Reader& r, int64_t count, const int32_t* rops, int n_rops,
                  const int32_t* fops, int n_fops, FeatPattern pattern,
                  const std::vector<std::string>& tag_names, int n_meta_tags,
                  const std::string& delim, Result& out) {
  const int n_tags = (int)tag_names.size();
  std::string keybuf;
  std::vector<size_t> row_starts(out.bags.size());
  std::vector<double> dedup_acc;
  std::vector<int64_t> dedup_order;
  for (int64_t rec = 0; rec < count && r.ok; ++rec) {
    out.labels.push_back(0.0);
    out.offsets.push_back(0.0);
    out.weights.push_back(1.0);
    size_t tag_base = out.tag_ids.size();
    out.tag_ids.resize(tag_base + n_tags, -1);
    for (size_t b = 0; b < out.bags.size(); ++b)
      row_starts[b] = out.bags[b].keys.size();
    for (int i = 0; i < n_rops && r.ok; ++i) {
      switch (rops[i]) {
        case 1:
        case 2: {
          bool is_union = rops[i] == 1;
          int target = rops[++i];
          int32_t k;
          int nb = 1;
          if (is_union) {
            nb = rops[++i];
            int64_t br = r.read_long();
            if (br < 0 || br >= nb) {
              r.ok = false;
              break;
            }
            k = rops[i + 1 + (int)br];
            i += nb;
          } else {
            k = rops[++i];
          }
          bool has;
          double v = read_numeric_kind(r, k, &has);
          if (r.ok && has) {
            if (target == 1)
              out.labels.back() = v;
            else if (target == 2)
              out.offsets.back() = v;
            else
              out.weights.back() = v;
          }
          break;
        }
        case 3:
        case 4: {
          bool is_union = rops[i] == 3;
          int slot = rops[++i];
          int32_t k;
          if (is_union) {
            int nb = rops[++i];
            int64_t br = r.read_long();
            if (br < 0 || br >= nb) {
              r.ok = false;
              break;
            }
            k = rops[i + 1 + (int)br];
            i += nb;
          } else {
            k = rops[++i];
          }
          if (k == 1) {
            auto s = r.read_str();
            if (r.ok)
              out.tag_ids[tag_base + slot] =
                  out.tag_vals.intern(s.first, (size_t)s.second);
          } else if (k == 3) {
            char buf[24];
            int len =
                std::snprintf(buf, sizeof buf, "%lld", (long long)r.read_long());
            if (r.ok)
              out.tag_ids[tag_base + slot] =
                  out.tag_vals.intern(buf, (size_t)len);
          } else if (k != 0) {
            r.ok = false;
          }
          break;
        }
        case 5: {
          int bag_slot = rops[++i];
          int nullable = rops[++i];
          if (nullable && r.read_long() != 1) break;
          Bag& bag = out.bags[bag_slot];
          for (int64_t n = read_block_count(r); n != 0 && r.ok;
               n = read_block_count(r)) {
            switch (pattern) {
              case FEAT_NAME_TERMP_VALD:
                for (int64_t j = 0; j < n && r.ok; ++j)
                  item_name_termp_vald(r, delim, out, bag, keybuf);
                break;
              case FEAT_NAME_VALD_TERMU01:
                for (int64_t j = 0; j < n && r.ok; ++j)
                  item_name_vald_termu(r, delim, out, bag, keybuf);
                break;
              default:
                for (int64_t j = 0; j < n && r.ok; ++j)
                  decode_feature_item(r, fops, n_fops, delim, out, bag,
                                      keybuf);
            }
          }
          break;
        }
        case 6: {
          int nullable = rops[++i];
          if (nullable && r.read_long() != 1) break;
          for (int64_t n = read_block_count(r); n != 0 && r.ok;
               n = read_block_count(r)) {
            for (int64_t j = 0; j < n && r.ok; ++j) {
              auto k = r.read_str();
              auto v = r.read_str();
              if (!r.ok) continue;
              for (int t = 0; t < n_meta_tags; ++t) {
                if (out.tag_ids[tag_base + t] == -1 &&
                    (int64_t)tag_names[t].size() == k.second &&
                    std::memcmp(tag_names[t].data(), k.first, k.second) == 0) {
                  out.tag_ids[tag_base + t] =
                      out.tag_vals.intern(v.first, (size_t)v.second);
                }
              }
            }
          }
          break;
        }
        case 7: {
          int nb = rops[++i];
          int64_t br = r.read_long();
          if (br < 0 || br >= nb) {
            r.ok = false;
            break;
          }
          skip_kind(r, rops[i + 1 + (int)br]);
          i += nb;
          break;
        }
        case 8:
          skip_kind(r, rops[++i]);
          break;
        case 9: {
          int nullable = rops[++i];
          int nvk = rops[++i];
          const int32_t* vkinds = rops + i + 1;
          i += nvk;
          if (nullable && r.read_long() != 1) break;
          for (int64_t n = read_block_count(r); n != 0 && r.ok;
               n = read_block_count(r)) {
            for (int64_t j = 0; j < n && r.ok; ++j) {
              r.skip_bytes();  // key string
              int32_t k;
              if (nvk > 1) {
                int64_t br = r.read_long();
                if (br < 0 || br >= nvk) {
                  r.ok = false;
                  break;
                }
                k = vkinds[br];
              } else {
                k = vkinds[0];
              }
              skip_kind(r, k);
            }
          }
          break;
        }
        case 10: {
          int nullable = rops[++i];
          int n_sub = rops[++i];
          const int32_t* sub = rops + i + 1;
          i += n_sub;
          if (nullable && r.read_long() != 1) break;
          for (int64_t n = read_block_count(r); n != 0 && r.ok;
               n = read_block_count(r)) {
            for (int64_t j = 0; j < n && r.ok; ++j) {
              for (int f = 0; f < n_sub && r.ok; ++f) {
                if (sub[f] == 8) {
                  skip_kind(r, sub[++f]);
                } else if (sub[f] == 7) {
                  int nb = sub[++f];
                  int64_t br = r.read_long();
                  if (br < 0 || br >= nb) {
                    r.ok = false;
                    break;
                  }
                  skip_kind(r, sub[f + 1 + (int)br]);
                  f += nb;
                } else {
                  r.ok = false;
                }
              }
            }
          }
          break;
        }
        default:
          r.ok = false;
      }
    }
    for (size_t b = 0; b < out.bags.size(); ++b) {
      Bag& bag = out.bags[b];
      dedup_row(bag, row_starts[b], dedup_acc, dedup_order);
      bag.indptr.push_back((int64_t)bag.keys.size());
    }
  }
  return r.ok;
}

#ifdef AVRO_WITH_ZLIB
bool inflate_raw(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  out.resize(n * 4 + 4096);
  size_t written = 0;
  int rc;
  do {
    if (written == out.size()) out.resize(out.size() * 2);
    zs.next_out = out.data() + written;
    zs.avail_out = (uInt)(out.size() - written);
    rc = inflate(&zs, Z_NO_FLUSH);
    written = out.size() - zs.avail_out;
  } while (rc == Z_OK);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;
  out.resize(written);
  return true;
}
#else
bool inflate_raw(const uint8_t*, size_t, std::vector<uint8_t>&) { return false; }
#endif

struct BlockInfo {
  const uint8_t* p;
  int64_t size;
  int64_t count;
};

// The next occurrence of the 16-byte sync marker in [from, end), or nullptr.
const uint8_t* find_sync(const uint8_t* from, const uint8_t* end,
                         const uint8_t* sync) {
  while (end - from >= 16) {
    const void* hit = std::memchr(from, sync[0], (size_t)(end - from) - 15);
    if (!hit) return nullptr;
    const uint8_t* p = (const uint8_t*)hit;
    if (std::memcmp(p, sync, 16) == 0) return p;
    from = p + 1;
  }
  return nullptr;
}

// Serial structural walk: block boundaries + sync validation only (varint
// reads and one memcmp per block — runs at GB/s, not worth threading).
// Strict, a block with bad framing or a bad sync marker fails the walk.
// With `quarantine`, it is counted in `*bad` and the walk re-synchronizes
// at the next sync marker past the block's start, as the Python reader
// does (io/avro.py iter_container); no marker left ends the walk.
bool scan_blocks(Reader& file, const uint8_t* sync, int codec, bool quarantine,
                 std::vector<BlockInfo>& out, int64_t* bad) {
  while (file.p < file.end) {
    const uint8_t* block_start = file.p;
    int64_t count = file.read_long();
    int64_t size = file.read_long();
    // Structural record-count bound, to keep the downstream reserve()
    // calls from attempting absurd allocations on a corrupted header (size
    // is already bounded by the real file length here, so the multiply
    // cannot overflow). Uncompressed blocks: every record is >= 1 byte.
    // Deflate blocks: a record cannot compress below 1/1032 of a byte.
    bool framed = file.ok && size >= 0 && count >= 0 &&
                  file.need((size_t)size + 16) &&
                  count <= (codec == 1 ? size * 1032 + 64 : size + 64) &&
                  std::memcmp(file.p + size, sync, 16) == 0;
    if (framed) {
      out.push_back({file.p, size, count});
      file.p += size + 16;
      continue;
    }
    if (!quarantine) return false;
    ++*bad;
    const uint8_t* next = find_sync(block_start + 1, file.end, sync);
    if (!next) break;
    file.p = next + 16;
    file.ok = true;
  }
  return true;
}

struct DecodeJob {
  const std::vector<BlockInfo>* blocks;
  size_t begin, end;  // block span
  const int32_t* rops;
  int n_rops;
  const int32_t* fops;
  int n_fops;
  FeatPattern pattern;
  const std::vector<std::string>* tag_names;
  int n_meta_tags;
  const std::string* delim;
  int codec;
  bool quarantine;
  Result res;
  int64_t bad = 0;  // blocks quarantined by this job
  bool ok = false;
};

void run_job_impl(DecodeJob* job, std::atomic<bool>* failed);

void run_job(DecodeJob* job, std::atomic<bool>* failed) {
  // Nothing may escape a worker thread (an uncaught exception is
  // std::terminate): treat any allocation failure as a decode failure and
  // let the caller raise.
  try {
    run_job_impl(job, failed);
  } catch (...) {
    failed->store(true, std::memory_order_relaxed);
  }
}

void run_job_impl(DecodeJob* job, std::atomic<bool>* failed) {
  std::vector<uint8_t> scratch;
  // Record counts are known up front from the block headers: reserve the
  // scalar columns exactly (vector growth reallocs were measurable). The
  // reserve is advisory — cap it so a pathological-but-valid header (or one
  // that slipped past scan_blocks' bound) cannot demand an absurd upfront
  // allocation; vectors still grow geometrically past the cap.
  int64_t span_records = 0;
  for (size_t i = job->begin; i < job->end; ++i)
    span_records += (*job->blocks)[i].count;
  int64_t reserve_records = std::min<int64_t>(span_records, int64_t{1} << 27);
  job->res.labels.reserve(reserve_records);
  job->res.offsets.reserve(reserve_records);
  job->res.weights.reserve(reserve_records);
  job->res.tag_ids.reserve(reserve_records * (int64_t)job->tag_names->size());
  for (auto& bag : job->res.bags) bag.indptr.reserve(reserve_records + 1);
  for (size_t i = job->begin; i < job->end; ++i) {
    if (failed->load(std::memory_order_relaxed)) return;
    const BlockInfo& b = (*job->blocks)[i];
    // A block that fails its inflate or its decode, or leaves trailing
    // bytes (a mis-decoded block), fails the file; with quarantine it is
    // dropped whole and counted, and the job goes on with the next block.
    std::unique_ptr<ResultMark> mark;
    if (job->quarantine) mark.reset(new ResultMark(job->res));
    Reader r{b.p, b.p + b.size};
    bool good = true;
    if (job->codec == 1) {
      good = inflate_raw(b.p, (size_t)b.size, scratch);
      if (good) r = Reader{scratch.data(), scratch.data() + scratch.size()};
    }
    good = good &&
           decode_block(r, b.count, job->rops, job->n_rops, job->fops,
                        job->n_fops, job->pattern, *job->tag_names,
                        job->n_meta_tags, *job->delim, job->res) &&
           r.p == r.end;
    if (!good) {
      if (!mark) {
        failed->store(true, std::memory_order_relaxed);
        return;
      }
      mark->rollback(job->res);
      ++job->bad;
      continue;
    }
    if (i == job->begin && span_records > 0) {
      // Extrapolate bag nnz from the first block to size the entry arrays.
      int64_t done = b.count > 0 ? b.count : 1;
      for (auto& bag : job->res.bags) {
        size_t est =
            (size_t)((double)bag.keys.size() / done * span_records * 1.05);
        est = std::min<size_t>(est, size_t{1} << 28);  // advisory, capped
        bag.keys.reserve(est);
        bag.vals.reserve(est);
      }
    }
  }
  job->ok = true;
}

struct CResult {
  int64_t n_records;
  double* labels;
  double* offsets;
  double* weights;
  int32_t n_bags;
  int64_t** bag_indptr;
  int32_t** bag_keys;
  float** bag_vals;
  int64_t* bag_nnz;
  int32_t* bag_has_dups;
  int64_t n_keys;
  char* key_bytes;
  int64_t* key_offsets;
  int32_t n_tags;
  int32_t* tag_ids;
  int64_t n_tag_vals;
  char* tag_val_bytes;
  int64_t* tag_val_offsets;
  int64_t n_blocks;       // blocks found, good and quarantined
  int64_t n_quarantined;  // blocks skipped (quarantine only)
};

// malloc can fail on huge malformed inputs (a corrupted count that survived
// the structural checks); every allocation is checked and failure unwinds
// through photon_avro_free so the caller raises instead of dereferencing
// null.
template <typename T>
T* alloc_n(size_t n, bool& ok) {
  if (!ok) return nullptr;  // a prior failure: skip further large allocations
  T* out = (T*)std::malloc(n * sizeof(T) + 1);
  if (!out) ok = false;
  return out;
}

template <typename T>
T* steal(std::vector<T>& v, bool& ok) {
  T* out = alloc_n<T>(v.size(), ok);
  if (out) std::memcpy(out, v.data(), v.size() * sizeof(T));
  return out;
}

// Build a worker-local-id -> global-id map by re-interning the worker's
// dictionary into `global` in order. Workers are merged in block order, so
// global ids reproduce the exact first-encounter order of a sequential
// decode.
std::vector<int32_t> remap_interner(const Interner& local, Interner& global) {
  std::vector<int32_t> l2g(local.size());
  for (int32_t id = 0; id < (int32_t)local.size(); ++id) {
    size_t n;
    const char* p = local.str(id, &n);
    l2g[id] = global.intern(p, n);
  }
  return l2g;
}

void* photon_avro_decode_impl(const uint8_t* data, int64_t data_len,
                              int64_t body_start, int32_t codec,
                              const uint8_t* sync, const int32_t* rops,
                              int32_t n_rops, const int32_t* fops,
                              int32_t n_fops, int32_t n_bags,
                              const char* tag_names_joined, int32_t n_tags,
                              int32_t n_meta_tags, const char* delim_c,
                              int32_t n_threads, int32_t quarantine);

}  // namespace

extern "C" {

void photon_avro_free(void* ptr);

// 1 when this build decodes deflate containers (built with zlib), else 0.
int32_t photon_avro_has_deflate() {
#ifdef AVRO_WITH_ZLIB
  return 1;
#else
  return 0;
#endif
}

// Decode `data` (a whole container file already read into memory).
// codec: 0 = null, 1 = deflate. n_threads: 0 = hardware concurrency.
// quarantine: 0 = any bad block fails the file; 1 = a bad block is skipped
// whole and counted in n_quarantined (the caller raises when no block was
// good). Returns a malloc'd CResult* or nullptr on any structural error
// (caller raises).
void* photon_avro_decode(const uint8_t* data, int64_t data_len,
                         int64_t body_start, int32_t codec,
                         const uint8_t* sync, const int32_t* rops,
                         int32_t n_rops, const int32_t* fops, int32_t n_fops,
                         int32_t n_bags, const char* tag_names_joined,
                         int32_t n_tags, int32_t n_meta_tags,
                         const char* delim_c, int32_t n_threads,
                         int32_t quarantine) {
  try {
    return photon_avro_decode_impl(data, data_len, body_start, codec, sync,
                                   rops, n_rops, fops, n_fops, n_bags,
                                   tag_names_joined, n_tags, n_meta_tags,
                                   delim_c, n_threads, quarantine);
  } catch (...) {
    return nullptr;  // bad_alloc etc.: the caller raises
  }
}

}  // extern "C"

namespace {

void* photon_avro_decode_impl(const uint8_t* data, int64_t data_len,
                              int64_t body_start, int32_t codec,
                              const uint8_t* sync, const int32_t* rops,
                              int32_t n_rops, const int32_t* fops,
                              int32_t n_fops, int32_t n_bags,
                              const char* tag_names_joined, int32_t n_tags,
                              int32_t n_meta_tags, const char* delim_c,
                              int32_t n_threads, int32_t quarantine) {
  std::vector<std::string> tag_names;
  {
    const char* s = tag_names_joined;
    for (int i = 0; i < n_tags; ++i) {
      size_t n = std::strlen(s);
      tag_names.emplace_back(s, n);
      s += n + 1;
    }
  }
  std::string delim(delim_c);
  Reader file{data + body_start, data + data_len};
  std::vector<BlockInfo> blocks;
  int64_t bad_framing = 0;
  if (!scan_blocks(file, sync, codec, quarantine != 0, blocks, &bad_framing))
    return nullptr;

  int hw = (int)std::thread::hardware_concurrency();
  int W = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);
  W = std::min<int>({W, (int)blocks.size() > 0 ? (int)blocks.size() : 1, 32});

  // Contiguous spans balanced by compressed bytes.
  int64_t total_bytes = 0;
  for (const auto& b : blocks) total_bytes += b.size;
  std::vector<DecodeJob> jobs(W);
  {
    size_t bi = 0;
    int64_t acc = 0;
    for (int w = 0; w < W; ++w) {
      DecodeJob& j = jobs[w];
      j.blocks = &blocks;
      j.begin = bi;
      int64_t target = total_bytes * (int64_t)(w + 1) / W;
      while (bi < blocks.size() && (w == W - 1 || acc < target)) {
        acc += blocks[bi].size;
        ++bi;
      }
      j.end = bi;
      j.rops = rops;
      j.n_rops = n_rops;
      j.fops = fops;
      j.n_fops = n_fops;
      j.pattern = detect_pattern(fops, n_fops);
      j.tag_names = &tag_names;
      j.n_meta_tags = n_meta_tags;
      j.delim = &delim;
      j.codec = codec;
      j.quarantine = quarantine != 0;
      j.res.bags.resize(n_bags);
    }
  }

  std::atomic<bool> failed{false};
  if (W == 1) {
    run_job(&jobs[0], &failed);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(W);
    for (int w = 0; w < W; ++w)
      try {
        threads.emplace_back(run_job, &jobs[w], &failed);
      } catch (...) {
        // Thread creation failed (pid/thread cap): join what started, mark
        // failed so the caller raises — never unwind past joinable
        // threads (that would std::terminate the whole process).
        failed.store(true, std::memory_order_relaxed);
        break;
      }
    for (auto& t : threads) t.join();
  }
  if (failed.load()) return nullptr;
  for (const auto& j : jobs)
    if (!j.ok) return nullptr;

  // ---- merge workers in block order --------------------------------------
  int64_t n = 0;
  for (const auto& j : jobs) n += (int64_t)j.res.labels.size();

  CResult* c = (CResult*)std::calloc(1, sizeof(CResult));
  if (!c) return nullptr;
  bool ok = true;
  c->n_blocks = (int64_t)blocks.size() + bad_framing;
  c->n_quarantined = bad_framing;
  for (const auto& j : jobs) c->n_quarantined += j.bad;
  c->n_records = n;
  c->labels = alloc_n<double>(n, ok);
  c->offsets = alloc_n<double>(n, ok);
  c->weights = alloc_n<double>(n, ok);
  c->n_bags = n_bags;
  c->bag_indptr = (int64_t**)std::calloc(n_bags + 1, sizeof(void*));
  c->bag_keys = (int32_t**)std::calloc(n_bags + 1, sizeof(void*));
  c->bag_vals = (float**)std::calloc(n_bags + 1, sizeof(void*));
  c->bag_nnz = (int64_t*)std::calloc(n_bags + 1, sizeof(int64_t));
  c->bag_has_dups = (int32_t*)std::calloc(n_bags + 1, sizeof(int32_t));
  c->n_tags = n_tags;
  c->tag_ids = alloc_n<int32_t>((size_t)n * n_tags, ok);
  if (!c->bag_indptr || !c->bag_keys || !c->bag_vals || !c->bag_nnz ||
      !c->bag_has_dups)
    ok = false;

  Interner gkeys, gtags;
  std::vector<std::vector<int32_t>> key_l2g(jobs.size()), tag_l2g(jobs.size());
  for (size_t w = 0; ok && w < jobs.size(); ++w) {
    key_l2g[w] = remap_interner(jobs[w].res.keys, gkeys);
    tag_l2g[w] = remap_interner(jobs[w].res.tag_vals, gtags);
  }

  // scalar columns + tag ids
  if (ok) {
    int64_t at = 0;
    for (const auto& j : jobs) {
      size_t jn = j.res.labels.size();
      std::memcpy(c->labels + at, j.res.labels.data(), jn * sizeof(double));
      std::memcpy(c->offsets + at, j.res.offsets.data(), jn * sizeof(double));
      std::memcpy(c->weights + at, j.res.weights.data(), jn * sizeof(double));
      at += (int64_t)jn;
    }
    int64_t tat = 0;
    for (size_t w = 0; w < jobs.size(); ++w) {
      const auto& ids = jobs[w].res.tag_ids;
      const auto& l2g = tag_l2g[w];
      for (size_t i = 0; i < ids.size(); ++i)
        c->tag_ids[tat + (int64_t)i] = ids[i] < 0 ? -1 : l2g[ids[i]];
      tat += (int64_t)ids.size();
    }
  }

  for (int b = 0; ok && b < n_bags; ++b) {
    int64_t nnz = 0;
    bool dups = false;
    for (const auto& j : jobs) {
      nnz += (int64_t)j.res.bags[b].keys.size();
      dups = dups || j.res.bags[b].has_row_dups;
    }
    c->bag_nnz[b] = nnz;
    c->bag_has_dups[b] = dups ? 1 : 0;
    c->bag_indptr[b] = alloc_n<int64_t>((size_t)n + 1, ok);
    c->bag_keys[b] = alloc_n<int32_t>((size_t)nnz, ok);
    c->bag_vals[b] = alloc_n<float>((size_t)nnz, ok);
    if (!ok) break;
    int64_t row_at = 0, ent_at = 0;
    c->bag_indptr[b][0] = 0;
    for (size_t w = 0; w < jobs.size(); ++w) {
      const Bag& bag = jobs[w].res.bags[b];
      const auto& l2g = key_l2g[w];
      for (size_t i = 1; i < bag.indptr.size(); ++i)
        c->bag_indptr[b][row_at + (int64_t)i] = bag.indptr[i] + ent_at;
      for (size_t i = 0; i < bag.keys.size(); ++i)
        c->bag_keys[b][ent_at + (int64_t)i] = l2g[bag.keys[i]];
      std::memcpy(c->bag_vals[b] + ent_at, bag.vals.data(),
                  bag.vals.size() * sizeof(float));
      row_at += (int64_t)bag.indptr.size() - 1;
      ent_at += (int64_t)bag.keys.size();
    }
  }

  c->n_keys = (int64_t)gkeys.size();
  c->key_bytes = steal(gkeys.bytes, ok);
  c->key_offsets = steal(gkeys.offsets, ok);
  c->n_tag_vals = (int64_t)gtags.size();
  c->tag_val_bytes = steal(gtags.bytes, ok);
  c->tag_val_offsets = steal(gtags.offsets, ok);
  if (!ok) {
    photon_avro_free(c);
    return nullptr;
  }
  return c;
}

// One union(null, string) or union(null, double) branch index; false
// (and r.ok false) on any other.
bool read_null_branch(Reader& r, bool* present) {
  int64_t br = r.read_long();
  if (br != 0 && br != 1) r.ok = false;
  *present = br == 1;
  return r.ok;
}

}  // namespace

extern "C" {

// Decode `count` ScoringResultAvro records from one (inflated) block:
// uid: union(null, string) | label: union(null, double) | modelId |
// predictionScore | weight: union(null, double) | metadataMap:
// union(null, map<string, string>). A uid comes back as a (start, length)
// span into `data`; present[i] has bit 1 (uid), 2 (label), 4 (weight) set
// where the record holds a value. modelId is skipped. Returns 0, -1 for a
// block this layout cannot decode, or -2 at a record whose metadataMap is
// not null (the port's score files carry none).
int64_t photon_avro_decode_scores(const uint8_t* data, int64_t len,
                                  int64_t count, double* scores,
                                  double* labels, double* weights,
                                  uint8_t* present, int64_t* uid_spans) {
  Reader r{data, data + len};
  for (int64_t i = 0; i < count && r.ok; ++i) {
    uint8_t bits = 0;
    bool has;
    uid_spans[2 * i] = uid_spans[2 * i + 1] = 0;
    if (!read_null_branch(r, &has)) break;
    if (has) {
      bits |= 1;
      auto s = r.read_str();
      uid_spans[2 * i] = r.ok ? (int64_t)((const uint8_t*)s.first - data) : 0;
      uid_spans[2 * i + 1] = s.second;
    }
    if (!read_null_branch(r, &has)) break;
    labels[i] = has ? r.read_double() : 0.0;
    if (has) bits |= 2;
    r.read_str();  // modelId
    scores[i] = r.read_double();
    if (!read_null_branch(r, &has)) break;
    weights[i] = has ? r.read_double() : 0.0;
    if (has) bits |= 4;
    if (!read_null_branch(r, &has)) break;
    if (has) return -2;
    present[i] = bits;
  }
  return r.ok ? 0 : -1;
}

void photon_avro_free(void* ptr) {
  if (!ptr) return;
  CResult* c = (CResult*)ptr;
  std::free(c->labels);
  std::free(c->offsets);
  std::free(c->weights);
  for (int b = 0; b < c->n_bags; ++b) {
    if (c->bag_indptr) std::free(c->bag_indptr[b]);
    if (c->bag_keys) std::free(c->bag_keys[b]);
    if (c->bag_vals) std::free(c->bag_vals[b]);
  }
  std::free(c->bag_indptr);
  std::free(c->bag_keys);
  std::free(c->bag_vals);
  std::free(c->bag_nnz);
  std::free(c->bag_has_dups);
  std::free(c->key_bytes);
  std::free(c->key_offsets);
  std::free(c->tag_ids);
  std::free(c->tag_val_bytes);
  std::free(c->tag_val_offsets);
  std::free(c);
}

}  // extern "C"
