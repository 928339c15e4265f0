// Native columnar writer for TrainingExampleAvro container files.
//
// The pure-Python writer (io/avro.py write_container) encodes ~10k
// records/s — fine for fixtures, hopeless for generating or exporting
// north-star-scale datasets (BASELINE.md: MovieLens/KDD-class, 10^7-10^8
// rows). This writes the container BODY from columnar arrays at memory
// speed; Python writes the header (it owns the schema) and hands over the
// sync marker, mirroring the read-side split where Python compiles the
// schema and C consumes blocks (avro_reader.cc).
//
// Record layout is fixed to photon-avro-schemas' TrainingExampleAvro field
// order (the Python binding asserts the schema matches before calling):
//   uid: union(null,string)=null | label: double | features: array of
//   {name: string, term: string="" , value: double} | weight: double |
//   offset: double | metadataMap: union(null,map<string,string>) with one
//   constant key (the entity tag) or null.
// Codec: null (uncompressed) — generation/export throughput is the point.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

void put_long(std::vector<uint8_t>& out, int64_t v) {
  uint64_t n = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
  while (n & ~0x7Full) {
    out.push_back((uint8_t)((n & 0x7F) | 0x80));
    n >>= 7;
  }
  out.push_back((uint8_t)n);
}

void put_double(std::vector<uint8_t>& out, double v) {
  uint8_t b[8];
  std::memcpy(b, &v, 8);
  out.insert(out.end(), b, b + 8);
}

void put_str(std::vector<uint8_t>& out, const char* p, int64_t n) {
  put_long(out, n);
  out.insert(out.end(), (const uint8_t*)p, (const uint8_t*)p + n);
}

}  // namespace

extern "C" {

// Append `n` records as container blocks to `path` (header already
// written by Python). Returns bytes appended, or -1 on any failure.
// offsets/weights may be null (0.0 / 1.0). tag_bytes/tag_offs may be null
// (no string tag); otherwise each record carries one {tag_key: tag_value}
// entry. int_tag_keys ('\0'-separated, n_int_tags of them) with
// int_tag_vals ((n_int_tags, n) row-major) additionally write integer-id
// tags formatted as decimal strings IN C — entity-id tags at scale never
// touch Python string handling (symmetric with the reader's integer TAG
// branch). metadataMap is the null branch only when no tag of either kind
// is present.
int64_t photon_avro_write_training(
    const char* path, const uint8_t* sync, int64_t n, const double* labels,
    const double* offsets, const double* weights, const int64_t* indptr,
    const int32_t* name_ids, const double* values, const char* name_bytes,
    const int64_t* name_offs, int64_t n_names, const char* tag_key,
    const char* tag_bytes, const int64_t* tag_offs, int32_t n_int_tags,
    const char* int_tag_keys, const int64_t* int_tag_vals,
    int64_t block_records) {
  if (block_records <= 0) block_records = 4096;
  // Pre-encode every feature name once as [varint len][bytes][0x00 term].
  std::vector<uint8_t> name_blob;
  std::vector<size_t> blob_offs(n_names + 1, 0);
  for (int64_t i = 0; i < n_names; ++i) {
    int64_t len = name_offs[i + 1] - name_offs[i];
    put_str(name_blob, name_bytes + name_offs[i], len);
    name_blob.push_back(0);  // empty term string
    blob_offs[i + 1] = name_blob.size();
  }
  std::vector<uint8_t> key_enc;
  if (tag_key && tag_bytes && tag_offs)
    put_str(key_enc, tag_key, (int64_t)std::strlen(tag_key));
  std::vector<std::vector<uint8_t>> int_key_enc;
  if (n_int_tags > 0 && int_tag_keys && int_tag_vals) {
    const char* p = int_tag_keys;
    for (int32_t t = 0; t < n_int_tags; ++t) {
      int64_t len = (int64_t)std::strlen(p);
      int_key_enc.emplace_back();
      put_str(int_key_enc.back(), p, len);
      p += len + 1;
    }
  }
  const int64_t n_map_entries =
      (key_enc.empty() ? 0 : 1) + (int64_t)int_key_enc.size();

  std::FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  std::vector<uint8_t> buf;
  buf.reserve((size_t)block_records * 64);
  int64_t written = 0;
  bool ok = true;
  for (int64_t start = 0; start < n && ok; start += block_records) {
    int64_t cnt = std::min(block_records, n - start);
    buf.clear();
    for (int64_t r = start; r < start + cnt; ++r) {
      buf.push_back(0);  // uid: null branch
      put_double(buf, labels[r]);
      int64_t lo = indptr[r], hi = indptr[r + 1];
      if (hi > lo) {
        put_long(buf, hi - lo);
        for (int64_t e = lo; e < hi; ++e) {
          int32_t id = name_ids[e];
          if (id < 0 || id >= n_names) {
            ok = false;
            break;
          }
          buf.insert(buf.end(), name_blob.data() + blob_offs[id],
                     name_blob.data() + blob_offs[id + 1]);
          put_double(buf, values[e]);
        }
      }
      buf.push_back(0);  // array terminator
      put_double(buf, weights ? weights[r] : 1.0);
      put_double(buf, offsets ? offsets[r] : 0.0);
      if (n_map_entries > 0) {
        put_long(buf, 1);  // union branch: map
        put_long(buf, n_map_entries);
        if (!key_enc.empty()) {
          buf.insert(buf.end(), key_enc.begin(), key_enc.end());
          put_str(buf, tag_bytes + tag_offs[r],
                  tag_offs[r + 1] - tag_offs[r]);
        }
        for (size_t t = 0; t < int_key_enc.size(); ++t) {
          buf.insert(buf.end(), int_key_enc[t].begin(), int_key_enc[t].end());
          char tmp[24];
          int len = std::snprintf(tmp, sizeof tmp, "%lld",
                                  (long long)int_tag_vals[t * n + r]);
          put_str(buf, tmp, len);
        }
        buf.push_back(0);  // map terminator
      } else {
        buf.push_back(0);  // union branch: null
      }
    }
    if (!ok) break;
    std::vector<uint8_t> head;
    put_long(head, cnt);
    put_long(head, (int64_t)buf.size());
    ok = std::fwrite(head.data(), 1, head.size(), f) == head.size() &&
         std::fwrite(buf.data(), 1, buf.size(), f) == buf.size() &&
         std::fwrite(sync, 1, 16, f) == 16;
    written += (int64_t)(head.size() + buf.size() + 16);
  }
  ok = std::fclose(f) == 0 && ok;
  return ok ? written : -1;
}

}  // extern "C"
