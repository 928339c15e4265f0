// Native columnar writers for TrainingExampleAvro, BayesianLinearModelAvro
// and ScoringResultAvro container files.
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
//
// The model and score writers (photon_avro_write_models_*,
// photon_avro_write_scores) emit, record for record, what the reference's
// per-record writer emits for the same inputs (photon_ml_tpu/io/
// model_store.py, score_store.py): same field order, same union branches,
// same array/map framing, doubles of the same values, in deflate blocks of
// 4096 records as the reference's container writer makes them. Each
// feature's encoded (name, term) bytes come from Python once per index
// map. Without zlib they write nothing and return -1.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#ifdef AVRO_WITH_ZLIB
#include <zlib.h>
#endif

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

constexpr int64_t kBlockRecords = 4096;

// Raw deflate (no zlib header or trailer) of `in` at zlib's default level:
// the bytes Python's zlib.compress(raw)[2:-4] gives. False without zlib.
bool deflate_raw(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
#ifdef AVRO_WITH_ZLIB
  z_stream zs{};
  if (deflateInit2(&zs, Z_DEFAULT_COMPRESSION, Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  out.resize(deflateBound(&zs, (uLong)in.size()));
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = (uInt)in.size();
  zs.next_out = out.data();
  zs.avail_out = (uInt)out.size();
  int rc = deflate(&zs, Z_FINISH);
  out.resize(zs.total_out);
  deflateEnd(&zs);
  return rc == Z_STREAM_END;
#else
  (void)in;
  (void)out;
  return false;
#endif
}

// Append records [0, n) to `path` (header written by Python) as deflate
// blocks of kBlockRecords records: [count][size][deflated payload][sync].
// `encode(buf, r)` appends record r. Up to `threads` workers encode and
// compress a window of blocks at a time; the blocks go to the file in
// record order. Returns n, or -1 on any failure.
template <typename Encode>
int64_t write_deflate_blocks(const char* path, const uint8_t* sync, int64_t n,
                             int32_t threads, const Encode& encode) {
  std::FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  if (threads < 1) threads = 1;
  const int64_t n_blocks = (n + kBlockRecords - 1) / kBlockRecords;
  const int64_t window = (int64_t)threads * 4;
  std::vector<std::vector<uint8_t>> packed(std::min(window, n_blocks));
  bool ok = true;
  for (int64_t w0 = 0; w0 < n_blocks && ok; w0 += window) {
    const int64_t w1 = std::min(n_blocks, w0 + window);
    const int64_t workers = std::min<int64_t>(threads, w1 - w0);
    std::vector<char> good(w1 - w0, 0);
    auto work = [&](int64_t t) {
      std::vector<uint8_t> raw, z;
      for (int64_t b = w0 + t; b < w1; b += workers) {
        const int64_t lo = b * kBlockRecords;
        const int64_t hi = std::min(n, lo + kBlockRecords);
        raw.clear();
        for (int64_t r = lo; r < hi; ++r) encode(raw, r);
        if (!deflate_raw(raw, z)) continue;
        std::vector<uint8_t>& out = packed[b - w0];
        out.clear();
        put_long(out, hi - lo);
        put_long(out, (int64_t)z.size());
        out.insert(out.end(), z.begin(), z.end());
        out.insert(out.end(), sync, sync + 16);
        good[b - w0] = 1;
      }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < workers; ++t) pool.emplace_back(work, t);
    work(0);
    for (std::thread& th : pool) th.join();
    for (int64_t b = w0; b < w1 && ok; ++b) {
      const std::vector<uint8_t>& out = packed[b - w0];
      ok = good[b - w0] && std::fwrite(out.data(), 1, out.size(), f) == out.size();
    }
  }
  ok = std::fclose(f) == 0 && ok;
  return ok ? n : -1;
}

// An array<NameTermValueAvro> of row `row` (d values): the entries whose
// magnitude exceeds `threshold` (compared in T, as numpy compares a T array
// with a Python float) and whose index has a name, in index order. With
// `finite_only`, non-finite values count as 0 first.
template <typename T>
void put_ntv_array(std::vector<uint8_t>& out, const T* row, int64_t d,
                   T threshold, bool finite_only, const uint8_t* feat_blob,
                   const int64_t* feat_offs) {
  int64_t count = 0;
  for (int64_t j = 0; j < d; ++j) {
    T v = row[j];
    if (finite_only && !std::isfinite(v)) v = 0;
    if (std::fabs(v) > threshold && feat_offs[j + 1] > feat_offs[j]) ++count;
  }
  if (count > 0) {
    put_long(out, count);
    for (int64_t j = 0; j < d; ++j) {
      T v = row[j];
      if (finite_only && !std::isfinite(v)) v = 0;
      if (std::fabs(v) > threshold && feat_offs[j + 1] > feat_offs[j]) {
        out.insert(out.end(), feat_blob + feat_offs[j], feat_blob + feat_offs[j + 1]);
        put_double(out, (double)v);
      }
    }
  }
  out.push_back(0);  // array terminator
}

// BayesianLinearModelAvro records, one a row of `means` ((n, d) row-major):
// modelId | modelClass: union(null, string) | means | variances:
// union(null, array) (null when `variances` is null; else non-finite values
// written as 0, zeros dropped) | lossFunction: null.
template <typename T>
int64_t write_models(const char* path, const uint8_t* sync, int64_t n,
                     int64_t d, const T* means, const T* variances,
                     double threshold, const char* id_bytes,
                     const int64_t* id_offs, const char* model_class,
                     const uint8_t* feat_blob, const int64_t* feat_offs,
                     int32_t threads) {
  std::vector<uint8_t> class_enc;
  if (model_class) {
    put_long(class_enc, 1);
    put_str(class_enc, model_class, (int64_t)std::strlen(model_class));
  } else {
    class_enc.push_back(0);
  }
  const T thr = (T)threshold;
  return write_deflate_blocks(path, sync, n, threads, [&](std::vector<uint8_t>& buf, int64_t r) {
    put_str(buf, id_bytes + id_offs[r], id_offs[r + 1] - id_offs[r]);
    buf.insert(buf.end(), class_enc.begin(), class_enc.end());
    put_ntv_array(buf, means + r * d, d, thr, false, feat_blob, feat_offs);
    if (variances) {
      put_long(buf, 1);
      put_ntv_array(buf, variances + r * d, d, (T)0, true, feat_blob, feat_offs);
    } else {
      buf.push_back(0);
    }
    buf.push_back(0);  // lossFunction: null
  });
}

}  // namespace

extern "C" {

// Append BayesianLinearModelAvro deflate blocks to `path` (header written
// by Python). feat_offs has d + 1 entries into feat_blob, each range the
// encoded (name, term) pair of one index, empty for an index with no name.
// Returns the records written, or -1.
int64_t photon_avro_write_models_f32(
    const char* path, const uint8_t* sync, int64_t n, int64_t d,
    const float* means, const float* variances, double threshold,
    const char* id_bytes, const int64_t* id_offs, const char* model_class,
    const uint8_t* feat_blob, const int64_t* feat_offs, int32_t threads) {
  return write_models<float>(path, sync, n, d, means, variances, threshold,
                             id_bytes, id_offs, model_class, feat_blob,
                             feat_offs, threads);
}

int64_t photon_avro_write_models_f64(
    const char* path, const uint8_t* sync, int64_t n, int64_t d,
    const double* means, const double* variances, double threshold,
    const char* id_bytes, const int64_t* id_offs, const char* model_class,
    const uint8_t* feat_blob, const int64_t* feat_offs, int32_t threads) {
  return write_models<double>(path, sync, n, d, means, variances, threshold,
                              id_bytes, id_offs, model_class, feat_blob,
                              feat_offs, threads);
}

// Append ScoringResultAvro deflate blocks for rows [0, n) to `path`:
// uid: union(null, string) | label: union(null, double) | modelId |
// predictionScore | weight: union(null, double) | metadataMap: null.
// uid_kind 0 writes null uids, 1 formats uid_vals as decimal integers, 2
// takes uid_vals as codes into the string table (uid_tbl_bytes,
// uid_tbl_offs). labels/weights may be null (null branch). Returns the
// records written, or -1.
int64_t photon_avro_write_scores(
    const char* path, const uint8_t* sync, int64_t n, const double* scores,
    const double* labels, const double* weights, const char* model_id,
    int32_t uid_kind, const int64_t* uid_vals, const char* uid_tbl_bytes,
    const int64_t* uid_tbl_offs, int32_t threads) {
  std::vector<uint8_t> mid_enc;
  put_str(mid_enc, model_id, (int64_t)std::strlen(model_id));
  return write_deflate_blocks(path, sync, n, threads, [&](std::vector<uint8_t>& buf, int64_t r) {
    if (uid_kind == 0) {
      buf.push_back(0);
    } else if (uid_kind == 1) {
      put_long(buf, 1);
      char tmp[24];
      int len = std::snprintf(tmp, sizeof tmp, "%lld", (long long)uid_vals[r]);
      put_str(buf, tmp, len);
    } else {
      put_long(buf, 1);
      int64_t c = uid_vals[r];
      put_str(buf, uid_tbl_bytes + uid_tbl_offs[c], uid_tbl_offs[c + 1] - uid_tbl_offs[c]);
    }
    if (labels) {
      put_long(buf, 1);
      put_double(buf, labels[r]);
    } else {
      buf.push_back(0);
    }
    buf.insert(buf.end(), mid_enc.begin(), mid_enc.end());
    put_double(buf, scores[r]);
    if (weights) {
      put_long(buf, 1);
      put_double(buf, weights[r]);
    } else {
      buf.push_back(0);
    }
    buf.push_back(0);  // metadataMap: null
  });
}

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
