// Memory-mapped persistent feature-index store ("PHIDX" format).
//
// The port's copy of photon_ml_tpu/native/index_store.cc, the counterpart of
// the reference's PalDB-backed off-heap index map (photon-api
// index/PalDBIndexMap.scala:43, PalDBIndexMapBuilder.scala:27;
// com.linkedin.paldb:paldb:1.1.0). Same operational model: one logical store
// is split into hash partitions built independently with partition-local
// indices starting at 0; readers memory-map each partition and resolve
// global indices with a cumulative-offset table (PalDBIndexMap.scala:36-44).
// The on-disk format is the JAX package's, byte for byte:
//
//   [0)   magic "PHIDX001"                         8 bytes
//   [8)   u64 num_keys
//   [16)  u64 num_slots      (power of two, open addressing, load <= 0.7)
//   [24)  u64 data_size      (bytes in the entry section)
//   [32)  slot table         num_slots * u64; 0 = empty, else entry_off + 1
//   [..)  entry section      per key: u32 key_len, u32 local_idx, key bytes
//   [..)  reverse table      num_keys * u64 entry offsets, position = local_idx
//
// Little-endian throughout. Reverse (idx -> name) lookup is O(1) because a
// partition's local indices are dense 0..n-1 (the indexing driver assigns
// them that way, mirroring FeatureIndexingDriver.scala:188's per-partition
// zip-with-index). Exposed through a C ABI for ctypes (native/index_store.py);
// the pure-Python reader and writer there are the plain version of this file,
// which the tests hold it against, never a route the drivers take.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'P', 'H', 'I', 'D', 'X', '0', '0', '1'};
constexpr uint64_t kHeaderSize = 32;

inline uint64_t fnv1a64(const char* data, int64_t len) {
  uint64_t h = 14695981039346656037ULL;
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

uint64_t slot_count_for(uint64_t n) {
  uint64_t slots = 16;
  while (slots * 7 < n * 10) slots <<= 1;  // load factor <= 0.7
  return slots;
}

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  uint64_t file_size = 0;
  uint64_t num_keys = 0;
  uint64_t num_slots = 0;
  uint64_t data_size = 0;
  const uint64_t* slots = nullptr;    // slot table
  const uint8_t* entries = nullptr;   // entry section
  const uint64_t* reverse = nullptr;  // reverse table
};

inline uint64_t read_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

}  // namespace

extern "C" {

// Build a partition file. `keys` is the concatenation of all key bytes;
// `key_offsets` has n+1 entries delimiting each key; key i gets local
// index i. Returns 0 on success, negative errno-style code on failure.
int64_t phidx_build(const char* path, const char* keys,
                    const int64_t* key_offsets, int64_t n) {
  const uint64_t num_slots = slot_count_for(static_cast<uint64_t>(n));
  std::vector<uint64_t> slot_table(num_slots, 0);

  // Entry section layout + hash insertion.
  uint64_t data_size = 0;
  std::vector<uint64_t> entry_offsets(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    entry_offsets[static_cast<size_t>(i)] = data_size;
    data_size += 8 + static_cast<uint64_t>(key_offsets[i + 1] - key_offsets[i]);
  }
  for (int64_t i = 0; i < n; ++i) {
    const char* key = keys + key_offsets[i];
    const int64_t len = key_offsets[i + 1] - key_offsets[i];
    uint64_t slot = fnv1a64(key, len) & (num_slots - 1);
    while (slot_table[slot] != 0) slot = (slot + 1) & (num_slots - 1);
    slot_table[slot] = entry_offsets[static_cast<size_t>(i)] + 1;
  }

  FILE* f = std::fopen(path, "wb");
  if (f == nullptr) return -1;
  bool ok = true;
  ok &= std::fwrite(kMagic, 1, 8, f) == 8;
  const uint64_t nk = static_cast<uint64_t>(n);
  ok &= std::fwrite(&nk, 8, 1, f) == 1;
  ok &= std::fwrite(&num_slots, 8, 1, f) == 1;
  ok &= std::fwrite(&data_size, 8, 1, f) == 1;
  ok &= std::fwrite(slot_table.data(), 8, num_slots, f) == num_slots;
  for (int64_t i = 0; i < n && ok; ++i) {
    const uint32_t len =
        static_cast<uint32_t>(key_offsets[i + 1] - key_offsets[i]);
    const uint32_t idx = static_cast<uint32_t>(i);
    ok &= std::fwrite(&len, 4, 1, f) == 1;
    ok &= std::fwrite(&idx, 4, 1, f) == 1;
    ok &= std::fwrite(keys + key_offsets[i], 1, len, f) == len;
  }
  ok &= std::fwrite(entry_offsets.data(), 8, static_cast<size_t>(n), f) ==
        static_cast<size_t>(n);
  if (std::fclose(f) != 0) ok = false;
  return ok ? 0 : -2;
}

void* phidx_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(kHeaderSize)) {
    ::close(fd);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(mem);
  if (std::memcmp(base, kMagic, 8) != 0) {
    ::munmap(mem, static_cast<size_t>(st.st_size));
    ::close(fd);
    return nullptr;
  }
  Reader* r = new Reader;
  r->fd = fd;
  r->base = base;
  r->file_size = static_cast<uint64_t>(st.st_size);
  r->num_keys = read_u64(base + 8);
  r->num_slots = read_u64(base + 16);
  r->data_size = read_u64(base + 24);
  r->slots = reinterpret_cast<const uint64_t*>(base + kHeaderSize);
  r->entries = base + kHeaderSize + 8 * r->num_slots;
  r->reverse = reinterpret_cast<const uint64_t*>(r->entries + r->data_size);
  const uint64_t expect =
      kHeaderSize + 8 * r->num_slots + r->data_size + 8 * r->num_keys;
  // Reject truncated/corrupt headers: probing masks with num_slots - 1, so
  // num_slots must be a nonzero power of two, and the sections must account
  // for the whole file.
  if (r->num_slots == 0 || (r->num_slots & (r->num_slots - 1)) != 0 ||
      expect != r->file_size) {
    ::munmap(mem, static_cast<size_t>(st.st_size));
    ::close(fd);
    delete r;
    return nullptr;
  }
  return r;
}

void phidx_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r == nullptr) return;
  ::munmap(const_cast<uint8_t*>(r->base), static_cast<size_t>(r->file_size));
  ::close(r->fd);
  delete r;
}

int64_t phidx_size(void* handle) {
  return static_cast<Reader*>(handle)->num_keys;
}

// name -> partition-local index; -1 if absent.
int64_t phidx_get(void* handle, const char* key, int64_t len) {
  const Reader* r = static_cast<Reader*>(handle);
  if (r->num_keys == 0) return -1;
  uint64_t slot = fnv1a64(key, len) & (r->num_slots - 1);
  for (uint64_t probes = 0; probes < r->num_slots; ++probes) {
    const uint64_t tagged = r->slots[slot];
    if (tagged == 0) return -1;
    const uint8_t* e = r->entries + (tagged - 1);
    uint32_t klen, idx;
    std::memcpy(&klen, e, 4);
    std::memcpy(&idx, e + 4, 4);
    if (static_cast<int64_t>(klen) == len &&
        std::memcmp(e + 8, key, static_cast<size_t>(len)) == 0) {
      return static_cast<int64_t>(idx);
    }
    slot = (slot + 1) & (r->num_slots - 1);
  }
  return -1;
}

// partition-local index -> name; returns name length (copied into buf up to
// cap bytes), or -1 if the index is out of range.
int64_t phidx_name(void* handle, int64_t idx, char* buf, int64_t cap) {
  const Reader* r = static_cast<Reader*>(handle);
  if (idx < 0 || static_cast<uint64_t>(idx) >= r->num_keys) return -1;
  const uint8_t* e = r->entries + r->reverse[idx];
  uint32_t klen;
  std::memcpy(&klen, e, 4);
  const int64_t n = static_cast<int64_t>(klen) < cap
                        ? static_cast<int64_t>(klen)
                        : cap;
  std::memcpy(buf, e + 8, static_cast<size_t>(n));
  return static_cast<int64_t>(klen);
}

// 64-bit FNV-1a of a byte string — exported so Python routes keys to the
// same partition the builder used without reimplementing the hash drifting.
uint64_t phidx_hash(const char* key, int64_t len) { return fnv1a64(key, len); }

}  // extern "C"
