// scdio: the port's host library for the training input path. It
// memory-maps a `.d` zip, reads its central directory (ZIP64 included),
// inflates the npy payloads straight into caller-provided contiguous
// buffers with worker threads, packs shuffled batches with memcpy, and
// computes the inference grayscale of a slide in one pass.
//
// Counterpart of the JAX package's native/scdio.cpp, with the same C entry
// points (ctypes, no Python headers). Differences:
//   - ZIP64: the end-of-central-directory record's 16-bit entry count and
//     32-bit offsets saturate once an archive holds more than 65,535
//     entries or 4 GiB; the ZIP64 end record (found through its locator)
//     and the ZIP64 extra fields carry the real values. Python's zipfile
//     writes both;
//   - every payload's CRC-32 is checked, as zipfile's reader does, so a
//     corrupt entry fails here as it fails there;
//   - zlib's few entry points are declared here (their ABI is stable) and
//     the library links libz.so.1, so it builds where zlib's headers are
//     missing.
//
// Supported subset: entries stored (method 0) or deflated (method 8), npy
// format v1.x, little-endian f4/f8 arrays.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {
// zlib's z_stream (zlib.h; its layout is part of zlib's ABI) and the four
// functions used here
struct z_stream {
  const unsigned char *next_in;
  unsigned int avail_in;
  unsigned long total_in;
  unsigned char *next_out;
  unsigned int avail_out;
  unsigned long total_out;
  const char *msg;
  void *state;
  void *zalloc;
  void *zfree;
  void *opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
};
int inflateInit2_(z_stream *strm, int window_bits, const char *version,
                  int stream_size);
int inflate(z_stream *strm, int flush);
int inflateEnd(z_stream *strm);
unsigned long crc32(unsigned long crc, const unsigned char *buf,
                    unsigned int len);
}

namespace {

constexpr int Z_OK = 0;
constexpr int Z_STREAM_END = 1;
constexpr int Z_FINISH = 4;
constexpr int MAX_WBITS = 15;
// zlib checks only the first character of the version it was given
constexpr const char *ZLIB_MAJOR = "1";

struct Entry {
  std::string name;
  uint64_t compressed_size = 0;
  uint64_t uncompressed_size = 0;
  uint64_t header_offset = 0;
  uint32_t crc = 0;
  uint16_t method = 0;
};

struct Archive {
  int fd = -1;
  const uint8_t *map = nullptr;
  size_t size = 0;
  std::vector<Entry> entries;
};

uint16_t rd16(const uint8_t *p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t *p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
uint64_t rd64(const uint8_t *p) {
  return rd32(p) | ((uint64_t)rd32(p + 4) << 32);
}

// the central directory's offset and entry count: from the end record
// (scanned for back over the comment), or from the ZIP64 end record when
// its locator sits just before the end record
bool find_central_directory(const uint8_t *map, size_t size,
                            uint64_t *cd_offset, uint64_t *cd_count) {
  if (size < 22) return false;
  size_t max_back = size < (22 + 65535) ? size : (22 + 65535);
  for (size_t back = 22; back <= max_back; back++) {
    size_t eocd = size - back;
    const uint8_t *p = map + eocd;
    if (rd32(p) != 0x06054b50) continue;
    *cd_count = rd16(p + 10);
    *cd_offset = rd32(p + 16);
    if (eocd >= 20 && rd32(p - 20) == 0x07064b50) {
      uint64_t rec = rd64(p - 20 + 8);
      if (rec > size || size - rec < 56) return false;
      const uint8_t *z = map + rec;
      if (rd32(z) != 0x06064b50) return false;
      *cd_count = rd64(z + 32);
      *cd_offset = rd64(z + 48);
    }
    return true;
  }
  return false;
}

// the ZIP64 extra field (id 1) of a central-directory entry: each of the
// sizes and the offset that saturated at 0xFFFFFFFF follows, in order
bool read_zip64_extra(const uint8_t *extra, uint16_t len, Entry *e) {
  bool need_u = e->uncompressed_size == 0xFFFFFFFFu;
  bool need_c = e->compressed_size == 0xFFFFFFFFu;
  bool need_o = e->header_offset == 0xFFFFFFFFu;
  if (!need_u && !need_c && !need_o) return true;
  const uint8_t *p = extra, *end = extra + len;
  while (p + 4 <= end) {
    uint16_t id = rd16(p), size = rd16(p + 2);
    const uint8_t *data = p + 4, *data_end = data + size;
    if (data_end > end) return false;
    if (id == 1) {
      if (need_u) {
        if (data + 8 > data_end) return false;
        e->uncompressed_size = rd64(data);
        data += 8;
      }
      if (need_c) {
        if (data + 8 > data_end) return false;
        e->compressed_size = rd64(data);
        data += 8;
      }
      if (need_o) {
        if (data + 8 > data_end) return false;
        e->header_offset = rd64(data);
      }
      return true;
    }
    p = data_end;
  }
  return false;  // saturated fields and no ZIP64 extra
}

bool parse_central_directory(Archive *ar) {
  uint64_t cd_offset, cd_count;
  if (!find_central_directory(ar->map, ar->size, &cd_offset, &cd_count))
    return false;
  if (cd_offset >= ar->size) return false;
  const uint8_t *p = ar->map + cd_offset;
  const uint8_t *end = ar->map + ar->size;
  // each entry takes at least 46 bytes: a count beyond that is corrupt
  if (cd_count > (uint64_t)(end - p) / 46) return false;
  ar->entries.reserve(cd_count);
  for (uint64_t i = 0; i < cd_count; i++) {
    // every field read below stays inside the mapping
    if (p + 46 > end || rd32(p) != 0x02014b50) return false;
    Entry e;
    e.method = rd16(p + 10);
    e.crc = rd32(p + 16);
    e.compressed_size = rd32(p + 20);
    e.uncompressed_size = rd32(p + 24);
    uint16_t name_len = rd16(p + 28);
    uint16_t extra_len = rd16(p + 30);
    uint16_t comment_len = rd16(p + 32);
    e.header_offset = rd32(p + 42);
    if (p + 46 + name_len + extra_len + comment_len > end) return false;
    if (!read_zip64_extra(p + 46 + name_len, extra_len, &e)) return false;
    if (e.header_offset + 30 > ar->size) return false;
    e.name.assign(reinterpret_cast<const char *>(p + 46), name_len);
    ar->entries.push_back(std::move(e));
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// the entry's payload: past the local file header at header_offset
const uint8_t *entry_data(const Archive *ar, const Entry &e) {
  if (e.header_offset + 30 > ar->size) return nullptr;
  const uint8_t *p = ar->map + e.header_offset;
  if (rd32(p) != 0x04034b50) return nullptr;
  uint16_t name_len = rd16(p + 26);
  uint16_t extra_len = rd16(p + 28);
  uint64_t data_off = e.header_offset + 30 + name_len + extra_len;
  if (data_off > ar->size || e.compressed_size > ar->size - data_off)
    return nullptr;
  return ar->map + data_off;
}

// inflate (or copy) the entry into `out` (its uncompressed size) and check
// its CRC-32; one zlib call each, so entries stay below 4 GiB
bool inflate_entry(const Archive *ar, const Entry &e, uint8_t *out) {
  const uint8_t *src = entry_data(ar, e);
  if (!src || e.compressed_size > 0xFFFFFFFFu ||
      e.uncompressed_size > 0xFFFFFFFFu)
    return false;
  if (e.method == 0) {
    if (e.compressed_size != e.uncompressed_size) return false;
    memcpy(out, src, e.uncompressed_size);
  } else if (e.method == 8) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2_(&zs, -MAX_WBITS, ZLIB_MAJOR, (int)sizeof(zs)) != Z_OK)
      return false;
    zs.next_in = src;
    zs.avail_in = (unsigned int)e.compressed_size;
    zs.next_out = out;
    zs.avail_out = (unsigned int)e.uncompressed_size;
    int ret = inflate(&zs, Z_FINISH);
    uint64_t produced = zs.total_out;
    inflateEnd(&zs);
    if (ret != Z_STREAM_END || produced != e.uncompressed_size) return false;
  } else {
    return false;
  }
  return crc32(0, out, (unsigned int)e.uncompressed_size) == e.crc;
}

// parse an npy v1.x header inside `buf`; returns the data pointer (nullptr
// unless the header is a little-endian f4/f8 array whose data fits `buf`)
// and fills the shape
const uint8_t *parse_npy(const uint8_t *buf, size_t size, int64_t *shape,
                         int *ndim, int *is_f8) {
  if (size < 10 || memcmp(buf, "\x93NUMPY", 6) != 0 || buf[6] != 1)
    return nullptr;
  uint16_t header_len = rd16(buf + 8);
  if (10 + (size_t)header_len > size) return nullptr;
  std::string header(reinterpret_cast<const char *>(buf + 10), header_len);
  if (header.find("'fortran_order': False") == std::string::npos)
    return nullptr;
  *is_f8 = header.find("'<f8'") != std::string::npos ? 1 : 0;
  if (!*is_f8 && header.find("'<f4'") == std::string::npos) return nullptr;
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return nullptr;
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return nullptr;
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  *ndim = 0;
  int64_t count = 1;
  const char *cursor = dims.c_str();
  while (*cursor) {
    while (*cursor == ' ' || *cursor == ',') cursor++;
    if (!*cursor) break;
    if (*ndim == 4) return nullptr;
    char *next;
    shape[*ndim] = strtoll(cursor, &next, 10);
    if (next == cursor || shape[*ndim] < 0) return nullptr;
    count *= shape[(*ndim)++];
    cursor = next;
  }
  size_t need = (size_t)count * (*is_f8 ? 8 : 4);
  if (size - 10 - header_len < need) return nullptr;
  return buf + 10 + header_len;
}

void copy_npy_floats(const uint8_t *data, int is_f8, int64_t count,
                     float *out) {
  if (is_f8) {
    for (int64_t i = 0; i < count; i++) {
      double v;
      memcpy(&v, data + 8 * i, 8);
      out[i] = (float)v;
    }
  } else {
    memcpy(out, data, count * sizeof(float));
  }
}

}  // namespace

extern "C" {

void *scdio_open(const char *path) {
  Archive *ar = new Archive();
  ar->fd = open(path, O_RDONLY);
  if (ar->fd < 0) {
    delete ar;
    return nullptr;
  }
  struct stat st;
  if (fstat(ar->fd, &st) != 0 || st.st_size < 22) {
    close(ar->fd);
    delete ar;
    return nullptr;
  }
  ar->size = st.st_size;
  void *map = mmap(nullptr, ar->size, PROT_READ, MAP_PRIVATE, ar->fd, 0);
  ar->map = map == MAP_FAILED ? nullptr : static_cast<const uint8_t *>(map);
  if (!ar->map || !parse_central_directory(ar)) {
    if (ar->map) munmap(map, ar->size);
    close(ar->fd);
    delete ar;
    return nullptr;
  }
  return ar;
}

void scdio_close(void *handle) {
  Archive *ar = static_cast<Archive *>(handle);
  if (!ar) return;
  munmap(const_cast<uint8_t *>(ar->map), ar->size);
  close(ar->fd);
  delete ar;
}

// number of entries under samples/
int64_t scdio_num_samples(void *handle) {
  Archive *ar = static_cast<Archive *>(handle);
  int64_t n = 0;
  for (const auto &e : ar->entries)
    if (e.name.rfind("samples/", 0) == 0) n++;
  return n;
}

// the inflated size of a named entry, -1 when there is none
int64_t scdio_entry_size(void *handle, const char *name) {
  Archive *ar = static_cast<Archive *>(handle);
  for (const auto &e : ar->entries)
    if (e.name == name) return (int64_t)e.uncompressed_size;
  return -1;
}

// read one named entry, inflated, into `out` (sized by scdio_entry_size):
// 0, -1 when there is no such entry, -2 when it does not inflate or fails
// its CRC
int scdio_read_entry(void *handle, const char *name, uint8_t *out) {
  Archive *ar = static_cast<Archive *>(handle);
  for (const auto &e : ar->entries)
    if (e.name == name) return inflate_entry(ar, e, out) ? 0 : -2;
  return -1;
}

// Load every samples/<name> (in the order of `names`, `count` NUL-separated
// entry names) into one contiguous (count, H, W) float32 buffer, and every
// locs/<name> into a (count, maxtag, 8) float32 buffer (zero padded; records
// beyond maxtag dropped) with the (count,) int32 record counts, on `threads`
// worker threads. Returns 0, or -(i + 1) for the first entry i that failed.
int scdio_load_dataset(void *handle, const char *names, int64_t count,
                       int64_t hw, int64_t maxtag, float *samples_out,
                       float *locs_out, int32_t *counts_out, int threads) {
  Archive *ar = static_cast<Archive *>(handle);

  // hash-index the requested names for O(entries + count) matching
  std::unordered_map<std::string, int64_t> name_index;
  name_index.reserve(count * 2);
  const char *cursor = names;
  for (int64_t i = 0; i < count; i++) {
    name_index.emplace(cursor, i);
    cursor += strlen(cursor) + 1;
  }

  std::vector<const Entry *> sample_entries(count, nullptr);
  std::vector<const Entry *> loc_entries(count, nullptr);
  for (const auto &e : ar->entries) {
    bool is_sample = e.name.rfind("samples/", 0) == 0;
    bool is_loc = e.name.rfind("locs/", 0) == 0;
    if (!is_sample && !is_loc) continue;
    auto it = name_index.find(e.name.substr(is_sample ? 8 : 5));
    if (it != name_index.end())
      (is_sample ? sample_entries : loc_entries)[it->second] = &e;
  }

  std::vector<int> errors(count, 0);
  auto worker = [&](int64_t begin, int64_t end) {
    std::vector<uint8_t> scratch;
    for (int64_t i = begin; i < end; i++) {
      const Entry *se = sample_entries[i];
      const Entry *le = loc_entries[i];
      if (!se || !le) {
        errors[i] = 1;
        continue;
      }
      scratch.resize(se->uncompressed_size);
      if (!inflate_entry(ar, *se, scratch.data())) {
        errors[i] = 2;
        continue;
      }
      int64_t shape[4];
      int ndim, is_f8;
      const uint8_t *data =
          parse_npy(scratch.data(), scratch.size(), shape, &ndim, &is_f8);
      if (!data || ndim != 2 || shape[0] * shape[1] != hw) {
        errors[i] = 3;
        continue;
      }
      copy_npy_floats(data, is_f8, hw, samples_out + i * hw);
      scratch.resize(le->uncompressed_size);
      if (!inflate_entry(ar, *le, scratch.data())) {
        errors[i] = 4;
        continue;
      }
      data = parse_npy(scratch.data(), scratch.size(), shape, &ndim, &is_f8);
      int64_t k = 0;
      if (data && ndim == 2 && shape[1] == 8) {
        k = shape[0] < maxtag ? shape[0] : maxtag;
        copy_npy_floats(data, is_f8, k * 8, locs_out + i * maxtag * 8);
      } else if (data && ndim == 1 && shape[0] == 0) {
        k = 0;  // a clip without objects, saved as a 1-D empty array
      } else {
        // any other layout is an error: dropping labels silently would
        // corrupt training
        errors[i] = 5;
        continue;
      }
      counts_out[i] = (int32_t)k;
    }
  };

  if (threads <= 1) {
    worker(0, count);
  } else {
    std::vector<std::thread> pool;
    int64_t chunk = (count + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
      int64_t begin = t * chunk;
      int64_t end = begin + chunk < count ? begin + chunk : count;
      if (begin >= end) break;
      pool.emplace_back(worker, begin, end);
    }
    for (auto &th : pool) th.join();
  }

  for (int64_t i = 0; i < count; i++)
    if (errors[i]) return -(int)(i + 1);
  return 0;
}

// pack a shuffled batch: out[b] = samples[indices[b]]
void scdio_gather_batch(const float *samples, int64_t hw,
                        const int64_t *indices, int64_t batch, float *out) {
  for (int64_t b = 0; b < batch; b++)
    memcpy(out + b * hw, samples + indices[b] * hw, hw * sizeof(float));
}

// the inference grayscale (reference test.py:21-33) in one pass over
// interleaved RGB, bit-exact to numpy's: double arithmetic in numpy's order
// ((0.1140 r + 0.5870 g) + 0.2989 b) and nearbyint under the default
// round-to-nearest-even mode, as numpy.round. Needs -ffp-contract=off: a
// fused multiply-add would round differently on some pixels.
void scdio_grayscale_u8(const uint8_t *rgb, int64_t n_px, uint8_t *out) {
  for (int64_t i = 0; i < n_px; i++) {
    const double r = rgb[3 * i];
    const double g = rgb[3 * i + 1];
    const double b = rgb[3 * i + 2];
    out[i] = (uint8_t)std::nearbyint(0.1140 * r + 0.5870 * g + 0.2989 * b);
  }
}

}  // extern "C"
