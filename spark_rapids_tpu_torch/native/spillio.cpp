// Native spill/shuffle block IO — the host-runtime role the reference
// fills with native code (JCudfSerialization framing, RapidsDiskStore
// writes, dev/host_memory_leaks tooling are its native-adjacent layer).
//
// Block format: [magic u64][payload_len u64][xxhash64 u64][payload...]
// An appender handle writes many blocks to one file (the multithreaded
// shuffle writer's data-file shape: index = (offset, len) list returned
// to the caller).  All calls are GIL-free from Python's point of view
// (ctypes releases the GIL), so spill/shuffle worker threads overlap
// their IO with device work.
//
// Build: g++ -O2 -shared -fPIC spillio.cpp -o libspillio.so
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

static const uint64_t MAGIC = 0x53525450554C4F42ULL; // "SRTPULOB"

// ---------------------------------------------------------------------------
// xxhash64 (public algorithm; straightforward implementation)
// ---------------------------------------------------------------------------
static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

static inline uint64_t read32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return (uint64_t)v;
}

static inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl(acc, 31);
  acc *= P1;
  return acc;
}

static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  val = round1(0, val);
  acc ^= val;
  acc = acc * P1 + P4;
  return acc;
}

extern "C" uint64_t spill_xxhash64(const uint8_t* data, int64_t len,
                                   uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
             v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, read64(p)); p += 8;
      v2 = round1(v2, read64(p)); p += 8;
      v3 = round1(v3, read64(p)); p += 8;
      v4 = round1(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= read32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Single-block spill files
// ---------------------------------------------------------------------------

extern "C" int64_t spill_write(const char* path, const uint8_t* data,
                               int64_t len) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint64_t header[3] = {MAGIC, (uint64_t)len,
                        spill_xxhash64(data, len, 0)};
  int64_t out = -1;
  if (fwrite(header, 8, 3, f) == 3 &&
      (len == 0 || fwrite(data, 1, (size_t)len, f) == (size_t)len)) {
    out = len + 24;
  }
  if (fclose(f) != 0) out = -1;
  return out;
}

// Returns payload length; negative on error:
//   -1 open/short-read, -2 bad magic, -3 capacity too small,
//   -4 checksum mismatch
extern "C" int64_t spill_read(const char* path, uint8_t* out,
                              int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t header[3];
  int64_t r = -1;
  if (fread(header, 8, 3, f) == 3) {
    if (header[0] != MAGIC) {
      r = -2;
    } else if ((int64_t)header[1] > cap) {
      r = -3;
    } else if (header[1] == 0 ||
               fread(out, 1, (size_t)header[1], f) == header[1]) {
      if (spill_xxhash64(out, (int64_t)header[1], 0) == header[2]) {
        r = (int64_t)header[1];
      } else {
        r = -4;
      }
    }
  }
  fclose(f);
  return r;
}

// Peek the payload length (for buffer sizing); negative on error.
extern "C" int64_t spill_length(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t header[3];
  int64_t r = -1;
  if (fread(header, 8, 3, f) == 3 && header[0] == MAGIC) {
    r = (int64_t)header[1];
  }
  fclose(f);
  return r;
}

// ---------------------------------------------------------------------------
// Multi-block appender (shuffle data-file shape)
// ---------------------------------------------------------------------------

struct Appender {
  FILE* f;
  int64_t offset;
};

extern "C" void* shuffle_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Appender* a = (Appender*)malloc(sizeof(Appender));
  a->f = f;
  a->offset = 0;
  return a;
}

// Appends one framed block; returns its starting offset, or -1.
extern "C" int64_t shuffle_append(void* handle, const uint8_t* data,
                                  int64_t len) {
  Appender* a = (Appender*)handle;
  uint64_t header[3] = {MAGIC, (uint64_t)len,
                        spill_xxhash64(data, len, 0)};
  if (fwrite(header, 8, 3, a->f) != 3) return -1;
  if (len && fwrite(data, 1, (size_t)len, a->f) != (size_t)len) return -1;
  int64_t at = a->offset;
  a->offset += 24 + len;
  return at;
}

extern "C" int64_t shuffle_close(void* handle) {
  Appender* a = (Appender*)handle;
  int64_t total = a->offset;
  int rc = fclose(a->f);
  free(a);
  return rc == 0 ? total : -1;
}

// Reads the framed block at `offset`; same return codes as spill_read.
extern "C" int64_t shuffle_read_block(const char* path, int64_t offset,
                                      uint8_t* out, int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t r = -1;
  if (fseek(f, (long)offset, SEEK_SET) == 0) {
    uint64_t header[3];
    if (fread(header, 8, 3, f) == 3) {
      if (header[0] != MAGIC) {
        r = -2;
      } else if ((int64_t)header[1] > cap) {
        r = -3;
      } else if (header[1] == 0 ||
                 fread(out, 1, (size_t)header[1], f) == header[1]) {
        r = spill_xxhash64(out, (int64_t)header[1], 0) == header[2]
                ? (int64_t)header[1] : -4;
      }
    }
  }
  fclose(f);
  return r;
}
