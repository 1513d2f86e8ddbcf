// Host codecs of the port's Parquet reader and writer: Snappy (the raw
// block format Parquet stores), Zstandard frames (RFC 8878, no
// dictionaries) and the Parquet value decoders numpy cannot vectorize
// (the RLE / bit-packed hybrid, DELTA_BINARY_PACKED, PLAIN byte arrays).
//
// Every entry point is a plain C function over caller-owned buffers; a
// negative return is an error code.  ctypes releases the GIL around each
// call, so the reader's thread pool decodes column chunks in parallel.
//
// Build: g++ -O2 -shared -fPIC codecs.cpp -o libcodecs.so
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// Snappy
// ---------------------------------------------------------------------------

size_t varint_put(uint8_t* out, uint64_t v) {
  size_t n = 0;
  while (v >= 0x80) {
    out[n++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  out[n++] = (uint8_t)v;
  return n;
}

uint8_t* emit_literal(uint8_t* op, const uint8_t* src, size_t len) {
  size_t n = len - 1;
  if (n < 60) {
    *op++ = (uint8_t)(n << 2);
  } else {
    int bytes = n < (1u << 8) ? 1 : n < (1u << 16) ? 2 : n < (1u << 24) ? 3 : 4;
    *op++ = (uint8_t)((59 + bytes) << 2);
    for (int i = 0; i < bytes; i++) *op++ = (uint8_t)(n >> (8 * i));
  }
  memcpy(op, src, len);
  return op + len;
}

uint8_t* emit_copy_upto64(uint8_t* op, size_t offset, size_t len) {
  if (len < 12 && offset < 2048) {
    *op++ = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = (uint8_t)offset;
  } else {
    *op++ = (uint8_t)(2 | ((len - 1) << 2));
    *op++ = (uint8_t)offset;
    *op++ = (uint8_t)(offset >> 8);
  }
  return op;
}

uint8_t* emit_copy(uint8_t* op, size_t offset, size_t len) {
  while (len >= 68) {
    op = emit_copy_upto64(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64(op, offset, 60);
    len -= 60;
  }
  return emit_copy_upto64(op, offset, len);
}

const int kSnappyHashBits = 14;

inline uint32_t snappy_hash(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kSnappyHashBits);
}

// One fragment of at most 64 KiB: every offset fits two bytes.
uint8_t* snappy_fragment(const uint8_t* base, size_t n, uint8_t* op,
                         uint16_t* table) {
  memset(table, 0, sizeof(uint16_t) << kSnappyHashBits);
  const uint8_t* ip = base;
  const uint8_t* end = base + n;
  const uint8_t* next_emit = base;
  if (n >= 15) {
    const uint8_t* limit = end - 4;
    ip++;
    uint32_t skip = 32;
    while (ip < limit) {
      uint32_t cur = load32(ip);
      uint32_t h = snappy_hash(cur);
      const uint8_t* cand = base + table[h];
      table[h] = (uint16_t)(ip - base);
      if (cand < ip && load32(cand) == cur) {
        if (next_emit < ip) op = emit_literal(op, next_emit, ip - next_emit);
        size_t len = 4;
        while (ip + len < end && cand[len] == ip[len]) len++;
        op = emit_copy(op, ip - cand, len);
        ip += len;
        next_emit = ip;
        skip = 32;
        if (ip < limit) {
          // seed the table with the position before the next probe
          table[snappy_hash(load32(ip - 1))] = (uint16_t)(ip - 1 - base);
        }
      } else {
        ip += skip++ >> 5;
      }
    }
  }
  if (next_emit < end) op = emit_literal(op, next_emit, end - next_emit);
  return op;
}

// ---------------------------------------------------------------------------
// Zstandard: shared tables
// ---------------------------------------------------------------------------

const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
    16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const int ZSTD_BLOCK_MAX = 128 * 1024;

// error codes
const int64_t E_CORRUPT = -1;
const int64_t E_DST_SMALL = -2;
const int64_t E_UNSUPPORTED = -3;

// A backward bit stream (zstd's FSE and Huffman streams): the last byte's
// highest set bit marks the end; bits are read from there towards the
// first byte, and bits before the first byte read as zero.
struct BackBits {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;  // bits not yet read: [0, pos)

  bool init(const uint8_t* b, int64_t n) {
    buf = b;
    len = n;
    if (n <= 0 || b[n - 1] == 0) return false;
    pos = (n - 1) * 8 + highbit32(b[n - 1]);
    return true;
  }

  // bits [p, p + n) of the buffer, n <= 56, p >= 0
  uint64_t at(int64_t p, int n) const {
    int64_t byte = p >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len) {
      v = load64(buf + byte);
    } else {
      for (int64_t i = byte; i < len; i++) v |= (uint64_t)buf[i] << (8 * (i - byte));
    }
    v >>= (p & 7);
    return n >= 64 ? v : (v & ((1ull << n) - 1));
  }

  uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t p = pos - n;
    if (p >= 0) return at(p, n);
    int avail = (int)(n + p);
    if (avail <= 0) return 0;
    return at(0, avail) << (-p);
  }

  uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }

  bool overflowed() const { return pos < 0; }
};

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool ok = false;
};

bool fse_build(FseTable& tab, const int16_t* norm, int maxsym, int log) {
  int size = 1 << log;
  tab.log = log;
  tab.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(maxsym + 1);
  int high = size - 1;
  for (int s = 0; s <= maxsym; s++) {
    if (norm[s] == -1) {
      tab.t[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)(norm[s] > 0 ? norm[s] : 0);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s <= maxsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      tab.t[pos].symbol = (uint16_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; u++) {
    int s = tab.t[u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit32(ns);
    tab.t[u].nbits = (uint8_t)nb;
    tab.t[u].base = (uint16_t)((ns << nb) - size);
  }
  tab.ok = true;
  return true;
}

void fse_rle(FseTable& tab, int symbol) {
  tab.log = 0;
  tab.t.assign(1, FseEntry{(uint16_t)symbol, 0, 0});
  tab.ok = true;
}

// forward little-endian bit reader over a header (FSE table descriptions)
struct FwdBits {
  const uint8_t* buf;
  int64_t len;
  int64_t pos = 0;
  uint32_t peek(int n) const {
    uint64_t v = 0;
    int64_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < len; i++)
      v |= (uint64_t)buf[byte + i] << (8 * i);
    v >>= (pos & 7);
    return (uint32_t)(v & ((1ull << n) - 1));
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
};

// Reads an FSE table description; -> bytes consumed, or < 0.
int64_t fse_read_ncount(const uint8_t* src, int64_t n, int16_t* norm,
                        int* maxsym, int* log, int maxlog) {
  if (n < 1) return E_CORRUPT;
  FwdBits br{src, n};
  int al = (int)br.read(4) + 5;
  if (al > maxlog) return E_CORRUPT;
  int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1;
  int sym = 0, limit = *maxsym;
  bool prev0 = false;
  while (remaining > 1 && sym <= limit) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = br.read(2);
        n0 += (int)r;
        if (r != 3) break;
      }
      if (n0 > limit + 1) return E_CORRUPT;
      while (sym < n0) norm[sym++] = 0;
      if (sym > limit) break;
    }
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = br.peek(nbits);
    int count;
    if ((int)(v & (threshold - 1)) < max) {
      count = (int)(v & (threshold - 1));
      br.pos += nbits - 1;
    } else {
      count = (int)(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.pos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return E_CORRUPT;
  for (int s = sym; s <= limit; s++) norm[s] = 0;
  *maxsym = sym - 1;
  *log = al;
  int64_t used = (br.pos + 7) >> 3;
  return used > n ? E_CORRUPT : used;
}

struct Huffman {
  int maxbits = 0;
  std::vector<uint16_t> entry;  // symbol << 8 | nbits
  bool ok = false;
};

bool huf_build(Huffman& h, const uint8_t* weights, int nw) {
  // nw explicit weights; the last symbol's weight completes a power of 2
  uint32_t sum = 0;
  for (int i = 0; i < nw; i++) {
    if (weights[i] > 12) return false;
    if (weights[i]) sum += 1u << (weights[i] - 1);
  }
  if (sum == 0) return false;
  int maxbits = highbit32(sum) + 1;
  uint32_t rest = (1u << maxbits) - sum;
  if (rest & (rest - 1)) return false;
  int last = highbit32(rest) + 1;
  std::vector<uint8_t> w(weights, weights + nw);
  w.push_back((uint8_t)last);
  if (maxbits > 11) return false;
  uint32_t rank[13] = {0};
  for (uint8_t x : w) rank[x]++;
  uint32_t start[13] = {0}, nxt = 0;
  for (int k = 1; k <= maxbits; k++) {
    start[k] = nxt;
    nxt += rank[k] << (k - 1);
  }
  h.maxbits = maxbits;
  h.entry.assign(1u << maxbits, 0);
  for (size_t s = 0; s < w.size(); s++) {
    int k = w[s];
    if (!k) continue;
    uint32_t len = 1u << (k - 1);
    uint16_t e = (uint16_t)((s << 8) | (maxbits + 1 - k));
    for (uint32_t i = 0; i < len; i++) h.entry[start[k] + i] = e;
    start[k] += len;
  }
  h.ok = true;
  return true;
}

// Reads a Huffman tree description; -> bytes consumed or < 0.
int64_t huf_read(Huffman& h, const uint8_t* src, int64_t n) {
  if (n < 1) return E_CORRUPT;
  int hb = src[0];
  uint8_t weights[256];
  int nw = 0;
  if (hb >= 128) {
    nw = hb - 127;
    int64_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) return E_CORRUPT;
    for (int i = 0; i < nw; i++) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    if (!huf_build(h, weights, nw)) return E_CORRUPT;
    return 1 + bytes;
  }
  if (1 + hb > n) return E_CORRUPT;
  const uint8_t* p = src + 1;
  int16_t norm[256];
  int maxsym = 255, log = 0;
  int64_t used = fse_read_ncount(p, hb, norm, &maxsym, &log, 6);
  if (used < 0) return used;
  FseTable tab;
  if (!fse_build(tab, norm, maxsym, log)) return E_CORRUPT;
  BackBits bits;
  if (!bits.init(p + used, hb - used)) return E_CORRUPT;
  uint32_t s1 = (uint32_t)bits.read(log), s2 = (uint32_t)bits.read(log);
  for (;;) {
    if (nw > 254) return E_CORRUPT;
    const FseEntry& e1 = tab.t[s1];
    weights[nw++] = (uint8_t)e1.symbol;
    s1 = e1.base + (uint32_t)bits.read(e1.nbits);
    if (bits.overflowed()) {
      weights[nw++] = (uint8_t)tab.t[s2].symbol;
      break;
    }
    if (nw > 254) return E_CORRUPT;
    const FseEntry& e2 = tab.t[s2];
    weights[nw++] = (uint8_t)e2.symbol;
    s2 = e2.base + (uint32_t)bits.read(e2.nbits);
    if (bits.overflowed()) {
      weights[nw++] = (uint8_t)tab.t[s1].symbol;
      break;
    }
  }
  if (!huf_build(h, weights, nw)) return E_CORRUPT;
  return 1 + hb;
}

bool huf_stream(const Huffman& h, const uint8_t* src, int64_t n,
                uint8_t* out, int64_t count) {
  BackBits bits;
  if (!bits.init(src, n)) return false;
  for (int64_t i = 0; i < count; i++) {
    uint16_t e = h.entry[bits.peek(h.maxbits)];
    out[i] = (uint8_t)(e >> 8);
    bits.pos -= e & 0xFF;
  }
  return bits.pos == 0;
}

struct FrameState {
  Huffman huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

struct Seq {
  uint32_t ll, ml, of;
};

int64_t read_table(FseTable& tab, int mode, const int16_t* dflt, int dmax,
                   int dlog, int maxsym, int maxlog, const uint8_t* p,
                   int64_t n) {
  if (mode == 0) {
    fse_build(tab, dflt, dmax, dlog);
    return 0;
  }
  if (mode == 1) {
    if (n < 1 || p[0] > maxsym) return E_CORRUPT;
    fse_rle(tab, p[0]);
    return 1;
  }
  if (mode == 2) {
    int16_t norm[64];
    int ms = maxsym, log = 0;
    int64_t used = fse_read_ncount(p, n, norm, &ms, &log, maxlog);
    if (used < 0) return used;
    if (!fse_build(tab, norm, ms, log)) return E_CORRUPT;
    return used;
  }
  return tab.ok ? 0 : E_CORRUPT;  // repeat
}

// Decodes one compressed block into out[pos...); -> new pos or < 0.
int64_t zstd_block(FrameState& st, const uint8_t* src, int64_t n,
                   uint8_t* out, int64_t pos, int64_t cap,
                   std::vector<uint8_t>& lit) {
  if (n < 1) return E_CORRUPT;
  int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  int64_t hsize, regen, csize = 0;
  const uint8_t* p = src;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      hsize = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      if (n < 2) return E_CORRUPT;
      hsize = 2;
      regen = (p[0] >> 4) | (p[1] << 4);
    } else {
      if (n < 3) return E_CORRUPT;
      hsize = 3;
      regen = (p[0] >> 4) | (p[1] << 4) | ((int64_t)p[2] << 12);
    }
    lit.resize(regen + 32);
    if (ltype == 0) {
      if (hsize + regen > n) return E_CORRUPT;
      memcpy(lit.data(), p + hsize, regen);
      p += hsize + regen;
    } else {
      if (hsize + 1 > n) return E_CORRUPT;
      memset(lit.data(), p[hsize], regen);
      p += hsize + 1;
    }
  } else {
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      if (n < 3) return E_CORRUPT;
      hsize = 3;
      uint32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      if (n < 4) return E_CORRUPT;
      hsize = 4;
      uint32_t v = load32(p);
      regen = (v >> 4) & 0x3FFF;
      csize = v >> 18;
    } else {
      if (n < 5) return E_CORRUPT;
      hsize = 5;
      uint64_t v = load32(p) | ((uint64_t)p[4] << 32);
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
    }
    if (hsize + csize > n) return E_CORRUPT;
    const uint8_t* lp = p + hsize;
    int64_t lrem = csize;
    if (ltype == 2) {
      int64_t used = huf_read(st.huf, lp, lrem);
      if (used < 0) return used;
      lp += used;
      lrem -= used;
    } else if (!st.huf.ok) {
      return E_CORRUPT;
    }
    lit.resize(regen + 32);
    if (streams == 1) {
      if (!huf_stream(st.huf, lp, lrem, lit.data(), regen)) return E_CORRUPT;
    } else {
      if (lrem < 6) return E_CORRUPT;
      int64_t s1 = lp[0] | (lp[1] << 8), s2 = lp[2] | (lp[3] << 8),
              s3 = lp[4] | (lp[5] << 8);
      int64_t s4 = lrem - 6 - s1 - s2 - s3;
      if (s4 < 1) return E_CORRUPT;
      int64_t seg = (regen + 3) / 4;
      if (seg * 3 > regen) return E_CORRUPT;
      const uint8_t* q = lp + 6;
      int64_t sizes[4] = {s1, s2, s3, s4};
      for (int k = 0; k < 4; k++) {
        int64_t cnt = k < 3 ? seg : regen - 3 * seg;
        if (!huf_stream(st.huf, q, sizes[k], lit.data() + k * seg, cnt))
          return E_CORRUPT;
        q += sizes[k];
      }
    }
    p += hsize + csize;
  }
  // sequences
  int64_t rem = n - (p - src);
  if (rem < 1) return E_CORRUPT;
  int64_t nseq = p[0];
  if (nseq < 128) {
    p += 1;
  } else if (nseq < 255) {
    if (rem < 2) return E_CORRUPT;
    nseq = ((nseq - 128) << 8) + p[1];
    p += 2;
  } else {
    if (rem < 3) return E_CORRUPT;
    nseq = p[1] + (p[2] << 8) + 0x7F00;
    p += 3;
  }
  const uint8_t* lp = lit.data();
  const uint8_t* lend = lp + (lit.size() - 32);
  if (nseq > 0) {
    rem = n - (p - src);
    if (rem < 1) return E_CORRUPT;
    int modes = p[0];
    if (modes & 3) return E_CORRUPT;
    p++;
    rem--;
    int64_t u = read_table(st.ll, (modes >> 6) & 3, LL_DEFAULT, 35, 6, 35, 9, p, rem);
    if (u < 0) return u;
    p += u;
    rem -= u;
    u = read_table(st.of, (modes >> 4) & 3, OF_DEFAULT, 28, 5, 31, 8, p, rem);
    if (u < 0) return u;
    p += u;
    rem -= u;
    u = read_table(st.ml, (modes >> 2) & 3, ML_DEFAULT, 52, 6, 52, 9, p, rem);
    if (u < 0) return u;
    p += u;
    rem -= u;
    BackBits bits;
    if (!bits.init(p, rem)) return E_CORRUPT;
    uint32_t sll = (uint32_t)bits.read(st.ll.log);
    uint32_t sof = (uint32_t)bits.read(st.of.log);
    uint32_t sml = (uint32_t)bits.read(st.ml.log);
    for (int64_t i = 0; i < nseq; i++) {
      const FseEntry& el = st.ll.t[sll];
      const FseEntry& eo = st.of.t[sof];
      const FseEntry& em = st.ml.t[sml];
      int llc = el.symbol, ofc = eo.symbol, mlc = em.symbol;
      if (llc > 35 || mlc > 52 || ofc > 31) return E_CORRUPT;
      uint32_t ofv = (1u << ofc) + (uint32_t)bits.read(ofc);
      uint32_t ml = ML_BASE[mlc] + (uint32_t)bits.read(ML_BITS[mlc]);
      uint32_t ll = LL_BASE[llc] + (uint32_t)bits.read(LL_BITS[llc]);
      uint32_t off;
      if (ofv > 3) {
        off = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = off;
      } else {
        uint32_t idx = ll == 0 ? ofv : ofv - 1;
        if (idx == 0) {
          off = st.rep[0];
        } else if (idx < 3) {
          off = st.rep[idx];
          if (idx == 2) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = off;
        } else {
          off = st.rep[0] - 1;
          st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sll = el.base + (uint32_t)bits.read(el.nbits);
        sml = em.base + (uint32_t)bits.read(em.nbits);
        sof = eo.base + (uint32_t)bits.read(eo.nbits);
      }
      // execute the sequence: its literals, then its match (16- and
      // 8-byte copies where the buffers have room past the end: the
      // literals carry 32 spare bytes, the output is checked)
      if (lp + ll > lend) return E_CORRUPT;
      if (pos + ll + ml > cap) return E_DST_SMALL;
      uint8_t* d = out + pos;
      if (ll <= 16 && pos + 16 <= cap) {
        memcpy(d, lp, 16);
      } else {
        memcpy(d, lp, ll);
      }
      lp += ll;
      pos += ll;
      d += ll;
      if (off == 0 || off > pos) return E_CORRUPT;
      const uint8_t* m = d - off;
      if (off >= 8 && pos + ml + 8 <= cap) {
        for (uint32_t k = 0; k < ml; k += 8) memcpy(d + k, m + k, 8);
      } else if (off >= ml) {
        memcpy(d, m, ml);
      } else {
        for (uint32_t k = 0; k < ml; k++) d[k] = m[k];
      }
      pos += ml;
    }
    if (bits.pos != 0) return E_CORRUPT;
  }
  int64_t tail = lend - lp;
  if (pos + tail > cap) return E_DST_SMALL;
  memcpy(out + pos, lp, tail);
  return pos + tail;
}

// ---------------------------------------------------------------------------
// Zstandard encoder: greedy matches, raw or RLE literals, the predefined
// FSE distributions for the sequences
// ---------------------------------------------------------------------------

struct FseCTable {
  int log;
  std::vector<uint16_t> state;
  std::vector<int32_t> delta_find;
  std::vector<uint32_t> delta_bits;
};

void fse_build_ctable(FseCTable& ct, const int16_t* norm, int maxsym,
                      int log) {
  int size = 1 << log, mask = size - 1, high = size - 1;
  int step = (size >> 1) + (size >> 3) + 3;
  std::vector<uint8_t> sym(size);
  std::vector<uint32_t> cumul(maxsym + 2);
  cumul[0] = 0;
  for (int u = 1; u <= maxsym + 1; u++) {
    if (norm[u - 1] == -1) {
      cumul[u] = cumul[u - 1] + 1;
      sym[high--] = (uint8_t)(u - 1);
    } else {
      cumul[u] = cumul[u - 1] + norm[u - 1];
    }
  }
  int pos = 0;
  for (int s = 0; s <= maxsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      sym[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  ct.log = log;
  ct.state.assign(size, 0);
  for (int u = 0; u < size; u++) ct.state[cumul[sym[u]]++] = (uint16_t)(size + u);
  ct.delta_find.assign(maxsym + 1, 0);
  ct.delta_bits.assign(maxsym + 1, 0);
  int total = 0;
  for (int s = 0; s <= maxsym; s++) {
    int c = norm[s];
    if (c == 0) {
      ct.delta_bits[s] = ((log + 1) << 16) - size;
    } else if (c == -1 || c == 1) {
      ct.delta_bits[s] = (log << 16) - size;
      ct.delta_find[s] = total - 1;
      total++;
    } else {
      int maxout = log - highbit32((uint32_t)(c - 1));
      uint32_t minplus = (uint32_t)c << maxout;
      ct.delta_bits[s] = (maxout << 16) - minplus;
      ct.delta_find[s] = total - c;
      total += c;
    }
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void add(uint64_t v, int n) {
    if (n == 0) return;
    acc |= (v & ((1ull << n) - 1)) << nbits;
    nbits += n;
    while (nbits >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      nbits -= 8;
    }
  }
  void close() {
    add(1, 1);
    if (nbits) out.push_back((uint8_t)acc);
    acc = 0;
    nbits = 0;
  }
};

struct CState {
  uint32_t value;
};

void fse_init_state(CState& s, const FseCTable& ct, int symbol) {
  uint32_t nb = (ct.delta_bits[symbol] + (1 << 15)) >> 16;
  uint32_t v = (nb << 16) - ct.delta_bits[symbol];
  s.value = ct.state[(v >> nb) + ct.delta_find[symbol]];
}

void fse_encode(BitWriter& bw, CState& s, const FseCTable& ct, int symbol) {
  uint32_t nb = (s.value + ct.delta_bits[symbol]) >> 16;
  bw.add(s.value, nb);
  s.value = ct.state[(s.value >> nb) + ct.delta_find[symbol]];
}

inline int ll_code(uint32_t ll) {
  static const uint8_t small[64] = {
      0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
      16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21,
      22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23, 23, 23, 23, 23,
      24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24};
  return ll < 64 ? small[ll] : highbit32(ll) + 19;
}

inline int ml_code(uint32_t mlbase) {  // mlbase = match length - 3
  static const uint8_t small[128] = {
      0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
      16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
      32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37,
      38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39,
      40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40,
      41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41,
      42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42,
      42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42};
  return mlbase < 128 ? small[mlbase] : highbit32(mlbase) + 36;
}

struct Encoder {
  FseCTable ll, of, ml;
  std::vector<uint32_t> table;  // hash -> absolute position + 1
  int hash_log;
  Encoder(int level) {
    fse_build_ctable(ll, LL_DEFAULT, 35, 6);
    fse_build_ctable(of, OF_DEFAULT, 28, 5);
    fse_build_ctable(ml, ML_DEFAULT, 52, 6);
    hash_log = level >= 9 ? 18 : level >= 3 ? 17 : 16;
    table.assign(1u << hash_log, 0);
  }
  inline uint32_t hash(const uint8_t* p) const {
    uint64_t v = load64(p) << 24;  // five bytes
    return (uint32_t)((v * 0x9E3779B185EBCA87ull) >> (64 - hash_log));
  }
};

const uint32_t MAX_OFFSET = (1u << 27) - 1;  // the predefined offset codes

// Compresses src[start, end) as one block; appends to out.
void zstd_encode_block(Encoder& enc, const uint8_t* src, int64_t start,
                       int64_t end, bool last, std::vector<uint8_t>& out) {
  std::vector<Seq> seqs;
  std::vector<uint8_t> lits;
  int64_t ip = start, anchor = start;
  int64_t limit = end - 8;
  while (ip < limit) {
    uint32_t h = enc.hash(src + ip);
    int64_t cand = (int64_t)enc.table[h] - 1;
    enc.table[h] = (uint32_t)(ip + 1);
    if (cand >= 0 && ip - cand <= MAX_OFFSET &&
        load32(src + cand) == load32(src + ip)) {
      int64_t len = 4;
      while (ip + len + 8 <= end) {
        uint64_t x = load64(src + cand + len) ^ load64(src + ip + len);
        if (x) {
          len += __builtin_ctzll(x) >> 3;
          goto extended;
        }
        len += 8;
      }
      while (ip + len < end && src[cand + len] == src[ip + len]) len++;
    extended:
      if (len > 131074) len = 131074;
      // extend backwards over pending literals
      while (ip > anchor && cand > 0 && src[ip - 1] == src[cand - 1] &&
             len < 131074) {
        ip--;
        cand--;
        len++;
      }
      lits.insert(lits.end(), src + anchor, src + ip);
      seqs.push_back(Seq{(uint32_t)(ip - anchor), (uint32_t)len,
                         (uint32_t)(ip - cand)});
      ip += len;
      anchor = ip;
      if (ip - 2 > start && ip < limit) {
        enc.table[enc.hash(src + ip - 2)] = (uint32_t)(ip - 2 + 1);
      }
    } else {
      ip += 1 + ((ip - anchor) >> 6);
    }
  }
  lits.insert(lits.end(), src + anchor, src + end);
  int64_t raw = end - start;
  std::vector<uint8_t> body;
  body.reserve(raw + 64);
  // literals section: RLE when every byte is one, else raw
  size_t nl = lits.size();
  bool rle = nl > 0;
  for (size_t i = 1; i < nl && rle; i++) rle = lits[i] == lits[0];
  int lt = rle ? 1 : 0;
  if (nl < 32) {
    body.push_back((uint8_t)((nl << 3) | lt));
  } else if (nl < 4096) {
    body.push_back((uint8_t)(((nl & 15) << 4) | (1 << 2) | lt));
    body.push_back((uint8_t)(nl >> 4));
  } else {
    body.push_back((uint8_t)(((nl & 15) << 4) | (3 << 2) | lt));
    body.push_back((uint8_t)(nl >> 4));
    body.push_back((uint8_t)(nl >> 12));
  }
  if (rle) {
    body.push_back(lits[0]);
  } else {
    body.insert(body.end(), lits.begin(), lits.end());
  }
  size_t ns = seqs.size();
  if (ns < 128) {
    body.push_back((uint8_t)ns);
  } else if (ns < 0x7F00) {
    body.push_back((uint8_t)((ns >> 8) + 128));
    body.push_back((uint8_t)ns);
  } else {
    body.push_back(255);
    body.push_back((uint8_t)(ns - 0x7F00));
    body.push_back((uint8_t)((ns - 0x7F00) >> 8));
  }
  if (ns) {
    body.push_back(0);  // all three predefined
    std::vector<uint8_t> llc(ns), mlc(ns), ofc(ns);
    for (size_t i = 0; i < ns; i++) {
      llc[i] = (uint8_t)ll_code(seqs[i].ll);
      mlc[i] = (uint8_t)ml_code(seqs[i].ml - 3);
      ofc[i] = (uint8_t)highbit32(seqs[i].of + 3);
    }
    BitWriter bw(body);
    CState sml, sof, sll;
    size_t k = ns - 1;
    fse_init_state(sml, enc.ml, mlc[k]);
    fse_init_state(sof, enc.of, ofc[k]);
    fse_init_state(sll, enc.ll, llc[k]);
    bw.add(seqs[k].ll, LL_BITS[llc[k]]);
    bw.add(seqs[k].ml - 3, ML_BITS[mlc[k]]);
    bw.add(seqs[k].of + 3, ofc[k]);
    for (size_t n = ns - 1; n-- > 0;) {
      fse_encode(bw, sof, enc.of, ofc[n]);
      fse_encode(bw, sml, enc.ml, mlc[n]);
      fse_encode(bw, sll, enc.ll, llc[n]);
      bw.add(seqs[n].ll, LL_BITS[llc[n]]);
      bw.add(seqs[n].ml - 3, ML_BITS[mlc[n]]);
      bw.add(seqs[n].of + 3, ofc[n]);
    }
    bw.add(sml.value, enc.ml.log);
    bw.add(sof.value, enc.of.log);
    bw.add(sll.value, enc.ll.log);
    bw.close();
  }
  uint32_t hdr;
  if ((int64_t)body.size() < raw) {
    hdr = (uint32_t)(last ? 1 : 0) | (2u << 1) | ((uint32_t)body.size() << 3);
    out.push_back((uint8_t)hdr);
    out.push_back((uint8_t)(hdr >> 8));
    out.push_back((uint8_t)(hdr >> 16));
    out.insert(out.end(), body.begin(), body.end());
  } else {
    hdr = (uint32_t)(last ? 1 : 0) | (0u << 1) | ((uint32_t)raw << 3);
    out.push_back((uint8_t)hdr);
    out.push_back((uint8_t)(hdr >> 8));
    out.push_back((uint8_t)(hdr >> 16));
    out.insert(out.end(), src + start, src + end);
  }
}

// ---------------------------------------------------------------------------
// Parquet value decoders
// ---------------------------------------------------------------------------

inline int64_t uleb(const uint8_t* p, int64_t n, int64_t* pos, uint64_t* v) {
  uint64_t r = 0;
  int shift = 0;
  while (*pos < n) {
    uint8_t b = p[(*pos)++];
    r |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *v = r;
      return 0;
    }
    shift += 7;
    if (shift > 63) return E_CORRUPT;
  }
  return E_CORRUPT;
}

// little-endian bit-unpacking of `count` values of `width` bits (<= 32)
void unpack_bits(const uint8_t* p, int64_t avail, int width, int64_t count,
                 int32_t* out) {
  if (width == 0) {
    memset(out, 0, count * sizeof(int32_t));
    return;
  }
  uint64_t mask = (width == 32) ? 0xFFFFFFFFull : ((1ull << width) - 1);
  for (int64_t i = 0; i < count; i++) {
    int64_t bit = i * width;
    int64_t byte = bit >> 3;
    uint64_t v = 0;
    if (byte + 8 <= avail) {
      v = load64(p + byte);
    } else {
      for (int64_t k = byte; k < avail && k < byte + 8; k++)
        v |= (uint64_t)p[k] << (8 * (k - byte));
    }
    out[i] = (int32_t)((v >> (bit & 7)) & mask);
  }
}

}  // namespace

extern "C" {

int64_t snappy_max_compressed(int64_t n) { return 32 + n + n / 6; }

int64_t snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  if (cap < snappy_max_compressed(n)) return E_DST_SMALL;
  uint8_t* op = dst + varint_put(dst, (uint64_t)n);
  std::vector<uint16_t> table(1 << kSnappyHashBits);
  for (int64_t at = 0; at < n; at += 65536) {
    int64_t len = n - at < 65536 ? n - at : 65536;
    op = snappy_fragment(src + at, (size_t)len, op, table.data());
  }
  return op - dst;
}

// the uncompressed length from the preamble, or < 0
int64_t snappy_length(const uint8_t* src, int64_t n) {
  int64_t pos = 0;
  uint64_t v;
  if (uleb(src, n, &pos, &v) < 0) return E_CORRUPT;
  return (int64_t)v;
}

int64_t snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
  int64_t pos = 0;
  uint64_t want;
  if (uleb(src, n, &pos, &want) < 0) return E_CORRUPT;
  if ((int64_t)want > cap) return E_DST_SMALL;
  int64_t op = 0;
  while (pos < n) {
    uint8_t tag = src[pos++];
    int kind = tag & 3;
    if (kind == 0) {
      int64_t len = tag >> 2;
      if (len >= 60) {
        int bytes = (int)len - 59;
        if (pos + bytes > n) return E_CORRUPT;
        len = 0;
        for (int i = 0; i < bytes; i++) len |= (int64_t)src[pos + i] << (8 * i);
        pos += bytes;
      }
      len += 1;
      if (pos + len > n || op + len > (int64_t)want) return E_CORRUPT;
      memcpy(dst + op, src + pos, len);
      pos += len;
      op += len;
      continue;
    }
    int64_t len, off;
    if (kind == 1) {
      if (pos + 1 > n) return E_CORRUPT;
      len = 4 + ((tag >> 2) & 7);
      off = ((int64_t)(tag >> 5) << 8) | src[pos];
      pos += 1;
    } else if (kind == 2) {
      if (pos + 2 > n) return E_CORRUPT;
      len = (tag >> 2) + 1;
      off = src[pos] | (src[pos + 1] << 8);
      pos += 2;
    } else {
      if (pos + 4 > n) return E_CORRUPT;
      len = (tag >> 2) + 1;
      off = load32(src + pos);
      pos += 4;
    }
    if (off == 0 || off > op || op + len > (int64_t)want) return E_CORRUPT;
    uint8_t* d = dst + op;
    const uint8_t* m = d - off;
    if (off >= len) {
      memcpy(d, m, len);
    } else {
      for (int64_t k = 0; k < len; k++) d[k] = m[k];
    }
    op += len;
  }
  return op == (int64_t)want ? op : E_CORRUPT;
}

// Decodes every frame of src into dst; -> bytes written or < 0.
int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  int64_t ip = 0, op = 0;
  std::vector<uint8_t> lit;
  while (ip < n) {
    if (n - ip < 4) return E_CORRUPT;
    uint32_t magic = load32(src + ip);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - ip < 8) return E_CORRUPT;
      ip += 8 + (int64_t)load32(src + ip + 4);
      continue;
    }
    if (magic != 0xFD2FB528u) return E_CORRUPT;
    ip += 4;
    if (ip >= n) return E_CORRUPT;
    uint8_t fhd = src[ip++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    int did_flag = fhd & 3;
    if (fhd & 8) return E_CORRUPT;  // reserved bit
    if (!single) ip += 1;          // window descriptor
    static const int did_size[4] = {0, 1, 2, 4};
    if (did_flag) {
      uint32_t did = 0;
      for (int i = 0; i < did_size[did_flag]; i++) did |= (uint32_t)src[ip + i] << (8 * i);
      if (did) return E_UNSUPPORTED;  // dictionaries are not supported
    }
    ip += did_size[did_flag];
    static const int fcs_size[4] = {0, 2, 4, 8};
    int fsz = fcs_flag == 0 ? (single ? 1 : 0) : fcs_size[fcs_flag];
    ip += fsz;
    if (ip > n) return E_CORRUPT;
    FrameState st;
    for (;;) {
      if (n - ip < 3) return E_CORRUPT;
      uint32_t bh = src[ip] | (src[ip + 1] << 8) | (src[ip + 2] << 16);
      ip += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (type == 0) {
        if (ip + size > n) return E_CORRUPT;
        if (op + size > cap) return E_DST_SMALL;
        memcpy(dst + op, src + ip, size);
        op += size;
        ip += size;
      } else if (type == 1) {
        if (ip + 1 > n) return E_CORRUPT;
        if (op + size > cap) return E_DST_SMALL;
        memset(dst + op, src[ip], size);
        op += size;
        ip += 1;
      } else if (type == 2) {
        if (ip + size > n || size > ZSTD_BLOCK_MAX) return E_CORRUPT;
        int64_t r = zstd_block(st, src + ip, size, dst, op, cap, lit);
        if (r < 0) return r;
        op = r;
        ip += size;
      } else {
        return E_CORRUPT;
      }
      if (last) break;
    }
    if (checksum) ip += 4;
  }
  return ip == n ? op : E_CORRUPT;
}

// The frame's declared content size, or -1 when absent, or < -1.
int64_t zstd_content_size(const uint8_t* src, int64_t n) {
  if (n < 6 || load32(src) != 0xFD2FB528u) return -2;
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  static const int did_size[4] = {0, 1, 2, 4};
  int64_t ip = 5 + (single ? 0 : 1) + did_size[fhd & 3];
  if (fcs_flag == 0 && !single) return -1;
  int fsz = fcs_flag == 0 ? 1 : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (ip + fsz > n) return -2;
  uint64_t v = 0;
  for (int i = 0; i < fsz; i++) v |= (uint64_t)src[ip + i] << (8 * i);
  if (fsz == 2) v += 256;
  return (int64_t)v;
}

int64_t zstd_max_compressed(int64_t n) {
  return 32 + n + 3 * (n / ZSTD_BLOCK_MAX + 1);
}

// One frame: single segment, the content size, no checksum.
int64_t zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t cap, int level) {
  std::vector<uint8_t> out;
  out.reserve(n + 64);
  uint8_t head[14] = {0x28, 0xB5, 0x2F, 0xFD, 0xE0};
  for (int i = 0; i < 8; i++) head[5 + i] = (uint8_t)((uint64_t)n >> (8 * i));
  out.insert(out.end(), head, head + 13);
  Encoder enc(level);
  if (n == 0) {
    uint32_t hdr = 1;  // last, raw, size 0
    out.push_back((uint8_t)hdr);
    out.push_back(0);
    out.push_back(0);
  }
  for (int64_t at = 0; at < n; at += ZSTD_BLOCK_MAX) {
    int64_t end = n - at < ZSTD_BLOCK_MAX ? n : at + ZSTD_BLOCK_MAX;
    zstd_encode_block(enc, src, at, end, end == n, out);
  }
  if ((int64_t)out.size() > cap) return E_DST_SMALL;
  memcpy(dst, out.data(), out.size());
  return (int64_t)out.size();
}

// The RLE / bit-packed hybrid (levels, dictionary indices, booleans):
// decodes `count` values of `width` bits; -> bytes consumed or < 0.
int64_t rle_hybrid_decode(const uint8_t* src, int64_t n, int width,
                          int32_t* out, int64_t count) {
  int64_t pos = 0, got = 0;
  int vbytes = (width + 7) / 8;
  while (got < count) {
    uint64_t h;
    if (uleb(src, n, &pos, &h) < 0) return E_CORRUPT;
    if (h & 1) {
      int64_t groups = (int64_t)(h >> 1);
      int64_t vals = groups * 8;
      int64_t bytes = groups * width;
      if (pos + bytes > n) bytes = n - pos;  // a short last run is padded
      int64_t take = vals < count - got ? vals : count - got;
      unpack_bits(src + pos, bytes, width, take, out + got);
      got += take;
      pos += groups * width;
      if (pos > n) pos = n;
    } else {
      int64_t run = (int64_t)(h >> 1);
      if (pos + vbytes > n) return E_CORRUPT;
      int32_t v = 0;
      for (int i = 0; i < vbytes; i++) v |= (int32_t)src[pos + i] << (8 * i);
      pos += vbytes;
      int64_t take = run < count - got ? run : count - got;
      for (int64_t i = 0; i < take; i++) out[got + i] = v;
      got += take;
      if (run == 0 && take == 0 && pos >= n) return E_CORRUPT;
    }
  }
  return pos;
}

// DELTA_BINARY_PACKED into int64; -> bytes consumed or < 0.  `count` is
// the capacity of out; *total receives the encoded value count.
int64_t delta_binary_decode(const uint8_t* src, int64_t n, int64_t* out,
                            int64_t count, int64_t* total) {
  int64_t pos = 0;
  uint64_t block, minis, tot, first;
  if (uleb(src, n, &pos, &block) < 0 || uleb(src, n, &pos, &minis) < 0 ||
      uleb(src, n, &pos, &tot) < 0 || uleb(src, n, &pos, &first) < 0)
    return E_CORRUPT;
  if (minis == 0 || block % minis || (block / minis) % 32) return E_CORRUPT;
  *total = (int64_t)tot;
  if ((int64_t)tot > count) return E_DST_SMALL;
  int64_t per = (int64_t)(block / minis);
  int64_t value = (int64_t)((first >> 1) ^ (~(first & 1) + 1));
  if (tot == 0) return pos;
  out[0] = value;
  int64_t got = 1;
  std::vector<int32_t> tmp;
  while (got < (int64_t)tot) {
    uint64_t zmin;
    if (uleb(src, n, &pos, &zmin) < 0) return E_CORRUPT;
    int64_t mindelta = (int64_t)((zmin >> 1) ^ (~(zmin & 1) + 1));
    if (pos + (int64_t)minis > n) return E_CORRUPT;
    const uint8_t* widths = src + pos;
    pos += minis;
    for (uint64_t m = 0; m < minis && got < (int64_t)tot; m++) {
      int w = widths[m];
      if (w > 64) return E_CORRUPT;
      int64_t take = per < (int64_t)tot - got ? per : (int64_t)tot - got;
      int64_t bytes = per * w / 8;
      int64_t avail = pos + bytes <= n ? bytes : n - pos;
      for (int64_t i = 0; i < take; i++) {
        uint64_t d = 0;
        if (w) {
          int64_t bit = i * w;
          int64_t byte = bit >> 3;
          int sh = bit & 7;
          // up to 64 + 7 bits: gather 9 bytes
          unsigned __int128 acc = 0;
          for (int k = 0; k < 9 && byte + k < avail; k++)
            acc |= (unsigned __int128)src[pos + byte + k] << (8 * k);
          acc >>= sh;
          d = w == 64 ? (uint64_t)acc : (uint64_t)acc & ((1ull << w) - 1);
        }
        value = (int64_t)((uint64_t)value + (uint64_t)mindelta + d);
        out[got + i] = value;
      }
      got += take;
      pos += bytes;
    }
  }
  if (pos > n) return E_CORRUPT;
  return pos;
}

// PLAIN BYTE_ARRAY values: 4-byte lengths then bytes.  Writes count + 1
// offsets (of the value bytes, into src) and lengths; -> bytes consumed.
int64_t plain_byte_array_index(const uint8_t* src, int64_t n, int64_t count,
                               int64_t* starts, int32_t* lens) {
  int64_t pos = 0;
  for (int64_t i = 0; i < count; i++) {
    if (pos + 4 > n) return E_CORRUPT;
    int32_t len = (int32_t)load32(src + pos);
    pos += 4;
    if (len < 0 || pos + len > n) return E_CORRUPT;
    starts[i] = pos;
    lens[i] = len;
    pos += len;
  }
  return pos;
}

// Avro records of flat fields (the container's block payloads): per
// field a kind (0 null, 1 boolean, 2 int or long, 3 float, 4 double,
// 5 string or bytes, 6 enum) and the branch index of null when the field
// is a ["null", T] union (-1: not a union).  Per field: `vals` int64
// values (a double's bits; a string's start offset into src), `lens` a
// string's byte length, `valid` 0 for a null.  -> bytes consumed or < 0.
int64_t avro_decode_flat(const uint8_t* src, int64_t n, int64_t rows,
                         int nfields, const int32_t* kinds,
                         const int32_t* null_branch, int64_t* const* vals,
                         int32_t* const* lens, uint8_t* const* valid) {
  int64_t pos = 0;
  for (int64_t r = 0; r < rows; r++) {
    for (int f = 0; f < nfields; f++) {
      int kind = kinds[f];
      uint8_t ok = 1;
      if (null_branch[f] >= 0) {
        uint64_t z;
        if (uleb(src, n, &pos, &z) < 0) return E_CORRUPT;
        int64_t branch = (int64_t)((z >> 1) ^ (~(z & 1) + 1));
        ok = branch != null_branch[f];
      }
      valid[f][r] = ok;
      int64_t v = 0;
      if (!ok || kind == 0) {
        vals[f][r] = 0;
        if (kind == 5) lens[f][r] = 0;
        continue;
      }
      if (kind == 1) {
        if (pos + 1 > n) return E_CORRUPT;
        v = src[pos++] != 0;
      } else if (kind == 2 || kind == 6) {
        uint64_t z;
        if (uleb(src, n, &pos, &z) < 0) return E_CORRUPT;
        v = (int64_t)((z >> 1) ^ (~(z & 1) + 1));
      } else if (kind == 3) {
        if (pos + 4 > n) return E_CORRUPT;
        float x;
        memcpy(&x, src + pos, 4);
        double d = x;
        memcpy(&v, &d, 8);
        pos += 4;
      } else if (kind == 4) {
        if (pos + 8 > n) return E_CORRUPT;
        memcpy(&v, src + pos, 8);
        pos += 8;
      } else if (kind == 5) {
        uint64_t z;
        if (uleb(src, n, &pos, &z) < 0) return E_CORRUPT;
        int64_t len = (int64_t)((z >> 1) ^ (~(z & 1) + 1));
        if (len < 0 || pos + len > n) return E_CORRUPT;
        v = pos;
        lens[f][r] = (int32_t)len;
        pos += len;
      } else {
        return E_UNSUPPORTED;
      }
      vals[f][r] = v;
    }
  }
  return pos;
}

// Big-endian two's complement values of `width` <= 8 bytes (Parquet's
// FIXED_LEN_BYTE_ARRAY decimals), sign-extended to int64.
void be_int64(const uint8_t* src, int64_t n, int width, int64_t* out) {
  int shift = 64 - 8 * width;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = src + i * width;
    uint64_t v = 0;
    for (int k = 0; k < width; k++) v = (v << 8) | p[k];
    out[i] = width ? (int64_t)(v << shift) >> shift : 0;
  }
}

// DELTA_BYTE_ARRAY values: value i is the first prefix[i] bytes of value
// i - 1 followed by its suffix (src[sstart[i], +slen[i])).  Writes the
// values back to back into out and their n + 1 offsets; -> 0 or < 0.
int64_t delta_byte_array(const uint8_t* src, int64_t n, const int64_t* prefix,
                         const int64_t* sstart, const int64_t* slen,
                         uint8_t* out, int64_t cap, int64_t* offs) {
  int64_t pos = 0;
  offs[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t p = prefix[i];
    int64_t prev_len = i ? offs[i] - offs[i - 1] : 0;
    if (p < 0 || p > prev_len || slen[i] < 0) return E_CORRUPT;
    if (pos + p + slen[i] > cap) return E_DST_SMALL;
    if (p) memmove(out + pos, out + offs[i - 1], p);
    memcpy(out + pos + p, src + sstart[i], slen[i]);
    pos += p + slen[i];
    offs[i + 1] = pos;
  }
  return 0;
}

// Big-endian two's complement byte spans (BYTE_ARRAY decimals) as
// 16-byte rows, right-aligned and sign-extended; -> 0 or < 0.
int64_t spans_to_be16(const uint8_t* src, const int64_t* starts,
                      const int32_t* lens, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    int32_t len = lens[i];
    if (len < 0 || len > 16) return E_CORRUPT;
    const uint8_t* p = src + starts[i];
    uint8_t fill = (len && (p[0] & 0x80)) ? 0xFF : 0;
    memset(out + i * 16, fill, 16 - len);
    memcpy(out + i * 16 + 16 - len, p, len);
  }
  return 0;
}

// Gathers byte spans into a fixed-width, zero-padded matrix (numpy 'S').
void gather_fixed(const uint8_t* src, const int64_t* starts,
                  const int32_t* lens, int64_t count, int64_t width,
                  uint8_t* out) {
  memset(out, 0, count * width);
  for (int64_t i = 0; i < count; i++) memcpy(out + i * width, src + starts[i], lens[i]);
}

}  // extern "C"
