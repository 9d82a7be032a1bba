// A zstd decoder (RFC 8878), XXH64 and CRC-32C: host code that reads the checkpoints
// the JAX package's orbax backend writes (tensorstore compresses every zarr chunk and
// every OCDBT node with zstd, and ends each OCDBT file with a CRC-32C).
//
// Frames: with and without a content size or the single-segment flag, any window,
// skippable frames skipped, concatenated frames decoded one after another, the XXH64
// content checksum checked where a frame carries one.  Blocks: raw, RLE, compressed.
// Literals: raw, RLE, Huffman with 1 or 4 streams and treeless (repeated) tables.
// Sequences: predefined, RLE, FSE-compressed and repeated tables, repeat offsets.
// Dictionaries are not implemented.  A corrupt, truncated or unsupported input raises
// (a non-zero return and a message); no partial output is reported as a result.
//
// C interface, bound with ctypes by utils/zstd.py:
//   hcflow_zstd_decompress(src, n, dst, cap, &size, &handle, &data, err, err_cap)
//     decodes every frame of src: into dst (at most cap bytes) when dst is not null,
//     else into a buffer it allocates (data, released by hcflow_zstd_release(handle));
//     returns 0, or 1 with a message in err.
//   hcflow_crc32c(p, n)          CRC-32C (Castagnoli, reflected 0x82F63B78) of p[0, n).
// The bit readers load 8 bytes at a time as a little-endian word (x86-64, aarch64).

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw ZstdError(buf);
}

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }  // v > 0

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

// ------------------------------------------------------------------ hashes
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  for (; p + 8 <= end; p += 8) {
    h ^= xxh_round(0, load64(p));
    h = rotl(h, 27) * P1 + P4;
  }
  if (p + 4 <= end) {
    uint32_t w;
    memcpy(&w, p, 4);
    h ^= (uint64_t)w * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable tab;
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {  // slicing by 8
    uint64_t w = load64(p) ^ c;
    c = tab.t[7][w & 0xFF] ^ tab.t[6][(w >> 8) & 0xFF] ^ tab.t[5][(w >> 16) & 0xFF] ^
        tab.t[4][(w >> 24) & 0xFF] ^ tab.t[3][(w >> 32) & 0xFF] ^ tab.t[2][(w >> 40) & 0xFF] ^
        tab.t[1][(w >> 48) & 0xFF] ^ tab.t[0][w >> 56];
  }
  for (; n; --n, ++p) c = (c >> 8) ^ tab.t[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------------ output
struct Sink {
  uint8_t* data = nullptr;
  size_t size = 0, cap = 0;
  std::vector<uint8_t>* grow = nullptr;  // null: a fixed caller buffer

  void need(size_t n) {
    if (n <= cap - size) return;
    if (!grow) fail("the output is larger than the %zu bytes expected", cap);
    size_t want = size + n;
    size_t next = cap * 2 > want ? cap * 2 : want;
    grow->resize(next);
    data = grow->data();
    cap = grow->size();
  }
};

// ------------------------------------------------------------------ bit readers
// Forward, least significant bit first (FSE table descriptions).  Bits past the end
// read as zero; the caller checks how many bytes were used.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++bit) {
      size_t byte = bit >> 3;
      if (byte < n && ((p[byte] >> (bit & 7)) & 1)) v |= 1u << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward (Huffman and FSE streams): starts below the last byte's highest set bit;
// bits below the start of the stream read as zero, and `pos` goes negative.
struct BackBits {
  const uint8_t* src = nullptr;
  int64_t len = 0;
  int64_t pos = 0;

  void init(const uint8_t* s, size_t n, const char* what) {
    if (n == 0) fail("an empty %s bitstream", what);
    if (s[n - 1] == 0) fail("the %s bitstream's last byte holds no end mark", what);
    src = s;
    len = (int64_t)n;
    pos = len * 8 - 8 + highbit(s[n - 1]);
  }
  inline uint64_t read(int nb) {  // nb <= 56
    if (nb == 0) return 0;
    pos -= nb;
    const uint64_t mask = (1ULL << nb) - 1;
    if (pos >= 0) {
      int64_t byte = pos >> 3;
      uint64_t v;
      if (byte + 8 <= len) {
        v = load64(src + byte);
      } else {
        v = 0;
        memcpy(&v, src + byte, (size_t)(len - byte));
      }
      return (v >> (pos & 7)) & mask;
    }
    int64_t top = pos + nb;  // real bits are [0, top)
    if (top <= 0) return 0;
    uint64_t v = 0;
    memcpy(&v, src, (size_t)(len < 8 ? len : 8));
    return (v & ((1ULL << top) - 1)) << (-pos);
  }
};

// ------------------------------------------------------------------ FSE
struct Fse {
  int log = -1;  // -1: no table yet
  std::vector<uint8_t> sym, nbits;
  std::vector<uint16_t> base;
};

void fse_build(Fse& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.sym[high--] = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("an FSE distribution that does not fill its table");
  for (int i = 0; i < size; ++i) {
    uint16_t d = next[t.sym[i]]++;
    int nb = log - highbit(d);
    t.nbits[i] = (uint8_t)nb;
    t.base[i] = (uint16_t)((d << nb) - size);
  }
}

// An FSE table description (RFC 8878 4.1.1) at p[0, n); returns the bytes it used.
size_t fse_read(Fse& t, const uint8_t* p, size_t n, int max_log, int max_sym, const char* what) {
  FwdBits in{p, n};
  const int log = 5 + (int)in.read(4);
  if (log > max_log) fail("a %s FSE table of accuracy %d (at most %d)", what, log, max_log);
  int16_t norm[256];
  int remaining = 1 << log, s = 0;
  while (remaining > 0 && s <= max_sym) {
    const int bits = highbit((uint64_t)remaining + 1) + 1;
    uint32_t v = in.read(bits);
    const uint32_t low = (1u << (bits - 1)) - 1;
    const uint32_t thresh = (1u << bits) - 1 - (uint32_t)(remaining + 1);
    if ((v & low) < thresh) {
      in.bit -= 1;
      v &= low;
    } else if (v > low) {
      v -= thresh;
    }
    const int prob = (int)v - 1;
    remaining -= prob < 0 ? -prob : prob;
    norm[s++] = (int16_t)prob;
    if (prob == 0) {
      for (;;) {
        const int rep = (int)in.read(2);
        for (int i = 0; i < rep; ++i) {
          if (s > max_sym) fail("a %s FSE table past symbol %d", what, max_sym);
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0) fail("a %s FSE table whose probabilities do not sum to %d", what, 1 << log);
  if (in.bytes_used() > n) fail("a truncated %s FSE table", what);
  fse_build(t, norm, s, log);
  return in.bytes_used();
}

void fse_rle(Fse& t, int symbol) {
  t.log = 0;
  t.sym.assign(1, (uint8_t)symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

struct FseState {
  const Fse* t;
  uint32_t s;
  void init(const Fse& table, BackBits& b) {
    t = &table;
    s = (uint32_t)b.read(table.log);
  }
  inline uint8_t peek() const { return t->sym[s]; }
  inline void update(BackBits& b) { s = t->base[s] + (uint32_t)b.read(t->nbits[s]); }
};

// ------------------------------------------------------------------ Huffman
struct Huf {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint8_t> sym, nbits;
};

// The tree description at p[0, n) (RFC 8878 4.2.1); returns the bytes it used.
size_t huf_read(Huf& h, const uint8_t* p, size_t n) {
  if (n < 1) fail("a truncated Huffman tree description");
  uint8_t w[256];
  int nw = 0;
  const int hb = p[0];
  size_t used;
  if (hb >= 128) {  // direct: 4 bits a weight
    nw = hb - 127;
    used = 1 + (size_t)(nw + 1) / 2;
    if (used > n) fail("a truncated Huffman weight list");
    for (int i = 0; i < nw; ++i) {
      const uint8_t b = p[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {  // FSE-compressed weights, two interleaved states
    used = 1 + (size_t)hb;
    if (used > n) fail("a truncated Huffman weight stream");
    Fse t;
    const size_t hdr = fse_read(t, p + 1, hb, 6, 255, "Huffman weight");
    if (hdr >= (size_t)hb) fail("a Huffman weight stream with no bits");
    BackBits b;
    b.init(p + 1 + hdr, hb - hdr, "Huffman weight");
    FseState s1, s2;
    s1.init(t, b);
    s2.init(t, b);
    auto push = [&](uint8_t v) {
      if (nw == 255) fail("more than 255 Huffman weights");
      w[nw++] = v;
    };
    for (;;) {  // ends when a state update reads past the start of the stream
      push(s1.peek());
      s1.update(b);
      if (b.pos < 0) {
        push(s2.peek());
        break;
      }
      push(s2.peek());
      s2.update(b);
      if (b.pos < 0) {
        push(s1.peek());
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 12) fail("a Huffman weight of %d", w[i]);
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("a Huffman table with no symbol");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 12) fail("a Huffman table of %d bits", max_bits);
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("a Huffman table whose weights do not complete a tree");
  w[nw++] = (uint8_t)(highbit(left) + 1);
  // Codes of max_bits bits first, then shorter codes, each symbol in natural order.
  int count[13] = {0};
  uint8_t bits[256];
  for (int i = 0; i < nw; ++i) {
    bits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
    count[bits[i]]++;
  }
  int start[14];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) start[b - 1] = start[b] + count[b] * (1 << (max_bits - b));
  h.max_bits = max_bits;
  h.sym.assign(1u << max_bits, 0);
  h.nbits.assign(1u << max_bits, 0);
  for (int i = 0; i < nw; ++i) {
    if (!bits[i]) continue;
    const int len = 1 << (max_bits - bits[i]);
    memset(&h.sym[start[bits[i]]], i, len);
    memset(&h.nbits[start[bits[i]]], bits[i], len);
    start[bits[i]] += len;
  }
  return used;
}

// One Huffman stream read backward: each symbol looks at the next max_bits bits (bits
// below the start of the stream read as zero) and consumes its code's length; the
// stream must end exactly at its first bit.
struct HufStream {
  const uint8_t* src;
  int64_t len, pos;
  uint8_t* out;
  size_t count;

  void init(const uint8_t* s, size_t n, uint8_t* o, size_t c) {
    BackBits b;
    b.init(s, n, "Huffman literal");
    src = s;
    len = (int64_t)n;
    pos = b.pos;
    out = o;
    count = c;
  }
  inline uint32_t peek(int max_bits) const {
    const int64_t lo = pos - max_bits;
    if (lo >= 0 && (lo >> 3) + 8 <= len) return (uint32_t)(load64(src + (lo >> 3)) >> (lo & 7));
    BackBits b{src, len, pos};
    return (uint32_t)b.read(max_bits);
  }
};

void huf_streams(const Huf& h, HufStream* st, int n) {
  const int mb = h.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  const uint8_t* sym = h.sym.data();
  const uint8_t* nb = h.nbits.data();
  size_t common = st[0].count;
  for (int k = 1; k < n; ++k) common = st[k].count < common ? st[k].count : common;
  size_t i = 0;
  if (n == 4) {  // the four streams interleaved
    // Four symbols a stream from one 8-byte load while every stream has 4 codes of
    // bits above its start (4 * 12 + 7 bits fit in the load).
    const int64_t span = 4 * mb;
    for (; i + 4 <= common; i += 4) {
      bool far = true;
      for (int k = 0; k < 4; ++k)
        far &= st[k].pos >= span && ((st[k].pos - span) >> 3) + 8 <= st[k].len;
      if (!far) break;
      for (int k = 0; k < 4; ++k) {
        HufStream& s = st[k];
        const int64_t base = (s.pos - span) & ~int64_t(7);
        const uint64_t w = load64(s.src + (base >> 3));
        int64_t pos = s.pos;
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = (uint32_t)(w >> (pos - mb - base)) & mask;
          s.out[i + j] = sym[v];
          pos -= nb[v];
        }
        s.pos = pos;
      }
    }
    for (; i < common; ++i) {
      for (int k = 0; k < 4; ++k) {
        const uint32_t v = st[k].peek(mb) & mask;
        st[k].out[i] = sym[v];
        st[k].pos -= nb[v];
      }
    }
  }
  for (int k = 0; k < n; ++k) {
    HufStream& s = st[k];
    for (size_t j = i; j < s.count; ++j) {
      const uint32_t v = s.peek(mb) & mask;
      s.out[j] = sym[v];
      s.pos -= nb[v];
    }
    if (s.pos != 0) fail("a Huffman literal stream not consumed exactly");
  }
}

// ------------------------------------------------------------------ tables
const int16_t LL_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_NORM[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_NORM[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Predefined {
  Fse ll, ml, of;
  Predefined() {
    fse_build(ll, LL_NORM, 36, 6);
    fse_build(ml, ML_NORM, 53, 6);
    fse_build(of, OF_NORM, 29, 5);
  }
};

// ------------------------------------------------------------------ blocks
constexpr size_t BLOCK_MAX = 128 * 1024;

struct FrameState {
  Huf huf;
  Fse ll, ml, of;
  uint32_t rep[3] = {1, 4, 8};
  size_t frame_start = 0;  // the frame's first output byte in the sink
  size_t block_max = BLOCK_MAX;
  std::vector<uint8_t> lit;
};

// The literals section at p[0, n); sets *lit / *nlit, returns the bytes it used.
size_t read_literals(FrameState& f, const uint8_t* p, size_t n, const uint8_t** lit, size_t* nlit) {
  if (n < 1) fail("a block with no literals section");
  const int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    size_t hdr, size;
    if (fmt == 0 || fmt == 2) {
      hdr = 1;
      size = p[0] >> 3;
    } else if (fmt == 1) {
      if (n < 2) fail("a truncated literals header");
      hdr = 2;
      size = (p[0] >> 4) + ((size_t)p[1] << 4);
    } else {
      if (n < 3) fail("a truncated literals header");
      hdr = 3;
      size = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
    }
    if (size > f.block_max) fail("%zu literals in a block (at most %zu)", size, f.block_max);
    if (type == 0) {
      if (hdr + size > n) fail("truncated raw literals");
      *lit = p + hdr;
      *nlit = size;
      return hdr + size;
    }
    if (hdr + 1 > n) fail("truncated RLE literals");
    f.lit.resize(size);
    memset(f.lit.data(), p[hdr], size);
    *lit = f.lit.data();
    *nlit = size;
    return hdr + 1;
  }
  // Huffman-compressed (type 2) or treeless (type 3)
  size_t hdr, regen, csize;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt < 2) {
    if (n < 3) fail("a truncated literals header");
    const uint32_t c = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16);
    hdr = 3;
    regen = (c >> 4) & 0x3FF;
    csize = (c >> 14) & 0x3FF;
  } else if (fmt == 2) {
    if (n < 4) fail("a truncated literals header");
    const uint32_t c = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    hdr = 4;
    regen = (c >> 4) & 0x3FFF;
    csize = c >> 18;
  } else {
    if (n < 5) fail("a truncated literals header");
    const uint64_t c = p[0] | (p[1] << 8) | ((uint64_t)p[2] << 16) | ((uint64_t)p[3] << 24) |
                       ((uint64_t)p[4] << 32);
    hdr = 5;
    regen = (c >> 4) & 0x3FFFF;
    csize = (c >> 22) & 0x3FFFF;
  }
  if (regen > f.block_max) fail("%zu literals in a block (at most %zu)", regen, f.block_max);
  if (hdr + csize > n) fail("truncated compressed literals");
  const uint8_t* q = p + hdr;
  size_t qn = csize;
  if (type == 2) {
    const size_t used = huf_read(f.huf, q, qn);
    q += used;
    qn -= used;
  } else if (f.huf.max_bits == 0) {
    fail("treeless literals with no earlier Huffman table in the frame");
  }
  f.lit.resize(regen);
  uint8_t* out = f.lit.data();
  if (streams == 1) {
    HufStream st;
    st.init(q, qn, out, regen);
    huf_streams(f.huf, &st, 1);
  } else {
    if (qn < 6) fail("a truncated literals jump table");
    const size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8), s3 = q[4] | (q[5] << 8);
    if (6 + s1 + s2 + s3 > qn) fail("a literals jump table past its section");
    const size_t s4 = qn - 6 - s1 - s2 - s3;
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("%zu literals in 4 streams", regen);
    const uint8_t* d = q + 6;
    HufStream st[4];
    st[0].init(d, s1, out, seg);
    st[1].init(d + s1, s2, out + seg, seg);
    st[2].init(d + s1 + s2, s3, out + 2 * seg, seg);
    st[3].init(d + s1 + s2 + s3, s4, out + 3 * seg, regen - 3 * seg);
    huf_streams(f.huf, st, 4);
  }
  *lit = f.lit.data();
  *nlit = regen;
  return hdr + csize;
}

size_t read_table(Fse& t, int mode, const Fse& predefined, const uint8_t* p, size_t n,
                  int max_log, int max_sym, const char* what) {
  switch (mode) {
    case 0:
      t = predefined;
      return 0;
    case 1:
      if (n < 1) fail("a truncated %s RLE symbol", what);
      if (p[0] > max_sym) fail("a %s RLE symbol %d (at most %d)", what, p[0], max_sym);
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, max_log, max_sym, what);
    default:
      if (t.log < 0) fail("a repeated %s table with no earlier table in the frame", what);
      return 0;
  }
}

void copy_match(uint8_t* dst, size_t offset, size_t len) {
  const uint8_t* src = dst - offset;
  if (offset >= len) {
    memcpy(dst, src, len);
  } else if (offset >= 8) {
    size_t i = 0;
    for (; i + 8 <= len; i += 8) memcpy(dst + i, src + i, 8);  // 8 < offset: no overlap
    for (; i < len; ++i) dst[i] = src[i];
  } else {
    for (size_t i = 0; i < len; ++i) dst[i] = src[i];
  }
}

void compressed_block(FrameState& f, const Predefined& pre, const uint8_t* p, size_t n, Sink& out) {
  const uint8_t* lit;
  size_t nlit;
  size_t at = read_literals(f, p, n, &lit, &nlit);
  if (at >= n) fail("a block with no sequences section");
  size_t nseq = p[at++];
  if (nseq >= 128) {
    if (nseq < 255) {
      if (at + 1 > n) fail("a truncated sequence count");
      nseq = ((nseq - 128) << 8) + p[at++];
    } else {
      if (at + 2 > n) fail("a truncated sequence count");
      nseq = p[at] + ((size_t)p[at + 1] << 8) + 0x7F00;
      at += 2;
    }
  }
  const size_t block_start = out.size;
  if (nseq == 0) {
    if (at != n) fail("%zu bytes after a block with no sequences", n - at);
    out.need(nlit);
    memcpy(out.data + out.size, lit, nlit);
    out.size += nlit;
    return;
  }
  if (at >= n) fail("a truncated sequences section");
  const uint8_t modes = p[at++];
  if (modes & 3) fail("reserved bits set in the sequence modes");
  at += read_table(f.ll, modes >> 6, pre.ll, p + at, n - at, 9, 35, "literal length");
  at += read_table(f.of, (modes >> 4) & 3, pre.of, p + at, n - at, 8, 31, "offset");
  at += read_table(f.ml, (modes >> 2) & 3, pre.ml, p + at, n - at, 9, 52, "match length");
  if (at >= n) fail("a sequences section with no bitstream");
  BackBits b;
  b.init(p + at, n - at, "sequence");
  FseState ll, of, ml;
  ll.init(f.ll, b);
  of.init(f.of, b);
  ml.init(f.ml, b);
  size_t lit_at = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const int of_code = of.peek(), ll_code = ll.peek(), ml_code = ml.peek();
    if (of_code > 31) fail("an offset code of %d", of_code);
    const uint64_t of_value = (1ULL << of_code) + b.read(of_code);
    const size_t mlen = ML_BASE[ml_code] + b.read(ML_BITS[ml_code]);
    const size_t llen = LL_BASE[ll_code] + b.read(LL_BITS[ll_code]);
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = (uint32_t)offset;
    } else {
      const uint32_t idx = (uint32_t)of_value - 1 + (llen == 0 ? 1 : 0);
      if (idx == 0) {
        offset = f.rep[0];
      } else {
        offset = idx < 3 ? f.rep[idx] : (uint64_t)f.rep[0] - 1;
        if (idx > 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = (uint32_t)offset;
      }
    }
    if (i + 1 < nseq) {
      ll.update(b);
      ml.update(b);
      of.update(b);
    }
    if (llen > nlit - lit_at) fail("a sequence past the block's literals");
    if (out.size - block_start + llen + mlen > f.block_max)
      fail("a block that decodes to more than %zu bytes", f.block_max);
    out.need(llen + mlen);
    uint8_t* dst = out.data + out.size;
    memcpy(dst, lit + lit_at, llen);
    lit_at += llen;
    dst += llen;
    out.size += llen;
    if (offset == 0 || offset > out.size - f.frame_start)
      fail("a match offset %llu before the start of the frame", (unsigned long long)offset);
    copy_match(dst, (size_t)offset, mlen);
    out.size += mlen;
  }
  if (b.pos != 0) fail("a sequence bitstream not consumed exactly");
  const size_t rest = nlit - lit_at;
  if (out.size - block_start + rest > f.block_max)
    fail("a block that decodes to more than %zu bytes", f.block_max);
  out.need(rest);
  memcpy(out.data + out.size, lit + lit_at, rest);
  out.size += rest;
}

// ------------------------------------------------------------------ frames
inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// One frame (or a skippable frame) at p[0, n); returns the bytes it used.
size_t frame(const Predefined& pre, const uint8_t* p, size_t n, Sink& out) {
  if (n < 4) fail("%zu trailing bytes that are not a frame", n);
  const uint32_t magic = le32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail("a truncated skippable frame");
    const uint64_t size = le32(p + 4);
    if (size > n - 8) fail("a truncated skippable frame");
    return 8 + size;
  }
  if (magic != 0xFD2FB528u) fail("a frame with magic 0x%08x, not zstd's", magic);
  size_t at = 4;
  if (at >= n) fail("a truncated frame header");
  const uint8_t fhd = p[at++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            did_flag = fhd & 3;
  if (fhd & 8) fail("the reserved bit set in a frame header");
  uint64_t window = 0;
  if (!single) {
    if (at >= n) fail("a truncated frame header");
    const uint8_t wd = p[at++];
    const int wlog = 10 + (wd >> 3);
    const uint64_t wbase = 1ULL << wlog;
    window = wbase + (wbase / 8) * (wd & 7);
  }
  const int did_size = did_flag == 0 ? 0 : did_flag == 1 ? 1 : did_flag == 2 ? 2 : 4;
  if (at + did_size > n) fail("a truncated frame header");
  uint32_t did = 0;
  for (int i = 0; i < did_size; ++i) did |= (uint32_t)p[at + i] << (8 * i);
  at += did_size;
  if (did != 0) fail("a frame that needs dictionary %u (dictionaries are not implemented)", did);
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (at + fcs_size > n) fail("a truncated frame header");
  uint64_t fcs = 0;
  bool has_fcs = fcs_size > 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= (uint64_t)p[at + i] << (8 * i);
  if (fcs_size == 2) fcs += 256;
  at += fcs_size;
  if (single) window = fcs;

  FrameState f;
  f.frame_start = out.size;
  f.block_max = window < BLOCK_MAX ? (size_t)window : BLOCK_MAX;
  if (has_fcs && out.grow) out.need(fcs < (uint64_t)n * 64 + (1u << 20) ? (size_t)fcs : 0);
  for (;;) {
    if (at + 3 > n) fail("a truncated block header");
    const uint32_t bh = p[at] | (p[at + 1] << 8) | ((uint32_t)p[at + 2] << 16);
    at += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("a block of the reserved type");
    if (type == 1) {  // RLE: one byte, repeated
      if (size > f.block_max) fail("a block of %zu bytes (at most %zu)", size, f.block_max);
      if (at + 1 > n) fail("a truncated RLE block");
      out.need(size);
      memset(out.data + out.size, p[at], size);
      out.size += size;
      at += 1;
    } else {
      if (size > f.block_max) fail("a block of %zu bytes (at most %zu)", size, f.block_max);
      if (at + size > n) fail("a truncated block");
      if (type == 0) {
        out.need(size);
        memcpy(out.data + out.size, p + at, size);
        out.size += size;
      } else {
        compressed_block(f, pre, p + at, size, out);
      }
      at += size;
    }
    if (last) break;
  }
  const size_t produced = out.size - f.frame_start;
  if (has_fcs && produced != fcs)
    fail("a frame of %zu bytes whose header says %llu", produced, (unsigned long long)fcs);
  if (checksum) {
    if (at + 4 > n) fail("a truncated content checksum");
    const uint32_t want = le32(p + at);
    const uint32_t got = (uint32_t)xxh64(out.data + f.frame_start, produced, 0);
    if (want != got) fail("a content checksum 0x%08x where the data gives 0x%08x", want, got);
    at += 4;
  }
  return at;
}

void decompress(const uint8_t* p, size_t n, Sink& out) {
  static const Predefined pre;
  if (n == 0) fail("no frame in an empty input");
  size_t at = 0;
  while (at < n) at += frame(pre, p + at, n - at, out);
}

void set_error(char* err, size_t cap, const char* msg) {
  if (err && cap) {
    strncpy(err, msg, cap - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

int hcflow_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                           size_t* out_size, void** out_handle, uint8_t** out_data, char* err,
                           size_t err_cap) {
  std::vector<uint8_t>* buf = nullptr;
  try {
    Sink out;
    if (dst) {
      out.data = dst;
      out.cap = cap;
    } else {
      buf = new std::vector<uint8_t>(n < (1u << 28) ? 4 * n + 1024 : n);
      out.grow = buf;
      out.data = buf->data();
      out.cap = buf->size();
    }
    decompress(src, n, out);
    *out_size = out.size;
    if (buf) {
      buf->resize(out.size);
      *out_handle = buf;
      *out_data = buf->data();
    }
    return 0;
  } catch (const std::exception& e) {
    delete buf;
    set_error(err, err_cap, e.what());
    return 1;
  }
}

void hcflow_zstd_release(void* handle) { delete static_cast<std::vector<uint8_t>*>(handle); }

uint32_t hcflow_crc32c(const uint8_t* p, size_t n) { return crc32c(p, n); }

}  // extern "C"
