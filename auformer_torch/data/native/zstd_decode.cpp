// Zstandard decoder (RFC 8878), plus the CRC32C and XXH64 checksums that
// checkpoint files carry.
//
// The JAX package's checkpoints are OCDBT databases whose nodes, and the
// zarr chunks they hold, are zstd frames (core/ocdbt.py, core/
// orbax_reader.py). This is the port's own decoder: no libzstd, no Python
// package. It decodes raw, RLE and compressed blocks; raw, RLE, compressed
// and treeless literals with one or four Huffman streams; sequences in
// predefined, RLE, FSE-compressed and repeat modes with repeat offsets;
// frames with and without Frame_Content_Size, several frames in a row,
// skippable frames, and the XXH64 Content_Checksum, verified when present.
// Dictionaries are refused. Every read of the input is bounds-checked: a
// malformed frame ends in an error message, never a read past the buffer.
//
// C interface (ctypes, native/__init__.py):
//   int      zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
//                            size_t* out_len, char* err, size_t err_cap);
//   int      zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst,
//                                 size_t cap, size_t* out_len, char* err,
//                                 size_t err_cap);
//   void     zstd_free(uint8_t* p);
//   uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc);
//
// The decoders return 0, or -1 with a message in err. zstd_decompress
// allocates *out (free it with zstd_free); zstd_decompress_into writes at
// most cap bytes into dst and fails past that.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "zstd_decode.cpp reads little-endian words and needs a little-endian host"
#endif

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

uint64_t load_le(const uint8_t* p, size_t n) {  // n <= 8 bytes
  uint64_t v = 0;
  std::memcpy(&v, p, n);
  return v;
}

// ---- checksums ------------------------------------------------------------

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable& crc_table() {
  static const Crc32cTable table;
  return table;
}

uint32_t crc32c_update(uint32_t crc, const uint8_t* p, size_t n) {
  const Crc32cTable& T = crc_table();
  crc = ~crc;
  while (n >= 8) {  // slice-by-8
    uint64_t w = load_le(p, 8) ^ crc;
    crc = T.t[7][w & 0xFF] ^ T.t[6][(w >> 8) & 0xFF] ^
          T.t[5][(w >> 16) & 0xFF] ^ T.t[4][(w >> 24) & 0xFF] ^
          T.t[3][(w >> 32) & 0xFF] ^ T.t[2][(w >> 40) & 0xFF] ^
          T.t[1][(w >> 48) & 0xFF] ^ T.t[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ T.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xxround(0, v)) * P1 + P4;
}

uint64_t xxh64_hash(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxround(v1, load_le(p, 8));
      v2 = xxround(v2, load_le(p + 8, 8));
      v3 = xxround(v3, load_le(p + 16, 8));
      v4 = xxround(v4, load_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(xxmerge(xxmerge(xxmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxround(0, load_le(p, 8)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- input span and bit readers -------------------------------------------

// [p, p + n) of the input, every read checked against n
struct Span {
  const uint8_t* p;
  size_t n;
  void need(size_t k, const char* what) const {
    if (k > n) fail(std::string("truncated input: ") + what);
  }
  uint8_t byte(size_t i, const char* what) const {
    need(i + 1, what);
    return p[i];
  }
  uint64_t le(size_t off, size_t k, const char* what) const {
    need(off + k, what);
    return load_le(p + off, k);
  }
  Span sub(size_t off, size_t k, const char* what) const {
    need(off + k, what);
    return Span{p + off, k};
  }
  Span from(size_t off, const char* what) const {
    need(off, what);
    return Span{p + off, n - off};
  }
};

// FSE table descriptions: bits read forward from the first byte, least
// significant first. Bits past the end read as 0; the caller checks that the
// bits it consumed lie inside the span.
struct ForwardBits {
  Span s;
  uint64_t pos = 0;
  uint32_t peek(int k) const {
    size_t b = pos >> 3;
    uint64_t v = 0;
    if (b < s.n) std::memcpy(&v, s.p + b, s.n - b < 8 ? s.n - b : 8);
    return static_cast<uint32_t>((v >> (pos & 7)) & ((1ULL << k) - 1));
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// Huffman and FSE streams: read backward from the end mark (the highest set
// bit of the last byte), the first bit read as the most significant. Bits
// before the start of the stream read as 0 and drive `left` below 0.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t left;  // bits not yet read
  BackBits(Span s, const char* what) : p(s.p), n(s.n) {
    if (n == 0) fail(std::string("empty bitstream: ") + what);
    uint8_t last = p[n - 1];
    if (last == 0) fail(std::string("bitstream without its end mark: ") + what);
    left = 8 * static_cast<int64_t>(n - 1) + highbit(last);
  }
  uint64_t peek(int k) const {  // k <= 56
    if (k == 0) return 0;
    int64_t lo = left - k;
    if (lo >= 0) {
      size_t b = static_cast<size_t>(lo >> 3);
      uint64_t v = b + 8 <= n ? load_le(p + b, 8) : load_le(p + b, n - b);
      return (v >> (lo & 7)) & ((1ULL << k) - 1);
    }
    if (left <= 0) return 0;
    uint64_t v = load_le(p, n < 8 ? n : 8) & ((1ULL << left) - 1);
    return v << (-lo);
  }
  void skip(int k) { left -= k; }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    left -= k;
    return v;
  }
};

// ---- output ----------------------------------------------------------------

struct Out {
  uint8_t* buf = nullptr;
  size_t len = 0, cap = 0;
  bool fixed = false;  // the caller's buffer: never grows
  ~Out() {
    if (!fixed) std::free(buf);
  }
  void reserve(size_t want) {
    if (want <= cap) return;
    if (fixed)
      fail("decompressed data exceeds the " + std::to_string(cap) +
           "-byte output buffer");
    size_t c = cap ? cap : 4096;
    while (c < want) c = c > (SIZE_MAX >> 1) ? want : c * 2;
    uint8_t* nb = static_cast<uint8_t*>(std::realloc(buf, c));
    if (!nb) fail("out of memory for the decompressed data");
    buf = nb;
    cap = c;
  }
  void append(const uint8_t* src, size_t k) {
    reserve(len + k);
    if (k) std::memcpy(buf + len, src, k);
    len += k;
  }
  void fill(uint8_t v, size_t k) {
    reserve(len + k);
    std::memset(buf + len, v, k);
    len += k;
  }
  // k bytes from `offset` bytes back (the regions may overlap)
  void match(size_t offset, size_t k) {
    reserve(len + k);
    uint8_t* d = buf + len;
    const uint8_t* s = d - offset;
    if (offset >= k) {
      std::memcpy(d, s, k);
    } else {
      for (size_t i = 0; i < k; ++i) d[i] = s[i];
    }
    len += k;
  }
};

// ---- FSE --------------------------------------------------------------------

struct FseEntry {
  uint16_t base;
  uint8_t sym;
  uint8_t nbits;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
};

void fse_build(FseTable& t, const int16_t* norm, int max_sym, int log) {
  size_t size = size_t(1) << log;
  t.log = log;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(max_sym + 1);
  size_t high = size - 1;
  for (int s = 0; s <= max_sym; ++s) {
    if (norm[s] == -1) {
      t.e[high--].sym = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s <= max_sym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].sym = static_cast<uint8_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("corrupt FSE table: symbols do not spread evenly");
  for (size_t u = 0; u < size; ++u) {
    uint32_t ns = next[t.e[u].sym]++;
    int nb = log - highbit(ns);
    t.e[u].nbits = static_cast<uint8_t>(nb);
    t.e[u].base = static_cast<uint16_t>((ns << nb) - size);
  }
}

// reads an FSE table description; returns the bytes it took
size_t fse_read(FseTable& t, Span s, int max_sym_allowed, int max_log) {
  ForwardBits fb{s};
  if (s.n == 0) fail("truncated input: FSE table description");
  int log = static_cast<int>(fb.read(4)) + 5;
  if (log > max_log)
    fail("FSE table accuracy " + std::to_string(log) + " exceeds " +
         std::to_string(max_log));
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym_allowed) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = fb.read(2);
        n0 += static_cast<int>(r);
        if (r != 3) break;
        if (fb.pos > 8 * s.n) fail("truncated input: FSE table description");
      }
      if (n0 > max_sym_allowed) fail("corrupt FSE table: too many symbols");
      while (sym < n0) norm[sym++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    if (static_cast<int>(fb.peek(nbits - 1)) < max) {
      count = static_cast<int>(fb.read(nbits - 1));
    } else {
      count = static_cast<int>(fb.read(nbits));
      if (count >= threshold) count -= max;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = static_cast<int16_t>(count);
    prev0 = count == 0;
    if (remaining < 1) fail("corrupt FSE table: probabilities overflow");
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("corrupt FSE table: probabilities do not sum up");
  if (fb.bytes_used() > s.n) fail("truncated input: FSE table description");
  fse_build(t, norm, sym - 1, log);
  return fb.bytes_used();
}

void fse_rle(FseTable& t, uint8_t sym) {
  t.log = 0;
  t.e.assign(1, FseEntry{0, sym, 0});
}

// ---- Huffman literals -------------------------------------------------------

struct HufTable {
  int max_bits = 0;
  std::vector<uint16_t> e;  // symbol << 8 | bits
};

constexpr int kHufMaxBits = 11;

// reads a Huffman tree description; returns the bytes it took
size_t huf_read(HufTable& t, Span s) {
  uint8_t w[256] = {0};
  int nw;
  size_t used;
  uint8_t hb = s.byte(0, "Huffman tree description");
  if (hb >= 128) {
    nw = hb - 127;
    size_t nbytes = (nw + 1) / 2;
    Span d = s.sub(1, nbytes, "Huffman weights");
    for (int i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (d.p[i / 2] & 15) : (d.p[i / 2] >> 4);
    used = 1 + nbytes;
  } else {
    Span d = s.sub(1, hb, "Huffman weights");
    FseTable ft;
    size_t hdr = fse_read(ft, d, 255, 6);
    BackBits bits(d.from(hdr, "Huffman weights"), "Huffman weights");
    uint32_t s1 = bits.read(ft.log), s2 = bits.read(ft.log);
    nw = 0;
    // two interleaved states; when an update reads past the start of the
    // stream, the other state's symbol is the last
    for (;;) {
      if (nw > 253) fail("corrupt Huffman weights: too many");
      const FseEntry& a = ft.e[s1];
      w[nw++] = a.sym;
      s1 = a.base + bits.read(a.nbits);
      if (bits.left < 0) {
        w[nw++] = ft.e[s2].sym;
        break;
      }
      const FseEntry& b = ft.e[s2];
      w[nw++] = b.sym;
      s2 = b.base + bits.read(b.nbits);
      if (bits.left < 0) {
        w[nw++] = ft.e[s1].sym;
        break;
      }
    }
    used = 1 + hb;
  }
  if (nw > 255) fail("corrupt Huffman weights: too many");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > kHufMaxBits) fail("corrupt Huffman weights: weight too large");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("corrupt Huffman weights: all zero");
  int max_bits = highbit(total) + 1;
  if (max_bits > kHufMaxBits) fail("corrupt Huffman weights: codes too long");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("corrupt Huffman weights: no last weight fits");
  w[nw] = static_cast<uint8_t>(highbit(rest) + 1);
  int nsym = nw + 1;
  t.max_bits = max_bits;
  t.e.assign(size_t(1) << max_bits, 0);
  size_t pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt) {
    for (int sym = 0; sym < nsym; ++sym) {
      if (w[sym] != wt) continue;
      size_t len = size_t(1) << (wt - 1);
      uint16_t v = static_cast<uint16_t>(sym << 8 | (max_bits + 1 - wt));
      for (size_t i = 0; i < len; ++i) t.e[pos + i] = v;
      pos += len;
    }
  }
  if (pos != t.e.size()) fail("corrupt Huffman weights: codes do not fill");
  return used;
}

void huf_stream(const HufTable& t, Span s, uint8_t* out, size_t count) {
  BackBits bits(s, "Huffman stream");
  const int mb = t.max_bits;
  size_t i = 0;
  // four symbols (<= 44 bits) from each load of the 56+ bits below `left`
  while (count - i >= 4 && bits.left >= 56) {
    size_t b = static_cast<size_t>(bits.left >> 3) - 7;
    uint64_t v = load_le(bits.p + b, 8) << (8 - (bits.left & 7));
    for (int k = 0; k < 4; ++k) {
      uint16_t x = t.e[v >> (64 - mb)];
      out[i++] = static_cast<uint8_t>(x >> 8);
      v <<= (x & 0xFF);
      bits.left -= x & 0xFF;
    }
  }
  for (; i < count; ++i) {
    uint16_t v = t.e[bits.peek(t.max_bits)];
    out[i] = static_cast<uint8_t>(v >> 8);
    bits.skip(v & 0xFF);
  }
  if (bits.left != 0) fail("corrupt Huffman stream: not consumed exactly");
}

// ---- sequences --------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                              10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                              24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct SeqKind {
  const char* name;
  int max_sym, max_log;
  int default_max_sym, default_log;  // the predefined distribution
  const int16_t* default_norm;
};
const SeqKind kLL{"literal lengths", 35, 9, 35, 6, kLLDefault};
const SeqKind kOF{"offsets", 31, 8, 28, 5, kOFDefault};
const SeqKind kML{"match lengths", 52, 9, 52, 6, kMLDefault};

// per frame: the tables and offsets that a later block may repeat
struct FrameState {
  HufTable huf;
  bool has_huf = false;
  FseTable ll, of, ml;
  bool has_ll = false, has_of = false, has_ml = false;
  size_t rep[3] = {1, 4, 8};
};

size_t seq_table(FseTable& t, bool& has, int mode, const SeqKind& k, Span s) {
  switch (mode) {
    case 0:
      fse_build(t, k.default_norm, k.default_max_sym, k.default_log);
      has = true;
      return 0;
    case 1: {
      uint8_t sym = s.byte(0, "RLE sequence symbol");
      if (sym > k.max_sym) fail(std::string("corrupt RLE symbol for ") + k.name);
      fse_rle(t, sym);
      has = true;
      return 1;
    }
    case 2: {
      size_t used = fse_read(t, s, k.max_sym, k.max_log);
      has = true;
      return used;
    }
    default:
      if (!has) fail(std::string("repeat mode without an earlier table for ") + k.name);
      return 0;
  }
}

constexpr size_t kBlockMax = 128 * 1024;

void compressed_block(Span blk, Out& out, size_t frame_start, FrameState& fs) {
  // -- literals section
  uint8_t b0 = blk.byte(0, "literals section header");
  int ltype = b0 & 3, sfmt = (b0 >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  int streams = 1;
  if (ltype < 2) {
    if ((sfmt & 1) == 0) {
      hdr = 1;
      regen = b0 >> 3;
    } else if (sfmt == 1) {
      hdr = 2;
      regen = (b0 >> 4) + (size_t(blk.byte(1, "literals header")) << 4);
    } else {
      hdr = 3;
      regen = (b0 >> 4) + (size_t(blk.byte(1, "literals header")) << 4) +
              (size_t(blk.byte(2, "literals header")) << 12);
    }
  } else {
    hdr = sfmt < 2 ? 3 : sfmt == 2 ? 4 : 5;
    uint64_t h = blk.le(0, hdr, "literals header");
    int nb = sfmt < 2 ? 10 : sfmt == 2 ? 14 : 18;
    regen = (h >> 4) & ((1u << nb) - 1);
    csize = (h >> (4 + nb)) & ((1u << nb) - 1);
    streams = sfmt == 0 ? 1 : 4;
  }
  if (regen > kBlockMax) fail("corrupt literals: more than 128 KiB");
  std::vector<uint8_t> lit(regen);
  size_t pos = hdr;
  if (ltype == 0) {
    Span d = blk.sub(pos, regen, "raw literals");
    if (regen) std::memcpy(lit.data(), d.p, regen);
    pos += regen;
  } else if (ltype == 1) {
    std::memset(lit.data(), blk.byte(pos, "RLE literal"), regen);
    pos += 1;
  } else {
    Span c = blk.sub(pos, csize, "compressed literals");
    pos += csize;
    size_t tree = 0;
    if (ltype == 2) {
      tree = huf_read(fs.huf, c);
      fs.has_huf = true;
    } else if (!fs.has_huf) {
      fail("treeless literals without an earlier Huffman table");
    }
    Span st = c.from(tree, "Huffman streams");
    if (streams == 1) {
      huf_stream(fs.huf, st, lit.data(), regen);
    } else {
      size_t s1 = st.le(0, 2, "jump table"), s2 = st.le(2, 2, "jump table"),
             s3 = st.le(4, 2, "jump table");
      if (6 + s1 + s2 + s3 > st.n) fail("corrupt literals: jump table past the end");
      size_t s4 = st.n - 6 - s1 - s2 - s3;
      size_t per = (regen + 3) / 4;
      if (3 * per > regen) fail("corrupt literals: too few for four streams");
      size_t off = 6;
      size_t sizes[4] = {s1, s2, s3, s4};
      for (int i = 0; i < 4; ++i) {
        size_t cnt = i < 3 ? per : regen - 3 * per;
        huf_stream(fs.huf, st.sub(off, sizes[i], "Huffman stream"),
                   lit.data() + i * per, cnt);
        off += sizes[i];
      }
    }
  }

  // -- sequences section
  size_t start_len = out.len;
  uint8_t n0 = blk.byte(pos, "sequences header");
  size_t nseq;
  if (n0 < 128) {
    nseq = n0;
    pos += 1;
  } else if (n0 < 255) {
    nseq = (size_t(n0 - 128) << 8) + blk.byte(pos + 1, "sequences header");
    pos += 2;
  } else {
    nseq = blk.le(pos + 1, 2, "sequences header") + 0x7F00;
    pos += 3;
  }
  if (nseq == 0) {
    if (pos != blk.n) fail("corrupt block: bytes after an empty sequences section");
    out.append(lit.data(), regen);
    return;
  }
  uint8_t modes = blk.byte(pos++, "sequence modes");
  if (modes & 3) fail("corrupt sequence modes: reserved bits set");
  pos += seq_table(fs.ll, fs.has_ll, modes >> 6, kLL, blk.from(pos, "sequence tables"));
  pos += seq_table(fs.of, fs.has_of, (modes >> 4) & 3, kOF, blk.from(pos, "sequence tables"));
  pos += seq_table(fs.ml, fs.has_ml, (modes >> 2) & 3, kML, blk.from(pos, "sequence tables"));
  BackBits bits(blk.from(pos, "sequences bitstream"), "sequences bitstream");
  uint32_t sll = bits.read(fs.ll.log), sof = bits.read(fs.of.log),
           sml = bits.read(fs.ml.log);
  size_t lit_pos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& ell = fs.ll.e[sll];
    const FseEntry& eof = fs.of.e[sof];
    const FseEntry& eml = fs.ml.e[sml];
    if (ell.sym > 35 || eml.sym > 52 || eof.sym > 31) fail("corrupt sequence code");
    size_t ofv = (size_t(1) << eof.sym) + bits.read(eof.sym);
    size_t ml = kMLBase[eml.sym] + bits.read(kMLBits[eml.sym]);
    size_t ll = kLLBase[ell.sym] + bits.read(kLLBits[ell.sym]);
    if (i + 1 < nseq) {
      sll = ell.base + static_cast<uint32_t>(bits.read(ell.nbits));
      sml = eml.base + static_cast<uint32_t>(bits.read(eml.nbits));
      sof = eof.base + static_cast<uint32_t>(bits.read(eof.nbits));
    }
    if (bits.left < 0) fail("corrupt sequences: bitstream overrun");
    size_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      size_t idx = ofv + (ll == 0 ? 1 : 0);
      if (idx == 1) {
        offset = fs.rep[0];
      } else if (idx == 2) {
        offset = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      } else {
        offset = idx == 3 ? fs.rep[2] : fs.rep[0] - 1;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (ll > regen - lit_pos) fail("corrupt sequence: literals past the end");
    out.append(lit.data() + lit_pos, ll);
    lit_pos += ll;
    if (offset == 0 || offset > out.len - frame_start)
      fail("corrupt sequence: offset before the start of the frame");
    if (out.len - start_len + ml > kBlockMax) fail("corrupt block: more than 128 KiB");
    out.match(offset, ml);
  }
  if (bits.left != 0) fail("corrupt sequences: bitstream not consumed exactly");
  out.append(lit.data() + lit_pos, regen - lit_pos);
  if (out.len - start_len > kBlockMax) fail("corrupt block: more than 128 KiB");
}

// decodes the frame or skippable frame at the start of s; returns its size
size_t frame(Span s, Out& out) {
  uint32_t magic = static_cast<uint32_t>(s.le(0, 4, "frame magic"));
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    size_t size = s.le(4, 4, "skippable frame size");
    s.need(8 + size, "skippable frame");
    return 8 + size;
  }
  if (magic != 0xFD2FB528u) {
    char buf[64];
    std::snprintf(buf, sizeof buf, "bad magic 0x%08x: not a zstd frame", magic);
    fail(buf);
  }
  uint8_t fhd = s.byte(4, "frame header");
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  if (fhd & 8) fail("corrupt frame header: reserved bit set");
  size_t pos = 5 + (single ? 0 : 1);
  if (!single) {
    uint8_t wd = s.byte(5, "window descriptor");
    if ((wd >> 3) + 10 > 41) fail("corrupt frame header: window too large");
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  uint64_t dict = s.le(pos, kDictBytes[dict_flag], "dictionary id");
  pos += kDictBytes[dict_flag];
  if (dict != 0)
    fail("zstd dictionaries are not supported (the frame names dictionary " +
         std::to_string(dict) + ")");
  int fcs_bytes = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  bool has_fcs = fcs_bytes > 0;
  uint64_t fcs = s.le(pos, fcs_bytes, "frame content size");
  if (fcs_bytes == 2) fcs += 256;
  pos += fcs_bytes;
  size_t frame_start = out.len;
  if (has_fcs && !out.fixed) out.reserve(out.len + (fcs < (1ULL << 30) ? fcs : (1ULL << 30)));
  FrameState fs;
  for (bool last = false; !last;) {
    uint32_t bh = static_cast<uint32_t>(s.le(pos, 3, "block header"));
    pos += 3;
    last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("corrupt block: reserved block type");
    if (size > kBlockMax) fail("corrupt block: more than 128 KiB");
    if (type == 0) {
      Span d = s.sub(pos, size, "raw block");
      out.append(d.p, size);
      pos += size;
    } else if (type == 1) {
      out.fill(s.byte(pos, "RLE block"), size);
      pos += 1;
    } else {
      compressed_block(s.sub(pos, size, "compressed block"), out, frame_start, fs);
      pos += size;
    }
  }
  size_t produced = out.len - frame_start;
  if (has_fcs && produced != fcs)
    fail("frame content size " + std::to_string(fcs) + " but " +
         std::to_string(produced) + " bytes decoded");
  if (checksum) {
    uint32_t want = static_cast<uint32_t>(s.le(pos, 4, "content checksum"));
    uint32_t got = static_cast<uint32_t>(xxh64_hash(out.buf + frame_start, produced, 0));
    if (want != got) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decompress(Span s, Out& out) {
  if (s.n == 0) fail("empty input: no zstd frame");
  for (size_t pos = 0; pos < s.n;) pos += frame(s.from(pos, "frame"), out);
}

void set_err(char* err, size_t cap, const char* msg) {
  if (!err || !cap) return;
  std::strncpy(err, msg, cap - 1);
  err[cap - 1] = 0;
}

}  // namespace

extern "C" {

int zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len,
                    char* err, size_t err_cap) {
  try {
    Out o;
    decompress(Span{src, n}, o);
    if (o.len == 0) o.reserve(1);  // a pointer the caller can free
    *out = o.buf;
    *out_len = o.len;
    o.buf = nullptr;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, err_cap, e.what());
    return -1;
  }
}

int zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                         size_t* out_len, char* err, size_t err_cap) {
  try {
    Out o;
    o.buf = dst;
    o.cap = cap;
    o.fixed = true;
    decompress(Span{src, n}, o);
    *out_len = o.len;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, err_cap, e.what());
    return -1;
  }
}

void zstd_free(uint8_t* p) { std::free(p); }

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  return crc32c_update(crc, p, n);
}

}  // extern "C"
