// A zstd decoder (RFC 8878), on the host: the codec of the JAX package's
// orbax checkpoints (each array a zarr v2 chunk with compressor zstd, inside
// an OCDBT database whose nodes are zstd-compressed too).  The card's
// machine has no libzstd binding, so the port carries its own decoder, as it
// carries its own JPEG decoder (jpeg_entropy.cpp).
//
// It reads every frame that libzstd writes: frames with and without the
// content size and the checksum (XXH64, checked), single-segment frames,
// raw, RLE and compressed blocks; in a compressed block raw, RLE and
// Huffman-coded literals (one or four streams, the tree described by
// direct or FSE-coded weights, the treeless repeat of the last tree) and
// the sequences in predefined, RLE, FSE-compressed and repeat modes, with
// the three repeat offsets.  Concatenated frames decode one after another
// and skippable frames are skipped.  A frame that names a dictionary, a
// checksum that does not match and any malformed input are errors: the
// caller raises.  The whole output is kept in memory, so a window of any
// size (level 19's 8 MiB, level 22's 128 MiB) needs nothing more.
//
// ops/zstd.py's decompress_plain is the same decoder in Python, kept for the
// tests.  Build: c++ -O2 -std=c++17 -shared -fPIC -pthread (ops/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Corrupt(what); }

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// XXH64 of a buffer, seed 0 (the frame checksum is its low 32 bits).
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xround(0, le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)le32(p) * P1;
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

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// A bitstream read forward, least significant bit first (the FSE table
// descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < n; i++)
      v |= (uint64_t)p[byte + i] << (8 * i);
    return (uint32_t)((v >> (pos & 7)) & ((1ULL << nb) - 1));
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos += nb;
    if (pos > 8 * n) fail("FSE table description runs past its data");
    return v;
  }
};

// A bitstream read backward from its last byte's marker bit (Huffman
// streams, FSE streams).  The bytes are copied in front of 8 zero bytes, so
// a read near the end needs no bounds check.
struct BackwardBits {
  std::vector<uint8_t> buf;  // the stream, then 8 zero bytes
  int64_t pos;               // bits not yet read, counted from the start
  BackwardBits(const uint8_t* p, size_t n) {
    if (n == 0) fail("empty bitstream");
    if (p[n - 1] == 0) fail("bitstream without its end marker");
    buf.assign(n + 8, 0);
    std::memcpy(buf.data(), p, n);
    pos = (int64_t)(n - 1) * 8 + highbit(p[n - 1]);
  }
  // the nb bits below pos (nb <= 56); bits below the start read as zero
  inline uint64_t peek(int nb) const {
    if (pos >= nb) {
      int64_t at = pos - nb;
      uint64_t v = le64(buf.data() + (at >> 3));
      return (v >> (at & 7)) & ((1ULL << nb) - 1);
    }
    if (pos <= 0) return 0;
    uint64_t v = le64(buf.data()) & ((1ULL << pos) - 1);
    return v << (nb - pos);
  }
  inline uint64_t read(int nb) {
    if (nb == 0) return 0;
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// ---- FSE ------------------------------------------------------------------

struct FseEntry {
  uint8_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool valid = false;
};

void build_fse(FseTable& tab, const int16_t* norm, int nsym, int log) {
  int size = 1 << log;
  tab.log = log;
  tab.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      tab.t[high--].symbol = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      tab.t[pos].symbol = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table: bad distribution");
  for (int u = 0; u < size; u++) {
    int s = tab.t[u].symbol;
    int ns = next[s]++;
    int nb = log - highbit(ns);
    tab.t[u].nbits = (uint8_t)nb;
    tab.t[u].base = (uint16_t)((ns << nb) - size);
  }
  tab.valid = true;
}

// Reads an FSE table description; returns the bytes it took.
size_t read_fse(FseTable& tab, const uint8_t* p, size_t n, int max_sym,
                int max_log) {
  ForwardBits br{p, n};
  int log = (int)br.read(4) + 5;
  if (log > max_log) fail("FSE table: accuracy log too large");
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int sym = 0;
  while (remaining > 1 && sym <= max_sym) {
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = br.peek(nb);
    int value;
    if ((int)(v & (threshold - 1)) < max) {
      value = (int)(v & (threshold - 1));
      br.read(nb - 1);
    } else {
      value = (int)(v & (2 * threshold - 1));
      if (value >= threshold) value -= max;
      br.read(nb);
    }
    int count = value - 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    if (count == 0) {
      for (;;) {
        int rep = (int)br.read(2);
        for (int i = 0; i < rep; i++) {
          if (sym > max_sym) fail("FSE table: too many symbols");
          norm[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      nb--;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || sym > max_sym + 1) fail("FSE table: bad counts");
  build_fse(tab, norm, sym, log);
  return (br.pos + 7) / 8;
}

// ---- Huffman literals -----------------------------------------------------

struct HufTable {
  int maxbits = 0;
  std::vector<uint8_t> sym, nbits;  // 1 << maxbits entries
  bool valid = false;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman(HufTable& h, const uint8_t* p, size_t n) {
  if (n < 1) fail("Huffman tree: no header");
  uint8_t weights[256] = {0};
  int nw = 0;
  size_t used;
  int hb = p[0];
  if (hb >= 128) {
    nw = hb - 127;
    size_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) fail("Huffman tree: weights past the block");
    for (int i = 0; i < nw; i++) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  } else {
    if (hb == 0 || 1 + (size_t)hb > n) fail("Huffman tree: bad size");
    const uint8_t* q = p + 1;
    FseTable ft;
    size_t hdr = read_fse(ft, q, hb, 255, 6);
    if (hdr >= (size_t)hb) fail("Huffman tree: no weight stream");
    BackwardBits bs(q + hdr, hb - hdr);
    uint32_t s1 = (uint32_t)bs.read(ft.log), s2 = (uint32_t)bs.read(ft.log);
    for (;;) {
      if (nw > 253) fail("Huffman tree: too many weights");
      weights[nw++] = ft.t[s1].symbol;
      s1 = ft.t[s1].base + (uint32_t)bs.read(ft.t[s1].nbits);
      if (bs.pos < 0) {
        weights[nw++] = ft.t[s2].symbol;
        break;
      }
      weights[nw++] = ft.t[s2].symbol;
      s2 = ft.t[s2].base + (uint32_t)bs.read(ft.t[s2].nbits);
      if (bs.pos < 0) {
        weights[nw++] = ft.t[s1].symbol;
        break;
      }
    }
    used = 1 + hb;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (weights[i] > 11) fail("Huffman tree: weight too large");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman tree: no weights");
  int maxbits = highbit(total) + 1;
  uint32_t rest = (1u << maxbits) - total;
  if (rest & (rest - 1)) fail("Huffman tree: weights do not complete");
  if (nw > 255) fail("Huffman tree: too many symbols");
  weights[nw++] = (uint8_t)(highbit(rest) + 1);
  if (maxbits > 11) fail("Huffman tree: codes longer than 11 bits");
  h.maxbits = maxbits;
  h.sym.assign(1u << maxbits, 0);
  h.nbits.assign(1u << maxbits, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= maxbits; w++) {
    uint32_t len = 1u << (w - 1);
    for (int s = 0; s < nw; s++) {
      if (weights[s] != w) continue;
      for (uint32_t i = 0; i < len; i++) {
        h.sym[pos + i] = (uint8_t)s;
        h.nbits[pos + i] = (uint8_t)(maxbits + 1 - w);
      }
      pos += len;
    }
  }
  if (pos != (1u << maxbits)) fail("Huffman tree: bad table");
  h.valid = true;
  return used;
}

// Decodes k Huffman streams (1 or 4) of counts[i] symbols each.  The
// streams advance side by side, five codes of at most 11 bits from one load
// of 57 bits per stream and round (the rounds of the four streams are
// independent, so their loads and lookups overlap); the last codes of each
// stream decode one at a time.
void huffman_streams(const HufTable& h, int k, const uint8_t* const* p,
                     const size_t* n, uint8_t* const* out,
                     const size_t* counts) {
  const int mb = h.maxbits;
  const uint32_t mask = (1u << mb) - 1;
  std::vector<uint16_t> tab(h.sym.size());
  for (size_t i = 0; i < tab.size(); i++)
    tab[i] = (uint16_t)(h.sym[i] | (h.nbits[i] << 8));
  const uint16_t* t = tab.data();
  std::vector<BackwardBits> bs;
  bs.reserve(k);
  for (int j = 0; j < k; j++) bs.emplace_back(p[j], n[j]);
  size_t done[4] = {0, 0, 0, 0};
  for (;;) {
    bool ok = true;
    for (int j = 0; j < k; j++)
      ok = ok && done[j] + 5 <= counts[j] && bs[j].pos >= 57;
    if (!ok) break;
    for (int j = 0; j < k; j++) {
      int64_t at = bs[j].pos - 57;
      uint64_t v = le64(bs[j].buf.data() + (at >> 3)) >> (at & 7);
      int c = 57;
      uint8_t* o = out[j] + done[j];
      for (int r = 0; r < 5; r++) {
        uint16_t e = t[(uint32_t)(v >> (c - mb)) & mask];
        o[r] = (uint8_t)e;
        c -= e >> 8;
      }
      bs[j].pos -= 57 - c;
      done[j] += 5;
    }
  }
  for (int j = 0; j < k; j++) {
    BackwardBits& b = bs[j];
    for (size_t i = done[j]; i < counts[j]; i++) {
      uint16_t e = t[(uint32_t)b.peek(mb)];
      out[j][i] = (uint8_t)e;
      b.pos -= e >> 8;
    }
    if (b.pos != 0) fail("Huffman stream not consumed exactly");
  }
}

// ---- sequences ------------------------------------------------------------

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// The decoded bytes: a vector that grows, or the caller's buffer of a
// fixed size (the content sizes the frames declare), written in place.
class Out {
 public:
  explicit Out(std::vector<uint8_t>* vec) : vec_(vec) {}
  Out(uint8_t* buf, size_t cap) : buf_(buf), cap_(cap) {}
  size_t size() const { return vec_ ? vec_->size() : len_; }
  uint8_t* data() { return vec_ ? vec_->data() : buf_; }
  void reserve(size_t n) {
    if (vec_) vec_->reserve(n);
  }
  // n more bytes at the end, uninitialised; their address
  uint8_t* grow(size_t n) {
    size_t old = size();
    if (vec_) {
      vec_->resize(old + n);
    } else {
      if (n > cap_ - len_) fail("output larger than the frames declare");
      len_ += n;
    }
    return data() + old;
  }
  void append(const uint8_t* p, size_t n) {
    if (n) std::memcpy(grow(n), p, n);
  }
  void fill(size_t n, uint8_t b) {
    if (n) std::memset(grow(n), b, n);
  }

 private:
  std::vector<uint8_t>* vec_ = nullptr;
  uint8_t* buf_ = nullptr;
  size_t cap_ = 0, len_ = 0;
};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
};

// Reads one table of the sequences section by its mode; returns the bytes
// it took.
size_t read_seq_table(FseTable& tab, int mode, const uint8_t* p, size_t n,
                      const int16_t* dflt, int dflt_n, int dflt_log,
                      int max_sym, int max_log) {
  switch (mode) {
    case 0:
      build_fse(tab, dflt, dflt_n, dflt_log);
      return 0;
    case 1: {
      if (n < 1) fail("sequences: RLE table past the block");
      if (p[0] > max_sym) fail("sequences: RLE symbol out of range");
      tab.log = 0;
      tab.t.assign(1, FseEntry{p[0], 0, 0});
      tab.valid = true;
      return 1;
    }
    case 2:
      return read_fse(tab, p, n, max_sym, max_log);
    default:
      if (!tab.valid) fail("sequences: repeat mode without a table");
      return 0;
  }
}

void decode_block(FrameState& st, const uint8_t* p, size_t n,
                  Out& out, size_t frame_start) {
  if (n < 1) fail("compressed block: empty");
  // literals section
  int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hdr = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      regen = p[0] >> 3;
      hdr = 1;
    } else if (sf == 1) {
      if (n < 2) fail("literals header past the block");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4);
      hdr = 2;
    } else {
      if (n < 3) fail("literals header past the block");
      regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
      hdr = 3;
    }
  } else {
    streams = sf == 0 ? 1 : 4;
    hdr = sf < 2 ? 3 : (sf == 2 ? 4 : 5);
    if (n < hdr) fail("literals header past the block");
    uint64_t h = 0;
    for (size_t i = 0; i < hdr; i++) h |= (uint64_t)p[i] << (8 * i);
    int bits = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    regen = (h >> 4) & ((1u << bits) - 1);
    csize = (h >> (4 + bits)) & ((1u << bits) - 1);
  }
  if (regen > (1u << 17)) fail("literals larger than a block");
  std::vector<uint8_t> lit(regen + 32);
  size_t at = hdr;
  if (ltype == 0) {
    if (at + regen > n) fail("raw literals past the block");
    std::memcpy(lit.data(), p + at, regen);
    at += regen;
  } else if (ltype == 1) {
    if (at + 1 > n) fail("RLE literals past the block");
    std::memset(lit.data(), p[at], regen);
    at += 1;
  } else {
    if (at + csize > n) fail("compressed literals past the block");
    const uint8_t* q = p + at;
    size_t qn = csize;
    if (ltype == 2) {
      size_t used = read_huffman(st.huf, q, qn);
      q += used;
      qn -= used;
    } else if (!st.huf.valid) {
      fail("treeless literals without an earlier tree");
    }
    if (streams == 1) {
      uint8_t* o = lit.data();
      huffman_streams(st.huf, 1, &q, &qn, &o, &regen);
    } else {
      if (qn < 6) fail("four literal streams: no jump table");
      size_t sz[4] = {(size_t)(q[0] | (q[1] << 8)), (size_t)(q[2] | (q[3] << 8)),
                      (size_t)(q[4] | (q[5] << 8)), 0};
      if (6 + sz[0] + sz[1] + sz[2] > qn)
        fail("four literal streams: bad sizes");
      sz[3] = qn - 6 - sz[0] - sz[1] - sz[2];
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("four literal streams: too few literals");
      const uint8_t* ps[4] = {q + 6, q + 6 + sz[0], q + 6 + sz[0] + sz[1],
                              q + 6 + sz[0] + sz[1] + sz[2]};
      uint8_t* os[4] = {lit.data(), lit.data() + seg, lit.data() + 2 * seg,
                        lit.data() + 3 * seg};
      size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huffman_streams(st.huf, 4, ps, sz, os, counts);
    }
    at += csize;
  }
  // sequences section
  if (at >= n) fail("sequences section missing");
  size_t nseq;
  int b0 = p[at];
  if (b0 < 128) {
    nseq = b0;
    at += 1;
  } else if (b0 < 255) {
    if (at + 2 > n) fail("sequences header past the block");
    nseq = ((size_t)(b0 - 128) << 8) + p[at + 1];
    at += 2;
  } else {
    if (at + 3 > n) fail("sequences header past the block");
    nseq = p[at + 1] + ((size_t)p[at + 2] << 8) + 0x7F00;
    at += 3;
  }
  const uint8_t* lp = lit.data();
  size_t lleft = regen;
  if (nseq == 0) {
    if (at != n) fail("bytes after an empty sequences section");
    out.append(lp, lleft);
    return;
  }
  if (at >= n) fail("sequences modes past the block");
  int modes = p[at++];
  if (modes & 3) fail("sequences: reserved mode bits set");
  at += read_seq_table(st.ll, (modes >> 6) & 3, p + at, n - at, LL_DEFAULT, 36,
                       6, 35, 9);
  at += read_seq_table(st.of, (modes >> 4) & 3, p + at, n - at, OF_DEFAULT, 29,
                       5, 31, 8);
  at += read_seq_table(st.ml, (modes >> 2) & 3, p + at, n - at, ML_DEFAULT, 53,
                       6, 52, 9);
  if (at >= n) fail("sequences bitstream missing");
  BackwardBits bs(p + at, n - at);
  uint32_t sll = (uint32_t)bs.read(st.ll.log);
  uint32_t sof = (uint32_t)bs.read(st.of.log);
  uint32_t sml = (uint32_t)bs.read(st.ml.log);
  uint64_t* rep = st.rep;
  for (size_t i = 0; i < nseq; i++) {
    const FseEntry& el = st.ll.t[sll];
    const FseEntry& eo = st.of.t[sof];
    const FseEntry& em = st.ml.t[sml];
    int ofc = eo.symbol;
    if (ofc > 31) fail("sequences: offset code too large");
    if (el.symbol > 35 || em.symbol > 52) fail("sequences: bad length code");
    uint64_t ofv = (1ULL << ofc) + bs.read(ofc);
    uint64_t ml = ML_BASE[em.symbol] + bs.read(ML_BITS[em.symbol]);
    uint64_t ll = LL_BASE[el.symbol] + bs.read(LL_BITS[el.symbol]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      int idx = (int)ofv - 1 + (ll == 0 ? 1 : 0);  // 0..3
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (offset == 0) fail("sequences: zero repeat offset");
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = el.base + (uint32_t)bs.read(el.nbits);
      sml = em.base + (uint32_t)bs.read(em.nbits);
      sof = eo.base + (uint32_t)bs.read(eo.nbits);
    }
    if (bs.pos < 0) fail("sequences bitstream overrun");
    if (ll > lleft) fail("sequences: literals overrun");
    out.append(lp, ll);
    lp += ll;
    lleft -= ll;
    size_t have = out.size() - frame_start;
    if (offset > have || offset == 0) fail("sequences: offset past the output");
    uint8_t* dst = out.grow(ml);
    const uint8_t* src = dst - offset;
    if (offset >= ml) {
      std::memcpy(dst, src, ml);
    } else {
      for (size_t k = 0; k < ml; k++) dst[k] = src[k];
    }
  }
  if (bs.pos != 0) fail("sequences bitstream not consumed exactly");
  out.append(lp, lleft);
}

// Decodes one frame starting at p; returns the bytes it took.
size_t decode_frame(const uint8_t* p, size_t n, Out& out) {
  if (n < 6) fail("frame header cut");
  int fhd = p[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  int did_flag = fhd & 3;
  if (fhd & 8) fail("frame header: reserved bit set");
  size_t at = 5;
  uint64_t window = 0;
  if (!single) {
    int wd = p[at++];
    int exp = wd >> 3, mant = wd & 7;
    uint64_t base = 1ULL << (10 + exp);
    window = base + (base / 8) * mant;
  }
  static const int did_size[4] = {0, 1, 2, 4};
  uint64_t did = 0;
  if (at + did_size[did_flag] > n) fail("frame header cut");
  for (int i = 0; i < did_size[did_flag]; i++)
    did |= (uint64_t)p[at + i] << (8 * i);
  at += did_size[did_flag];
  if (did != 0) fail("frame names a dictionary (not supported)");
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (at + fcs_size > n) fail("frame header cut");
  uint64_t fcs = 0;
  bool has_fcs = fcs_size > 0;
  for (int i = 0; i < fcs_size; i++) fcs |= (uint64_t)p[at + i] << (8 * i);
  if (fcs_size == 2) fcs += 256;
  at += fcs_size;
  if (single) window = fcs;
  (void)window;
  size_t start = out.size();
  if (has_fcs) out.reserve(start + fcs);
  FrameState st;
  for (;;) {
    if (at + 3 > n) fail("block header cut");
    uint32_t bh = p[at] | (p[at + 1] << 8) | (p[at + 2] << 16);
    at += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > (1u << 17)) fail("block larger than 128 KiB");
    if (type == 0) {
      if (at + size > n) fail("raw block cut");
      out.append(p + at, size);
      at += size;
    } else if (type == 1) {
      if (at + 1 > n) fail("RLE block cut");
      out.fill(size, p[at]);
      at += 1;
    } else {
      if (at + size > n) fail("compressed block cut");
      size_t before = out.size();
      decode_block(st, p + at, size, out, start);
      if (out.size() - before > (1u << 17)) fail("block decodes past 128 KiB");
      at += size;
    }
    if (last) break;
  }
  if (has_fcs && out.size() - start != fcs)
    fail("frame content size does not match");
  if (checksum) {
    if (at + 4 > n) fail("checksum cut");
    uint32_t want = le32(p + at);
    uint32_t got = (uint32_t)xxh64(out.data() + start, out.size() - start, 0);
    if (want != got) fail("checksum mismatch");
    at += 4;
  }
  return at;
}

void decode_all(const uint8_t* p, size_t n, Out& out) {
  if (n == 0) fail("no frame");
  size_t at = 0;
  while (at < n) {
    if (n - at < 4) fail("trailing bytes after the last frame");
    uint32_t magic = le32(p + at);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - at < 8) fail("skippable frame cut");
      uint32_t size = le32(p + at + 4);
      if (size > n - at - 8) fail("skippable frame cut");
      at += 8 + size;
    } else if (magic == 0xFD2FB528u) {
      at += decode_frame(p + at, n - at, out);
    } else {
      fail("bad magic number");
    }
  }
}

void set_err(char* err, int cap, const char* msg) {
  if (err && cap > 0) std::snprintf(err, cap, "%s", msg);
}

}  // namespace

extern "C" {

// Decodes every frame of src; on success *handle holds the output (take it
// with aihab_zstd_take) and *out_len its size.  Returns 0, or 1 with a
// message in err.
int aihab_zstd_decode(const uint8_t* src, long long n, void** handle,
                      long long* out_len, char* err, int errcap) {
  auto* out = new std::vector<uint8_t>();
  try {
    Out o(out);
    decode_all(src, (size_t)n, o);
  } catch (const std::exception& e) {
    delete out;
    set_err(err, errcap, e.what());
    return 1;
  }
  *handle = out;
  *out_len = (long long)out->size();
  return 0;
}

// The bytes every frame of src declares (skippable frames add none), or
// -1 when a frame does not declare its size or the input is malformed.
long long aihab_zstd_content_size(const uint8_t* src, long long n) {
  try {
    size_t at = 0, total = 0, len = (size_t)n;
    while (at < len) {
      if (len - at < 8) return -1;
      uint32_t magic = le32(src + at);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        at += 8 + (size_t)le32(src + at + 4);
        continue;
      }
      if (magic != 0xFD2FB528u) return -1;
      int fhd = src[at + 4];
      int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
      static const int did_size[4] = {0, 1, 2, 4};
      size_t h = at + 5 + (single ? 0 : 1) + did_size[fhd & 3];
      int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
      if (fcs_size == 0 || h + fcs_size > len) return -1;
      uint64_t fcs = 0;
      for (int i = 0; i < fcs_size; i++) fcs |= (uint64_t)src[h + i] << (8 * i);
      if (fcs_size == 2) fcs += 256;
      total += fcs;
      at = h + fcs_size;
      for (;;) {  // skip the blocks
        if (at + 3 > len) return -1;
        uint32_t bh = src[at] | (src[at + 1] << 8) | (src[at + 2] << 16);
        at += 3 + ((bh >> 1 & 3) == 1 ? 1 : (bh >> 3));
        if (bh & 1) break;
      }
      if ((fhd >> 2) & 1) at += 4;
    }
    return at == len ? (long long)total : -1;
  } catch (const std::exception&) {
    return -1;
  }
}

// Decodes every frame of src into dst, which holds exactly the content size
// the frames declare (aihab_zstd_content_size).  Returns 0, or 1 with a
// message in err.
int aihab_zstd_decode_into(const uint8_t* src, long long n, uint8_t* dst,
                           long long dst_len, char* err, int errcap) {
  try {
    Out o(dst, (size_t)dst_len);
    decode_all(src, (size_t)n, o);
    if (o.size() != (size_t)dst_len) fail("frames shorter than they declare");
  } catch (const std::exception& e) {
    set_err(err, errcap, e.what());
    return 1;
  }
  return 0;
}

// Copies a decoded output into dst (out_len bytes) and frees it.
int aihab_zstd_take(void* handle, uint8_t* dst) {
  auto* out = static_cast<std::vector<uint8_t>*>(handle);
  if (dst && !out->empty()) std::memcpy(dst, out->data(), out->size());
  delete out;
  return 0;
}

// XXH64 with a seed (the frame checksum is its low 32 bits of seed 0).
int aihab_xxh64(const uint8_t* src, long long n, unsigned long long seed,
                unsigned long long* out) {
  *out = xxh64(src, (size_t)n, seed);
  return 0;
}

}  // extern "C"
