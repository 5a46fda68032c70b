// The entropy-coded part of JPEGs (sequential SOF0/SOF1/SOF9 and progressive
// SOF2/SOF10, 8-bit, Huffman or arithmetic coding), on the host, one photo
// per thread: the fast decode's first stage (ops/jpeg.py).  The JAX package
// decodes with libjpeg on the host (native/image_pipeline.cpp); this file
// replaces its entropy decoding (jdhuff.c, jdphuff.c, jdarith.c), and
// csrc/jpeg_pixels.cu (J1, J2) everything after it.
//
// The markers are parsed in Python (data/decode.py parse_jpeg), which hands
// over, per scan, where its bytes lie, its tables (Huffman specs, or the
// arithmetic statistics tables with their DAC conditioning), its band and
// its MCU layout.  Each restart interval is decoded with the per-component
// DC predictors (and a progressive scan's EOB run) reset, exactly as
// data/decode.py's pure-Python reference does (_decode_scan,
// _decode_segment, _decode_progressive_segment, _arith_decode_scan), so the
// coefficients are the reference's.
//
// Restart markers are read as libjpeg reads them (RestartWalk, decode.py
// _restart_walk): at each interval the next marker is taken, a stray code
// or a restart before the one due skipped, any other marker left unread
// (that interval then has no data).  Huffman data that runs out follows
// jdhuff.c and jdphuff.c: the MCU that reads past an interval's data
// decodes with zero bits, every later MCU is left as it is until a restart
// marker is read.  Bits that start no code are 17 bits read for symbol 0,
// as jpeg_huff_decode takes them; a run past coefficient 63 writes 63, as
// libjpeg's jpeg_natural_order does.
//
// Arithmetic-coded scans (ArithScan, decode.py _arith_decode_scan) run
// jdarith.c's QM decoder over libjpeg's data source: the data that runs
// out decodes on from zero bytes, every later MCU included; a bad code (a
// magnitude past 15 bits, an index past the band) leaves every later MCU
// as it is up to the next restart.  The QM encoder (ArithSink,
// ArithEncoder: jcarith.c) writes the fixture tool's arithmetic re-codes
// (tools/jpeg_fixtures.py arith_recode); no decode path calls it.
//
// A sequential photo's coefficients go straight into the caller's buffer.
// A progressive photo's scans accumulate into a full per-photo buffer (all
// 64 a block); where data/decode.py's smoothing_plan says the low
// coefficients are not all known (a cut file), libjpeg's interblock
// smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo 2.1's rows or
// cv2's 3.1's) fills the estimates; then the blocks are packed like a
// sequential photo's.
//
// Entropy decoding is serial within a restart interval, and camera JPEGs
// rarely have restart markers: a photo is one thread's work, and a batch
// runs on a pool of threads.  Called through ctypes, which releases the
// GIL, so request threads and loader threads decode side by side.
//
// The Huffman lookups are decode.py's 16-bit table behind a 9-bit one
// (codes of up to 9 bits, nearly all of a photo's), and for AC codes whose
// value bits fit in those 9 bits the value comes ready-made: the same
// codes, fewer dependent steps.  A block decodes into a local 64-entry
// buffer.
//
// Coefficients are written as int16 in natural order into the caller's
// buffer, only those the chosen IDCT reads (s = 8: all 64; s = 4: rows and
// columns other than 4, 49, and a flag for its zero test, 50; s = 2: rows
// and columns 0, 1, 3, 5, 7, 25; s = 1: the DC), block after block, so
// that the upload to the card carries nothing the IDCT does not read.  A
// value past int16 (only a corrupt file's DC predictor gets there) wraps,
// as libjpeg's JCOEF does.
//
// Build: c++ -O2 -std=c++17 -shared -fPIC -pthread (ops/_build.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kFast = 9;        // bits of the first-level Huffman lookup
constexpr int kLut = 65536 + (1 << kFast);
constexpr uint16_t kMiss = 17 << 8;  // bits that start no code

// status codes (ops/jpeg.py maps them to data/decode.py's messages)
enum {
  kOk = 0,
  kBadTable = 4,
  kBadLayout = 5,
};

// one scan descriptor: int64 fields
enum {
  kPhoto = 0, kStart, kEnd, kRestart, kWidth, kHeight, kHmax, kVmax, kNs,
  kSs, kSe, kAh, kAl, kProgressive, kArith,
  kSlots,  // then 4 slots of kSlotFields
};
enum { kH = 0, kV, kBw, kBh, kCoefOff, kScale, kDcTab, kAcTab, kComp, kSlotFields };
constexpr int kScanFields = kSlots + 4 * kSlotFields;
constexpr int kTableBytes = 16 + 256;  // counts, then up to 256 symbols
constexpr size_t kPad = 4096 + 8;      // decode.py's zero pad + one peek

// one photo descriptor (progressive photos): int64 fields, then 4 slots
enum { kPiProgressive = 0, kPiComps, kPiRows, kPiRule, kPiSlots };
enum { kPiBw = 0, kPiBh, kPiWib, kPiHib, kPiV, kPiCoefOff, kPiScale, kPiQ,
       kPiBits = kPiQ + 10, kPiPrev = kPiBits + 10, kPiFields = kPiPrev + 10 };
constexpr int kPhotoFields = kPiSlots + 4 * kPiFields;

// libjpeg's jpeg_natural_order, with its 16 extra entries
constexpr int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the natural indices the IDCT of size s = 1, 2, 4, 8 reads, in packed order
struct Keep {
  int8_t idx[4][64];
  Keep() {
    int n[4] = {0, 0, 0, 0};
    for (int z = 0; z < 64; ++z) {
      const int r = z / 8, c = z % 8;
      const bool odd_or_low = (r < 2 || (r & 1)) && (c < 2 || (c & 1));
      if (z == 0) idx[0][n[0]++] = 0;
      if (odd_or_low) idx[1][n[1]++] = static_cast<int8_t>(z);
      if (r != 4 && c != 4) idx[2][n[2]++] = static_cast<int8_t>(z);
      idx[3][n[3]++] = static_cast<int8_t>(z);
    }
  }
};
const Keep kKeep;

int pack_index(int s) { return s == 1 ? 0 : s == 2 ? 1 : s == 4 ? 2 : s == 8 ? 3 : -1; }
int packed_size(int s) { return s == 1 ? 1 : s == 2 ? 25 : s == 4 ? 50 : 64; }

// one block's coefficients (natural order) packed for the IDCT of size s
// (`keep`, `k` = packed_size(s)): the coefficients it reads, and for the
// 4x4 a 50th value, 1 where column 4 (which it never reads) holds a
// non-zero in rows 1-3 or 5-7, as libjpeg-turbo's SIMD 4x4 tests it
void pack_block(const int16_t* nat, const int8_t* keep, int k, int16_t* dst) {
  if (k == 64) {
    std::memcpy(dst, nat, 64 * sizeof(int16_t));
    return;
  }
  const int n = k == 50 ? 49 : k;
  for (int q = 0; q < n; ++q) dst[q] = nat[keep[q]];
  if (k == 50) {
    int16_t any = 0;
    for (int r : {1, 2, 3, 5, 6, 7}) any |= nat[r * 8 + 4] != 0;
    dst[49] = any;
  }
}

// decode.py _build_lut: next 16 bits -> (code length << 8) | symbol (kMiss:
// no code), then the same for codes of up to kFast bits, by the next kFast
// bits (0: longer)
bool build_lut(const uint8_t* spec, uint16_t* lut) {
  std::fill(lut, lut + 65536, kMiss);
  std::memset(lut + 65536, 0, (1 << kFast) * sizeof(uint16_t));
  int code = 0, k = 0, total = 0;
  for (int i = 0; i < 16; ++i) total += spec[i];
  if (total > 256) return false;
  for (int length = 1; length <= 16; ++length) {
    for (int i = 0; i < spec[length - 1]; ++i) {
      const int lo = code << (16 - length);
      const int hi = (code + 1) << (16 - length);
      if (hi > 65536) return false;
      const uint16_t entry =
          static_cast<uint16_t>((length << 8) | spec[16 + k]);
      for (int j = lo; j < hi; ++j) lut[j] = entry;
      if (length <= kFast)
        for (int j = lo >> (16 - kFast); j < hi >> (16 - kFast); ++j)
          lut[65536 + j] = entry;
      ++code;
      ++k;
    }
    code <<= 1;
  }
  return true;
}

struct Comp {
  int16_t* coef;
  const int8_t* keep;  // packed index -> natural index
  int k;               // coefficients a block
  int h, v, bw;
  long long cols;      // a one-component scan's blocks a row
  const uint16_t* dc;  // 16-bit lookups, each followed by its 9-bit one
  const uint16_t* ac;
  const int32_t* fast_ac;
};

// an AC table's codes whose code and value bits fit in kFast bits, by the
// next kFast bits: value << 16 | run << 8 | bits (0: take the slow path)
void build_fast_ac(const uint16_t* lut, int32_t* fast) {
  for (int i = 0; i < (1 << kFast); ++i) {
    fast[i] = 0;
    const uint16_t e = lut[65536 + i];
    const int ln = e >> 8, rs = e & 0xFF, s = rs & 15;
    if (!e || !s || ln + s > kFast) continue;
    const uint32_t v = (static_cast<uint32_t>(i) >> (kFast - ln - s)) & ((1u << s) - 1);
    const int val = (v >> (s - 1)) ? static_cast<int>(v)
                                   : static_cast<int>(v) - (1 << s) + 1;
    fast[i] = static_cast<int32_t>(static_cast<uint32_t>(val) << 16) | ((rs >> 4) << 8) | (ln + s);
  }
}

// the entry for the next 16 bits of w: the kFast-bit table's (1 KB, in L1)
// where the code is that short, else the 16-bit table's
inline uint16_t lookup(const uint16_t* lut, uint64_t w) {
  const uint16_t e = lut[65536 + (w >> (64 - kFast))];
  return e ? e : lut[w >> 48];
}

// the next 64 bits at bit `pos` (57 of them valid)
inline uint64_t peek(const uint8_t* buf, size_t pos) {
  uint64_t w;
  std::memcpy(&w, buf + (pos >> 3), 8);
  return __builtin_bswap64(w) << (pos & 7);
}

inline int extend(uint32_t v, int s) {
  return (v >> (s - 1)) ? static_cast<int>(v)
                        : static_cast<int>(v) - (1 << s) + 1;
}

// the block of MCU `unit` of the scan, for its component j and block b
inline long long block_of(const Comp& c, bool single, int mcux, long long unit,
                          int b) {
  if (single) return (unit / c.cols) * c.bw + unit % c.cols;
  const long long my = unit / mcux, mx = unit % mcux;
  return (my * c.v + b / c.h) * c.bw + mx * c.h + b % c.h;
}

// decode.py _decode_segment: `n_units` MCUs of a sequential scan from one
// restart segment; returns the MCU that read past the data, or -1
long long decode_segment(const uint8_t* buf, size_t len, const Comp* comps,
                         int ns, bool single, int mcux, long long first,
                         long long n_units) {
  const size_t nbits = 8 * len;
  size_t pos = 0;
  long long preds[4] = {0, 0, 0, 0};
  for (long long i = 0; i < n_units; ++i) {
    const long long unit = first + i;
    for (int j = 0; j < ns; ++j) {
      const Comp& c = comps[j];
      const int nblk = single ? 1 : c.h * c.v;
      for (int b = 0; b < nblk; ++b) {
        int16_t* dst = c.coef + block_of(c, single, mcux, unit, b) * c.k;
        int16_t out[64];
        std::memset(out, 0, sizeof(out));
        uint64_t w = peek(buf, pos);
        const uint16_t e = lookup(c.dc, w);
        int ln = e >> 8, s = e & 0xFF;
        pos += ln;
        long long diff = 0;
        if (s) {
          const uint32_t v = static_cast<uint32_t>((w << ln) >> (64 - s));
          pos += s;
          diff = extend(v, s);
        }
        preds[j] += diff;
        out[0] = static_cast<int16_t>(preds[j]);
        int k = 1;
        while (k < 64) {
          w = peek(buf, pos);
          const int32_t f = c.fast_ac[w >> (64 - kFast)];
          if (f) {
            k += (f >> 8) & 0xFF;
            pos += f & 0xFF;
            out[kZigzag[k]] = static_cast<int16_t>(f >> 16);
            ++k;
            continue;
          }
          const uint16_t a = lookup(c.ac, w);
          ln = a >> 8;
          const int rs = a & 0xFF;
          s = rs & 15;
          pos += ln;
          if (s) {
            k += rs >> 4;
            const uint32_t v = static_cast<uint32_t>((w << ln) >> (64 - s));
            pos += s;
            out[kZigzag[k]] = static_cast<int16_t>(extend(v, s));
            ++k;
          } else if (rs == 0xF0) {
            k += 16;
          } else {
            break;
          }
        }
        pack_block(out, c.keep, c.k, dst);
      }
    }
    if (pos > nbits) return i;
  }
  return -1;
}

struct Bits {
  const uint8_t* buf;
  size_t pos;
  uint32_t get(int n) {
    if (!n) return 0;
    const uint64_t w = peek(buf, pos);
    pos += n;
    return static_cast<uint32_t>(w >> (64 - n));
  }
  int huff(const uint16_t* lut) {
    const uint16_t e = lookup(lut, peek(buf, pos));
    pos += e >> 8;
    return e & 0xFF;
  }
};

// decode.py _decode_progressive_segment: one restart segment of a scan of
// a progressive frame (jdphuff.c), into full 64-coefficient blocks
long long decode_progressive_segment(const uint8_t* buf, size_t len,
                                     const Comp* comps, int ns, bool single,
                                     int mcux, long long first,
                                     long long n_units, int ss, int se,
                                     int ah, int al) {
  const size_t nbits = 8 * len;
  Bits br{buf, 0};
  long long preds[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  auto correct = [&](int16_t& v) {
    if (br.get(1) && (v & p1) == 0)
      v = static_cast<int16_t>(v + (v >= 0 ? p1 : m1));
  };
  for (long long i = 0; i < n_units; ++i) {
    const long long unit = first + i;
    for (int j = 0; j < ns; ++j) {
      const Comp& c = comps[j];
      const int nblk = single ? 1 : c.h * c.v;
      for (int b = 0; b < nblk; ++b) {
        int16_t* blk = c.coef + block_of(c, single, mcux, unit, b) * 64;
        if (ss == 0 && ah == 0) {          // DC first
          const int s = br.huff(c.dc);
          preds[j] += s ? extend(br.get(s), s) : 0;
          blk[0] = static_cast<int16_t>(
              static_cast<uint32_t>(preds[j]) << al);
        } else if (ss == 0) {              // DC refine
          if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
        } else if (ah == 0) {              // AC first
          if (eobrun) {
            --eobrun;
            continue;
          }
          for (int k = ss; k <= se; ++k) {
            const int rs = br.huff(c.ac);
            const int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              blk[kZigzag[k]] = static_cast<int16_t>(
                  static_cast<uint32_t>(extend(br.get(s), s)) << al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = (1u << r) + br.get(r) - 1;
              break;
            }
          }
        } else {                           // AC refine
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              const int rs = br.huff(c.ac);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                s = br.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = (1u << r) + br.get(r);
                break;
              }
              do {
                int16_t& v = blk[kZigzag[k]];
                if (v) {
                  correct(v);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun > 0) {
            for (; k <= se; ++k) {
              int16_t& v = blk[kZigzag[k]];
              if (v) correct(v);
            }
            --eobrun;
          }
        }
      }
    }
    if (br.pos > nbits) return i;
  }
  return -1;
}

// decode.py's smoothing kernels: 5 x 5 DC weights, rows -2..2 by columns
// -2..2, of the estimates of zigzag coefficients 1..5 without DC
// interpolation and 1..9 with it, and of the DC
constexpr int kSmoothPlain[5][25] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
constexpr int kSmoothDc[9][25] = {
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}};
constexpr int kSmoothDc0[25] = {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152,
                                42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2};
constexpr int kSmoothPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};

// decode.py _smooth_rows: the five rows block row y reads (rule 1:
// libjpeg-turbo 2.1, rule 2: 3.1)
void smooth_rows(long long y, long long v, long long hib, long long bh,
                 long long rows, int rule, long long* out) {
  const long long r = y / v, br = y % v, last = rows - 1;
  const long long n = r < last ? v : (hib % v ? hib % v : v);
  if (rule == 2) {
    const long long top = r == last ? hib - 1 : bh - 1;
    for (int i = 0; i < 5; ++i) out[i] = std::min(std::max(y + i - 2, 0LL), top);
    if (!(br > 1 || r > 1 || (r == 1 && n > 1))) out[0] = out[1];
    return;
  }
  out[2] = y;
  out[1] = (br > 0 || r > 0) ? y - 1 : y;
  out[0] = (br > 1 || r > 1) ? y - 2 : out[1];
  out[3] = (br < n - 1 || r < last) ? y + 1 : y;
  out[4] = (br < n - 2 || r + 1 < last) ? y + 2 : out[3];
}

// decode.py smooth_blocks over one component's full blocks (in place; the
// DCs read are the unsmoothed ones, kept aside)
void smooth_component(int16_t* full, const long long* f, long long rows,
                      int rule, long long last_good,
                      std::vector<int16_t>& dcs) {
  const long long bw = f[kPiBw], bh = f[kPiBh], wib = f[kPiWib],
                  hib = f[kPiHib], v = f[kPiV];
  const long long* q = f + kPiQ;  // quantizers of zigzag 0..9
  dcs.resize(static_cast<size_t>(bw * bh));
  for (long long b = 0; b < bw * bh; ++b) dcs[b] = full[b * 64];
  for (long long y = 0; y < hib; ++y) {
    long long nr[5];
    smooth_rows(y, v, hib, bh, rows, rule, nr);
    const long long* bits = f + (y / v > last_good ? kPiPrev : kPiBits);
    bool change_dc = true;
    for (int i = 1; i < 10; ++i) change_dc &= bits[i] == -1;
    for (long long x = 0; x < wib; ++x) {
      long long dc[25];
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) {
          long long cx = std::min(std::max(x + j - 2, 0LL), wib - 1);
          // libjpeg-turbo 2.1's first column sets only the register one to
          // its right: two blocks wide, the +2 column keeps column 0's DC
          if (rule == 1 && wib == 2 && j == 4) cx = 0;
          else if (rule == 1 && wib == 2 && x == 1 && j == 3) cx = 0;
          dc[5 * i + j] = dcs[nr[i] * bw + cx];
        }
      int16_t* blk = full + (y * bw + x) * 64;
      int16_t orig[64];
      std::memcpy(orig, blk, sizeof(orig));
      const int n_est = change_dc ? 9 : 5;
      for (int e = 0; e < n_est; ++e) {
        const long long al = bits[e + 1];
        const int pos = kSmoothPos[e];
        if (al == 0 || orig[pos] != 0) continue;
        const int* kern = change_dc ? kSmoothDc[e] : kSmoothPlain[e];
        long long sum = 0;
        for (int t = 0; t < 25; ++t) sum += kern[t] * dc[t];
        const long long num = q[0] * sum, qk = q[e + 1];
        long long pred = ((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8);
        if (al > 0 && pred >= (1LL << al)) pred = (1LL << al) - 1;
        blk[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
      }
      if (change_dc) {
        long long sum = 0;
        for (int t = 0; t < 25; ++t) sum += kSmoothDc0[t] * dc[t];
        const long long num = q[0] * sum;
        const long long pred = ((q[0] << 7) + (num >= 0 ? num : -num)) / (q[0] << 8);
        blk[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
      }
    }
  }
}

// decode.py _next_marker: the code of the next marker at or after pos, past
// stuffed zeros and fill bytes, with *at the position of its last 0xFF
// (past the data: libjpeg's fake EOI at n)
int next_marker(const uint8_t* data, long long n, long long pos, long long* at) {
  for (;;) {
    while (pos < n && data[pos] != 0xFF) ++pos;
    long long j = pos + 1;
    while (j < n && data[j] == 0xFF) ++j;
    if (j >= n) {
      *at = n;
      return 0xD9;
    }
    if (data[j]) {
      *at = j - 1;
      return data[j];
    }
    pos = j + 1;
  }
}

// decode.py _segment: one interval's bytes from start to the next marker,
// unstuffed as libjpeg reads them: 0xFF bytes and then 0x00 are one 0xFF
// (inside the interval every run of 0xFF bytes ends so), the 0xFF bytes
// before the marker or the end of the data none
size_t unstuff(const uint8_t* data, long long n, long long start, uint8_t* out) {
  long long stop;
  next_marker(data, n, start, &stop);
  while (stop > start && data[stop - 1] == 0xFF) --stop;
  size_t len = 0;
  for (long long i = start; i < stop; ++i) {
    out[len++] = data[i];
    if (data[i] == 0xFF) {
      while (data[i + 1] == 0xFF) ++i;
      ++i;  // the 0x00
    }
  }
  return len;
}

// decode.py _restart_walk: libjpeg's reading of a Huffman scan's restart
// markers, one interval at a time
struct RestartWalk {
  const uint8_t* data;
  long long n, pos;
  int marker = 0, want = 0;

  // the next interval's start (*start: its data, or -1 where a marker was
  // left unread); true where a marker was read, so the decoder starts
  // afresh
  bool boundary(long long* start) {
    if (!marker) marker = next_marker(data, n, pos, &pos);
    while (marker < 0xC0 || marker == 0xD0 + ((want - 1) & 7) ||
           marker == 0xD0 + ((want - 2) & 7))
      marker = next_marker(data, n, pos + 2, &pos);
    const bool read = marker >= 0xD0 && marker <= 0xD7 &&
                      marker != 0xD0 + ((want + 1) & 7) &&
                      marker != 0xD0 + ((want + 2) & 7);
    want = (want + 1) & 7;
    if (!read) {
      *start = -1;
      return false;
    }
    pos += 2;
    marker = 0;
    *start = pos;
    return true;
  }
};

// ---------------------------------------------------------------------------
// arithmetic coding (libjpeg's jdarith.c and jcarith.c; data/decode.py
// _ArithSource and _arith_decode_scan are the decoder's reference)
// ---------------------------------------------------------------------------

// ITU-T T.81 Table D.2 as libjpeg's jaricom.c packs it: per state, Qe << 16
// | the next state after an MPS << 8 | whether an LPS switches the MPS << 7
// | the next state after an LPS; state 113 is the fixed estimate of 0.5
constexpr uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};
constexpr uint8_t kFixedState = 113;
constexpr int kDcBins = 64, kAcBins = 256, kArithTables = 16;

// one scan component's statistics tables and their DAC conditioning
struct ArithCond {
  int dc, lo, hi, ac, kx;
};

// the scan slot's fields kDcTab (table | L << 4 | U << 8) and kAcTab
// (table | Kx << 4) of an arithmetic-coded scan
inline ArithCond arith_cond(const long long* f) {
  return {static_cast<int>(f[kDcTab] & 15), static_cast<int>((f[kDcTab] >> 4) & 15),
          static_cast<int>((f[kDcTab] >> 8) & 15), static_cast<int>(f[kAcTab] & 15),
          static_cast<int>((f[kAcTab] >> 4) & 255)};
}

// decode.py _ArithSource: the QM decoder over one restart interval's data
// from pos (-1: none, a marker was left unread), with libjpeg's source
// around it (0xFF bytes and then 0x00 a stuffed 0xFF, a marker the end of
// the data, then zero bytes; past n its fake EOI)
struct ArithSource {
  const uint8_t* data = nullptr;
  long long n = 0, pos = -1;
  bool ended = pos < 0;
  long long c = 0, a = 0;
  int ct = -16;

  int byte() {
    const long long p = pos++;
    return p < n ? data[p] : (((p - n) & 1) ? 0xD9 : 0xFF);
  }

  // the next data byte: 0xFF 0x00 is 0xFF, a marker ends the data
  int data_byte() {
    if (ended) return 0;
    int d = byte();
    if (d != 0xFF) return d;
    do d = byte();
    while (d == 0xFF);
    if (d == 0) return 0xFF;
    ended = true;
    return 0;
  }

  int decode(uint8_t* st) {
    // jdarith.c's renormalization (D.2.6), its one-bit steps taken at once:
    // a byte enters C each time the count of buffered bits runs out; the
    // first decision of a segment reads two bytes and sets A to 0x10000
    if (a < 0x8000) {
      if (ct == -16) {
        c = data_byte() << 8;
        c |= data_byte();
        a = 0x10000;
        ct = 0;
      } else {
        const int s = __builtin_clz(static_cast<unsigned>(a)) - 16;
        a <<= s;
        for (ct -= s; ct < 0; ct += 8) c = (c << 8) | data_byte();
      }
    }
    int sv = *st;
    const uint32_t e = kAritab[sv & 0x7F];
    const long long qe = e >> 16;
    a -= qe;
    const long long temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ ((e >> 8) & 0xFF));
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ (e & 0xFF));
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ (e & 0xFF));
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ ((e >> 8) & 0xFF));
      }
    }
    return sv >> 7;
  }
};

// decode.py _arith_decode_scan: one arithmetic-coded scan into the
// components' blocks (a sequential photo's packed, a progressive photo's
// full 64-coefficient ones)
struct ArithScan {
  ArithSource src;
  const Comp* comps;
  const ArithCond* cond;
  int ns, ss, se, al;
  bool progressive, dc_first, dc_refine, ac, ac_first;
  uint8_t dc_stats[kArithTables][kDcBins];
  uint8_t ac_stats[kArithTables][kAcBins];
  uint8_t fixed = kFixedState;
  int last[4] = {0, 0, 0, 0};
  int ctx[4] = {0, 0, 0, 0};

  void reset() {
    for (int j = 0; j < ns; ++j) {
      if (dc_first) {
        std::memset(dc_stats[cond[j].dc], 0, kDcBins);
        last[j] = ctx[j] = 0;
      }
      if (ac) std::memset(ac_stats[cond[j].ac], 0, kAcBins);
    }
  }

  // Figures F.23 and F.24: |v| (0: a category past 15 bits) and m, the
  // top bit of |v| - 1, from the category's first bin st[i]; DC values go
  // on from X1 = 20 (x2 < 0), AC values test st[i] again and go on from x2
  int magnitude(uint8_t* st, int i, int x2, int& m_out) {
    int m = src.decode(st + i);
    if (m && (x2 < 0 || src.decode(st + i))) {
      if (x2 < 0) {
        i = 20;
      } else {
        m = 2;
        i = x2;
      }
      while (src.decode(st + i)) {
        if ((m <<= 1) == 0x8000) return 0;
        ++i;
      }
    }
    m_out = m;
    int v = m;
    i += 14;
    for (int bit = m >> 1; bit; bit >>= 1)
      if (src.decode(st + i)) v |= bit;
    return v + 1;
  }

  // Figure F.19 with F.1.4.4.1.2's conditioning: false on a bad code
  bool dc_diff(int j, int& diff) {
    uint8_t* st = dc_stats[cond[j].dc];
    const int s0 = ctx[j];
    if (!src.decode(st + s0)) {
      ctx[j] = 0;
      diff = 0;
      return true;
    }
    const int sign = src.decode(st + s0 + 1);
    int m = 0;
    const int v = magnitude(st, s0 + 2 + sign, -1, m);
    if (!v) return false;
    if (m < ((1 << cond[j].lo) >> 1))
      ctx[j] = 0;
    else if (m > ((1 << cond[j].hi) >> 1))
      ctx[j] = 12 + 4 * sign;
    else
      ctx[j] = 4 + 4 * sign;
    diff = sign ? -v : v;
    return true;
  }

  // Figure F.20 over coefficients lo..hi of blk (natural order), scaled
  // by 2^Al: false on a bad code
  bool ac_band(int16_t* blk, int j, int lo, int hi) {
    uint8_t* st = ac_stats[cond[j].ac];
    for (int k = lo; k <= hi; ++k) {
      int i = 3 * (k - 1);
      if (src.decode(st + i)) break;  // EOB
      while (!src.decode(st + i + 1)) {
        i += 3;
        if (++k > hi) return false;
      }
      const int sign = src.decode(&fixed);
      int m = 0;
      const int v = magnitude(st, i + 2, k <= cond[j].kx ? 189 : 217, m);
      if (!v) return false;
      blk[kZigzag[k]] = static_cast<int16_t>(static_cast<uint32_t>(sign ? -v : v) << al);
    }
    return true;
  }

  // Figure G.10's decoding: false on a bad code
  bool ac_refine(int16_t* blk, int j) {
    uint8_t* st = ac_stats[cond[j].ac];
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    while (kex > 0 && !blk[kZigzag[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      int i = 3 * (k - 1);
      if (k > kex && src.decode(st + i)) break;  // EOB
      for (;;) {
        int16_t& v = blk[kZigzag[k]];
        if (v) {
          if (src.decode(st + i + 2)) v = static_cast<int16_t>(v + (v < 0 ? m1 : p1));
          break;
        }
        if (src.decode(st + i + 1)) {
          v = static_cast<int16_t>(src.decode(&fixed) ? m1 : p1);
          break;
        }
        i += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // one block of scan component j: false on a bad code (the block keeps
  // what was decoded of it)
  bool block(const Comp& c, int j, long long b) {
    if (!progressive) {
      int16_t out[64];
      std::memset(out, 0, sizeof(out));
      int diff = 0;
      if (!dc_diff(j, diff)) return false;
      last[j] = (last[j] + diff) & 0xFFFF;
      out[0] = static_cast<int16_t>(last[j]);
      const bool ok = ac_band(out, j, 1, 63);
      pack_block(out, c.keep, c.k, c.coef + b * c.k);
      return ok;
    }
    int16_t* blk = c.coef + b * 64;
    if (dc_refine) {
      if (src.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      return true;
    }
    if (dc_first) {
      int diff = 0;
      if (!dc_diff(j, diff)) return false;
      last[j] = (last[j] + diff) & 0xFFFF;
      blk[0] = static_cast<int16_t>(static_cast<uint32_t>(last[j]) << al);
      return true;
    }
    return ac_first ? ac_band(blk, j, ss, se) : ac_refine(blk, j);
  }

  void run(bool single, int mcux, long long total, long long restart) {
    reset();
    RestartWalk walk{src.data, src.n, src.pos};
    for (long long unit = 0; unit < total; ++unit) {
      if (unit && restart && unit % restart == 0) {
        long long start;
        walk.boundary(&start);
        src = ArithSource{src.data, src.n, start};
        reset();
      }
      if (src.ct == -1 && !dc_refine) continue;
      bool ok = true;
      for (int j = 0; j < ns && ok; ++j) {
        const Comp& c = comps[j];
        const int nblk = single ? 1 : c.h * c.v;
        for (int b = 0; b < nblk && ok; ++b)
          ok = block(c, j, block_of(c, single, mcux, unit, b));
      }
      if (!ok) src.ct = -1;
    }
  }
};

// jcarith.c's QM encoder (arith_encode, finish_pass, emit_restart's byte
// handling) into out[0..cap): the fixture tool's (tools/jpeg_fixtures.py
// arith_recode), which no decode path calls
struct ArithSink {
  uint8_t* out;
  long long cap, len = 0;
  long long c = 0, a = 0x10000, sc = 0, zc = 0;
  int ct = 11, buffer = -1;

  void emit(int b) {
    if (len < cap) out[len] = static_cast<uint8_t>(b);
    ++len;
  }
  void zeros() {
    for (; zc; --zc) emit(0x00);
  }
  // the pending byte and the stacked 0xFF bytes, with a carry into them
  void carry() {
    if (buffer >= 0) {
      zeros();
      emit(buffer + 1);
      if (buffer + 1 == 0xFF) emit(0x00);
    }
    zc += sc;  // the carry turns the stacked 0xFF bytes into 0x00
    sc = 0;
  }
  // the pending byte and the stacked 0xFF bytes, which no carry reaches
  void flush() {
    if (buffer == 0) {
      ++zc;
    } else if (buffer >= 0) {
      zeros();
      emit(buffer);
    }
    if (sc) {
      zeros();
      for (; sc; --sc) {
        emit(0xFF);
        emit(0x00);
      }
    }
  }

  void encode(uint8_t* st, int val) {
    const int sv = *st;
    const uint32_t e = kAritab[sv & 0x7F];
    const long long qe = e >> 16;
    a -= qe;
    if (val != (sv >> 7)) {  // the LPS
      if (a >= qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ (e & 0xFF));
    } else {  // the MPS
      if (a >= 0x8000) return;
      if (a < qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ ((e >> 8) & 0xFF));
    }
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) {
        const long long temp = c >> 19;
        if (temp > 0xFF) {
          carry();
          buffer = static_cast<int>(temp & 0xFF);
        } else if (temp == 0xFF) {
          ++sc;
        } else {
          flush();
          buffer = static_cast<int>(temp & 0xFF);
        }
        c &= 0x7FFFF;
        ct += 8;
      }
    } while (a < 0x8000);
  }

  // finish_pass: the value in the interval with the most trailing zeros
  void finish() {
    const long long temp = (a - 1 + c) & 0xFFFF0000LL;
    c = temp < c ? temp + 0x8000 : temp;
    c <<= ct;
    if (c & 0xF8000000LL)
      carry();
    else
      flush();
    if (c & 0x7FFF800LL) {
      zeros();
      emit(static_cast<int>((c >> 19) & 0xFF));
      if (((c >> 19) & 0xFF) == 0xFF) emit(0x00);
      if (c & 0x7F800LL) {
        emit(static_cast<int>((c >> 11) & 0xFF));
        if (((c >> 11) & 0xFF) == 0xFF) emit(0x00);
      }
    }
  }

  void reset() {
    c = sc = zc = 0;
    a = 0x10000;
    ct = 11;
    buffer = -1;
  }
};

// jcarith.c encode_mcu and, in a progressive frame, encode_mcu_DC_first /
// _DC_refine / _AC_first / _AC_refine over one scan of full 64-coefficient
// blocks: ArithScan's decode run backwards
struct ArithEncoder {
  ArithSink sink;
  const Comp* comps;
  const ArithCond* cond;
  int ns, ss, se, ah, al;
  bool progressive, dc_first, dc_refine, ac, ac_first;
  uint8_t dc_stats[kArithTables][kDcBins];
  uint8_t ac_stats[kArithTables][kAcBins];
  uint8_t fixed = kFixedState;
  int last[4] = {0, 0, 0, 0};
  int ctx[4] = {0, 0, 0, 0};

  void reset() {
    for (int j = 0; j < ns; ++j) {
      if (dc_first) {
        std::memset(dc_stats[cond[j].dc], 0, kDcBins);
        last[j] = ctx[j] = 0;
      }
      if (ac) std::memset(ac_stats[cond[j].ac], 0, kAcBins);
    }
  }

  // Figures F.8 and F.9 for |v| - 1 = v1 from the category's first bin
  // st[i] (DC: X1 = 20 on, x2 < 0; AC: st[i] again, then x2 on); returns
  // the category's top bit m
  int magnitude(uint8_t* st, int i, int v1, int x2) {
    int m = 0;
    if (v1) {
      sink.encode(st + i, 1);
      m = 1;
      int v2 = v1;
      if (x2 < 0) {
        i = 20;
        while (v2 >>= 1) {
          sink.encode(st + i, 1);
          m <<= 1;
          ++i;
        }
      } else if (v2 >>= 1) {
        sink.encode(st + i, 1);
        m <<= 1;
        i = x2;
        while (v2 >>= 1) {
          sink.encode(st + i, 1);
          m <<= 1;
          ++i;
        }
      }
    }
    sink.encode(st + i, 0);
    const int top = m;
    i += 14;
    while (m >>= 1) sink.encode(st + i, (m & v1) ? 1 : 0);
    return top;
  }

  // Figure F.4: the DC value dc (after the point transform)
  void dc_value(int j, int dc) {
    uint8_t* st = dc_stats[cond[j].dc];
    const int s0 = ctx[j];
    int v = dc - last[j];
    if (v == 0) {
      sink.encode(st + s0, 0);
      ctx[j] = 0;
      return;
    }
    last[j] = dc;
    sink.encode(st + s0, 1);
    const int sign = v < 0;
    sink.encode(st + s0 + 1, sign);
    ctx[j] = sign ? 8 : 4;
    if (sign) v = -v;
    const int m = magnitude(st, s0 + 2 + sign, v - 1, -1);
    if (m < ((1 << cond[j].lo) >> 1))
      ctx[j] = 0;
    else if (m > ((1 << cond[j].hi) >> 1))
      ctx[j] += 8;
  }

  // |coefficient| >> al with its sign, rounding towards zero
  int point(int v, int shift) const {
    return v >= 0 ? v >> shift : -((-v) >> shift);
  }

  // Figure F.5 over coefficients lo..hi (point-transformed by al)
  void ac_band(const int16_t* blk, int j, int lo, int hi) {
    uint8_t* st = ac_stats[cond[j].ac];
    int ke = hi;
    while (ke > 0 && !point(blk[kZigzag[ke]], al)) --ke;
    int k = lo;
    for (; k <= ke; ++k) {
      int i = 3 * (k - 1);
      sink.encode(st + i, 0);
      int v;
      while ((v = point(blk[kZigzag[k]], al)) == 0) {
        sink.encode(st + i + 1, 0);
        i += 3;
        ++k;
      }
      sink.encode(st + i + 1, 1);
      sink.encode(&fixed, v < 0);
      if (v < 0) v = -v;
      magnitude(st, i + 2, v - 1, k <= cond[j].kx ? 189 : 217);
    }
    if (k <= hi) sink.encode(st + 3 * (k - 1), 1);  // EOB
  }

  // Figure G.10
  void ac_refine(const int16_t* blk, int j) {
    uint8_t* st = ac_stats[cond[j].ac];
    int ke = se;
    while (ke > 0 && !point(blk[kZigzag[ke]], al)) --ke;
    int kex = ke;
    while (kex > 0 && !point(blk[kZigzag[kex]], al + 1)) --kex;
    int k = ss;
    for (; k <= ke; ++k) {
      int i = 3 * (k - 1);
      if (k > kex) sink.encode(st + i, 0);
      for (;;) {
        const int v = point(blk[kZigzag[k]], al);
        if (v) {
          const int mag = v < 0 ? -v : v;
          if (mag >> 1) {
            sink.encode(st + i + 2, mag & 1);
          } else {
            sink.encode(st + i + 1, 1);
            sink.encode(&fixed, v < 0);
          }
          break;
        }
        sink.encode(st + i + 1, 0);
        i += 3;
        ++k;
      }
    }
    if (k <= se) sink.encode(st + 3 * (k - 1), 1);  // EOB
  }

  void block(const Comp& c, int j, long long b) {
    const int16_t* blk = c.coef + b * 64;
    if (dc_refine) {
      sink.encode(&fixed, (blk[0] >> al) & 1);
    } else if (dc_first) {
      dc_value(j, blk[0] >> al);
      if (!progressive) ac_band(blk, j, 1, 63);
    } else if (ac_first) {
      ac_band(blk, j, ss, se);
    } else {
      ac_refine(blk, j);
    }
  }

  void run(bool single, int mcux, long long total, long long restart) {
    reset();
    long long togo = restart;
    int next = 0;
    for (long long unit = 0; unit < total; ++unit) {
      if (restart) {
        if (togo == 0) {
          sink.finish();
          sink.emit(0xFF);
          sink.emit(0xD0 + next);
          next = (next + 1) & 7;
          sink.reset();
          reset();
          togo = restart;
        }
        --togo;
      }
      for (int j = 0; j < ns; ++j) {
        const Comp& c = comps[j];
        const int nblk = single ? 1 : c.h * c.v;
        for (int b = 0; b < nblk; ++b) block(c, j, block_of(c, single, mcux, unit, b));
      }
    }
    sink.finish();
  }
};

struct Work {
  const uint8_t* const* blobs;
  const long long* lens;
  const long long* scans;
  const long long* photo_scans;
  const long long* photo_info;
  const uint8_t* tables;
  int n_tables;
  int16_t* coef;
  int* status;
};

struct Scratch {
  std::vector<uint16_t> luts = std::vector<uint16_t>(8 * kLut);
  std::vector<int32_t> fasts = std::vector<int32_t>(4 << kFast);
  std::vector<uint8_t> seg;
  std::vector<int16_t> full;     // a progressive photo's 64-coefficient blocks
  std::vector<int16_t> dcs;
  ArithScan arith;
};

int decode_photo(const Work& w, int p, Scratch& sc) {
  const uint8_t* data = w.blobs[p];
  const long long n = w.lens[p];
  const long long* pi = w.photo_info + static_cast<long long>(p) * kPhotoFields;
  const bool progressive = pi[kPiProgressive] != 0;
  long long full_off[4] = {0, 0, 0, 0};
  if (progressive) {
    long long total = 0;
    for (int k = 0; k < pi[kPiComps]; ++k) {
      const long long* f = pi + kPiSlots + k * kPiFields;
      full_off[k] = total;
      total += f[kPiBw] * f[kPiBh] * 64;
    }
    sc.full.assign(static_cast<size_t>(total), 0);
  }
  long long last_good = pi[kPiRows];
  std::vector<long long> zeroed;
  for (long long si = w.photo_scans[p]; si < w.photo_scans[p + 1]; ++si) {
    const long long* d = w.scans + si * kScanFields;
    const int ns = static_cast<int>(d[kNs]);
    if (ns < 1 || ns > 4 || d[kStart] < 0 || d[kEnd] > n ||
        d[kStart] > d[kEnd] || (d[kProgressive] != 0) != progressive)
      return kBadLayout;
    const bool arith = d[kArith] != 0;
    Comp comps[4];
    ArithCond cond[4];
    for (int j = 0; j < ns; ++j) {
      const long long* f = d + kSlots + j * kSlotFields;
      const int pi_ = pack_index(static_cast<int>(f[kScale]));
      if (pi_ < 0 || f[kComp] < 0 || f[kComp] >= 4 ||
          (!arith && (f[kDcTab] < 0 || f[kDcTab] >= w.n_tables ||
                      f[kAcTab] < 0 || f[kAcTab] >= w.n_tables)))
        return kBadLayout;
      Comp& c = comps[j];
      c.h = static_cast<int>(f[kH]);
      c.v = static_cast<int>(f[kV]);
      c.bw = static_cast<int>(f[kBw]);
      c.cols = ((d[kWidth] * f[kH] + d[kHmax] - 1) / d[kHmax] + 7) / 8;
      if (arith) cond[j] = arith_cond(f);
      uint16_t* dc = sc.luts.data() + (2 * j) * kLut;
      uint16_t* ac = sc.luts.data() + (2 * j + 1) * kLut;
      if (!arith && (!build_lut(w.tables + f[kDcTab] * kTableBytes, dc) ||
                     !build_lut(w.tables + f[kAcTab] * kTableBytes, ac)))
        return kBadTable;
      c.dc = dc;
      c.ac = ac;
      int32_t* fast = sc.fasts.data() + j * (1 << kFast);
      if (!arith) build_fast_ac(ac, fast);
      c.fast_ac = fast;
      if (progressive) {
        c.coef = sc.full.data() + full_off[f[kComp]];
        c.keep = kKeep.idx[3];
        c.k = 64;
        continue;
      }
      c.coef = w.coef + f[kCoefOff];
      c.keep = kKeep.idx[pi_];
      c.k = packed_size(static_cast<int>(f[kScale]));
      bool done = false;
      for (long long z : zeroed) done |= z == f[kCoefOff];
      if (!done) {
        std::memset(c.coef, 0, sizeof(int16_t) * f[kBw] * f[kBh] * c.k);
        zeroed.push_back(f[kCoefOff]);
      }
    }
    // decode.py _scan_units / _decode_scan: the units of the scan
    const long long width = d[kWidth], height = d[kHeight];
    const long long hmax = d[kHmax], vmax = d[kVmax];
    const bool single = ns == 1;
    long long total, mcux = 0, per_row;
    if (single) {
      const long long rows = ((height * d[kSlots + kV] + vmax - 1) / vmax + 7) / 8;
      total = comps[0].cols * rows;
      per_row = comps[0].cols * comps[0].v;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      total = mcux * ((height + 8 * vmax - 1) / (8 * vmax));
      per_row = mcux;
    }
    if (arith) {
      // jdarith.c never runs short of data: smoothing takes every row
      ArithScan& as = sc.arith;
      as.src = ArithSource{data, n, d[kStart]};
      as.comps = comps;
      as.cond = cond;
      as.ns = ns;
      as.ss = static_cast<int>(d[kSs]);
      as.se = static_cast<int>(d[kSe]);
      as.al = static_cast<int>(d[kAl]);
      as.progressive = progressive;
      as.dc_first = !progressive || (d[kSs] == 0 && d[kAh] == 0);
      as.dc_refine = progressive && d[kSs] == 0 && d[kAh] != 0;
      as.ac = !progressive || d[kSs] != 0;
      as.ac_first = d[kAh] == 0;
      as.run(single, static_cast<int>(mcux), total, d[kRestart]);
      last_good = pi[kPiRows];
      continue;
    }
    // decode.py _decode_scan over _restart_walk's intervals
    const long long per = d[kRestart] ? d[kRestart] : total;
    if (sc.seg.size() < static_cast<size_t>(n - d[kStart]) + kPad)
      sc.seg.resize(static_cast<size_t>(n - d[kStart]) + kPad);
    RestartWalk walk{data, n, d[kStart]};
    long long first_bad = -1;
    bool short_data = false;
    for (long long done = 0; done < total; done += per) {
      long long start = d[kStart];
      if (done && walk.boundary(&start)) short_data = false;
      const size_t len = start < 0 ? 0 : unstuff(data, n, start, sc.seg.data());
      std::memset(sc.seg.data() + len, 0, kPad);
      const long long k = per < total - done ? per : total - done;
      if (!short_data) {
        const long long bad =
            progressive
                ? decode_progressive_segment(
                      sc.seg.data(), len, comps, ns, single,
                      static_cast<int>(mcux), done, k,
                      static_cast<int>(d[kSs]), static_cast<int>(d[kSe]),
                      static_cast<int>(d[kAh]), static_cast<int>(d[kAl]))
                : decode_segment(sc.seg.data(), len, comps, ns, single,
                                 static_cast<int>(mcux), done, k);
        if (bad >= 0) {
          short_data = true;
          if (first_bad < 0) first_bad = (done + bad) / per_row;
        }
      }
    }
    last_good = first_bad < 0 ? pi[kPiRows] : first_bad;
  }
  if (!progressive) return kOk;
  // smoothing, then the blocks packed as the sequential path writes them
  for (int k = 0; k < pi[kPiComps]; ++k) {
    const long long* f = pi + kPiSlots + k * kPiFields;
    int16_t* full = sc.full.data() + full_off[k];
    if (pi[kPiRule])
      smooth_component(full, f, pi[kPiRows], static_cast<int>(pi[kPiRule]),
                       last_good, sc.dcs);
    const int pk = pack_index(static_cast<int>(f[kPiScale]));
    if (pk < 0) return kBadLayout;
    const int kk = packed_size(static_cast<int>(f[kPiScale]));
    const int8_t* keep = kKeep.idx[pk];
    int16_t* dst = w.coef + f[kPiCoefOff];
    const long long nb = f[kPiBw] * f[kPiBh];
    for (long long b = 0; b < nb; ++b) pack_block(full + b * 64, keep, kk, dst + b * kk);
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decode the scans of n_photos JPEGs on up to n_threads threads, one photo
// a thread.  blobs[p] (lens[p] bytes) is photo p's file; its scans are
// scans[photo_scans[p] .. photo_scans[p + 1]) (kScanFields int64 each), its
// descriptor photo_info[p] (kPhotoFields int64); tables holds n_tables
// Huffman specs of kTableBytes; coefficients land at coef + each slot's
// offset.  status[p] gets 0 or an error code.  Returns 0, or -1 when a
// thread could not be started.
int aihab_jpeg_entropy(const uint8_t* const* blobs, const long long* lens,
                       const long long* scans, const long long* photo_scans,
                       const long long* photo_info, int n_photos,
                       const uint8_t* tables, int n_tables, int16_t* coef,
                       int* status, int n_threads) {
  Work w{blobs, lens, scans, photo_scans, photo_info, tables, n_tables, coef,
         status};
  std::atomic<int> next(0);
  auto worker = [&]() {
    Scratch sc;
    for (int p = next++; p < n_photos; p = next++)
      w.status[p] = decode_photo(w, p, sc);
  };
  const int n = n_threads < 1 ? 1 : (n_threads < n_photos ? n_threads
                                                          : n_photos);
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < n; ++t) pool.emplace_back(worker);
  } catch (...) {
    for (auto& t : pool) t.join();
    return -1;
  }
  worker();
  for (auto& t : pool) t.join();
  return 0;
}

// Arithmetic-code one scan (descriptor `scan`, kScanFields int64: its
// slots' kCoefOff into coef, full 64-coefficient blocks in natural order,
// and its statistics tables and conditioning as the decoder reads them)
// into out[0..cap), RSTn markers included: the byte count, or -1 when the
// scan does not fit in cap bytes.  The fixture tool's encoder (jcarith.c).
long long aihab_jpeg_arith_encode(const int16_t* coef, const long long* scan,
                                  uint8_t* out, long long cap) {
  const long long* d = scan;
  const int ns = static_cast<int>(d[kNs]);
  if (ns < 1 || ns > 4) return -1;
  Comp comps[4];
  ArithCond cond[4];
  for (int j = 0; j < ns; ++j) {
    const long long* f = d + kSlots + j * kSlotFields;
    Comp& c = comps[j];
    c.coef = const_cast<int16_t*>(coef) + f[kCoefOff];
    c.h = static_cast<int>(f[kH]);
    c.v = static_cast<int>(f[kV]);
    c.bw = static_cast<int>(f[kBw]);
    c.cols = ((d[kWidth] * f[kH] + d[kHmax] - 1) / d[kHmax] + 7) / 8;
    cond[j] = arith_cond(f);
  }
  const bool progressive = d[kProgressive] != 0, single = ns == 1;
  long long total, mcux = 0;
  if (single) {
    total = comps[0].cols * (((d[kHeight] * d[kSlots + kV] + d[kVmax] - 1) / d[kVmax] + 7) / 8);
  } else {
    mcux = (d[kWidth] + 8 * d[kHmax] - 1) / (8 * d[kHmax]);
    total = mcux * ((d[kHeight] + 8 * d[kVmax] - 1) / (8 * d[kVmax]));
  }
  ArithEncoder enc;
  enc.sink.out = out;
  enc.sink.cap = cap;
  enc.comps = comps;
  enc.cond = cond;
  enc.ns = ns;
  enc.ss = static_cast<int>(d[kSs]);
  enc.se = static_cast<int>(d[kSe]);
  enc.ah = static_cast<int>(d[kAh]);
  enc.al = static_cast<int>(d[kAl]);
  enc.progressive = progressive;
  enc.dc_first = !progressive || (d[kSs] == 0 && d[kAh] == 0);
  enc.dc_refine = progressive && d[kSs] == 0 && d[kAh] != 0;
  enc.ac = !progressive || d[kSs] != 0;
  enc.ac_first = d[kAh] == 0;
  enc.run(single, static_cast<int>(mcux), total, d[kRestart]);
  return enc.sink.len <= cap ? enc.sink.len : -1;
}

// the packed coefficient count of the IDCT of size s (ops/jpeg.py checks
// its own table against it)
int aihab_jpeg_packed_size(int s) { return pack_index(s) < 0 ? -1 : packed_size(s); }

}  // extern "C"
