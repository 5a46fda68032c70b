// The entropy-coded part of JPEGs (sequential SOF0/SOF1 and progressive
// SOF2, 8-bit, Huffman), on the host, one photo per thread: the fast
// decode's first stage (ops/jpeg.py).  The JAX package decodes with libjpeg
// on the host (native/image_pipeline.cpp); this file replaces its Huffman
// decoding, and csrc/jpeg_pixels.cu (J1, J2) everything after it.
//
// The markers are parsed in Python (data/decode.py parse_jpeg), which hands
// over, per scan, where its bytes lie, its tables, its band and its MCU
// layout.  Each scan is unstuffed and split at its RSTn markers, and each
// restart segment decoded with the per-component DC predictors (and a
// progressive scan's EOB run) reset, exactly as data/decode.py's pure-Python
// reference does (_scan_segments, _decode_segment,
// _decode_progressive_segment): the same 16-bit lookup, the same zero
// padding past a segment's end, so the coefficients are the reference's.
//
// Data that runs out follows libjpeg (jdhuff.c, jdphuff.c): the MCU that
// reads past a segment's data decodes with zero bits, every later MCU is
// left as it is until a restart marker, and a segment missing from the data
// is empty.  Bits that start no code are 17 bits read for symbol 0, as
// jpeg_huff_decode takes them; a run past coefficient 63 writes 63, as
// libjpeg's jpeg_natural_order does.
//
// A sequential photo's coefficients go straight into the caller's buffer.
// A progressive photo's scans accumulate into a full per-photo buffer (all
// 64 a block); where data/decode.py's smoothing_plan says the low
// coefficients are not all known (a cut file), libjpeg's interblock
// smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo 2.1's rows or
// cv2's 3.1's) fills the estimates; then the blocks are packed like a
// sequential photo's.
//
// Huffman decoding is serial within a restart segment, and camera JPEGs
// rarely have restart markers: a photo is one thread's work, and a batch
// runs on a pool of threads.  Called through ctypes, which releases the
// GIL, so request threads and loader threads decode side by side.
//
// The lookups are decode.py's 16-bit table behind a 9-bit one (codes of up
// to 9 bits, nearly all of a photo's), and for AC codes whose value bits
// fit in those 9 bits the value comes ready-made: the same codes, fewer
// dependent steps.  A block decodes into a local 64-entry buffer.
//
// Coefficients are written as int16 in natural order into the caller's
// buffer, only those the chosen IDCT reads (s = 8: all 64; s = 4: rows and
// columns other than 4, 49, and a flag for its zero test, 50; s = 2: rows
// and columns 0, 1, 3, 5, 7, 25; s = 1: the DC), block after block, so
// that the upload to the card carries nothing the IDCT does not read.  A
// value past int16 (only a
// corrupt file's DC predictor gets there) wraps, as libjpeg's JCOEF does.
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
  kSs, kSe, kAh, kAl, kProgressive,
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
    Comp comps[4];
    for (int j = 0; j < ns; ++j) {
      const long long* f = d + kSlots + j * kSlotFields;
      const int pi_ = pack_index(static_cast<int>(f[kScale]));
      if (pi_ < 0 || f[kDcTab] < 0 || f[kDcTab] >= w.n_tables ||
          f[kAcTab] < 0 || f[kAcTab] >= w.n_tables || f[kComp] < 0 ||
          f[kComp] >= 4)
        return kBadLayout;
      Comp& c = comps[j];
      c.h = static_cast<int>(f[kH]);
      c.v = static_cast<int>(f[kV]);
      c.bw = static_cast<int>(f[kBw]);
      c.cols = ((d[kWidth] * f[kH] + d[kHmax] - 1) / d[kHmax] + 7) / 8;
      uint16_t* dc = sc.luts.data() + (2 * j) * kLut;
      uint16_t* ac = sc.luts.data() + (2 * j + 1) * kLut;
      if (!build_lut(w.tables + f[kDcTab] * kTableBytes, dc) ||
          !build_lut(w.tables + f[kAcTab] * kTableBytes, ac))
        return kBadTable;
      c.dc = dc;
      c.ac = ac;
      int32_t* fast = sc.fasts.data() + j * (1 << kFast);
      build_fast_ac(ac, fast);
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
    const long long per = d[kRestart] ? d[kRestart] : total;
    // decode.py _scan_segments: split at RSTn, unstuff 0xFF00 -> 0xFF; a
    // 0xFF cut from its marker is dropped
    long long done = 0, i = d[kStart], first_bad = -1;
    const long long end = d[kEnd];
    if (sc.seg.size() < static_cast<size_t>(end - i) + kPad)
      sc.seg.resize(static_cast<size_t>(end - i) + kPad);
    bool more = true, short_data = false, first_seg = true;
    while (done < total) {
      uint8_t* out = sc.seg.data();
      size_t len = 0;
      if (more) {
        bool rst = false;
        while (i < end) {
          const uint8_t b = data[i];
          if (b == 0xFF) {
            if (i + 1 >= n) {
              ++i;
              break;
            }
            const uint8_t nxt = data[i + 1];
            if (nxt == 0x00) {
              out[len++] = 0xFF;
              i += 2;
              continue;
            }
            if (nxt >= 0xD0 && nxt <= 0xD7) {
              i += 2;
              rst = true;
              break;
            }
          }
          out[len++] = b;
          ++i;
        }
        if (!first_seg) short_data = false;  // a restart marker clears it
        more = rst;
      }
      first_seg = false;
      std::memset(out + len, 0, kPad);
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
      done += k;
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

// the packed coefficient count of the IDCT of size s (ops/jpeg.py checks
// its own table against it)
int aihab_jpeg_packed_size(int s) { return pack_index(s) < 0 ? -1 : packed_size(s); }

}  // extern "C"
