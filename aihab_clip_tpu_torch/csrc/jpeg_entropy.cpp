// The entropy-coded part of baseline JPEGs (SOF0/SOF1, 8-bit, Huffman), on
// the host, one photo per thread: the fast decode's first stage
// (ops/jpeg.py).  The JAX package decodes with libjpeg on the host
// (native/image_pipeline.cpp); this file replaces its Huffman decoding, and
// csrc/jpeg_pixels.cu (J1, J2) everything after it.
//
// The markers are parsed in Python (data/decode.py parse_jpeg), which hands
// over, per scan, where its bytes lie, its tables and its MCU layout.  Each
// scan is unstuffed and split at its RSTn markers, and each restart segment
// decoded with the per-component DC predictors reset, exactly as
// data/decode.py's pure-Python reference does (_scan_segments,
// _decode_segment): the same 16-bit lookup, the same zero padding past a
// segment's end, the same truncation test at the start of each block, so
// the coefficients and the errors are the reference's.
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
// columns other than 4, 49; s = 2: rows and columns 0, 1, 3, 5, 7, 25;
// s = 1: the DC), block after block, so that the upload to the card
// carries nothing the IDCT does not read.  A value past int16 (only a
// corrupt file's DC predictor gets there) wraps, as libjpeg's JCOEF does.
//
// Build: c++ -O2 -std=c++17 -shared -fPIC -pthread (ops/_build.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kFast = 9;        // bits of the first-level Huffman lookup
constexpr int kLut = 65536 + (1 << kFast);

// status codes (ops/jpeg.py maps them to data/decode.py's messages)
enum {
  kOk = 0,
  kTruncated = 1,
  kBadDc = 2,
  kBadAc = 3,
  kBadTable = 4,
  kBadLayout = 5,
};

// one scan descriptor: int64 fields
enum {
  kPhoto = 0, kStart, kEnd, kRestart, kWidth, kHeight, kHmax, kVmax, kNs,
  kSlots,  // then 4 slots of kSlotFields
};
enum { kH = 0, kV, kBw, kBh, kCoefOff, kScale, kDcTab, kAcTab, kSlotFields };
constexpr int kScanFields = kSlots + 4 * kSlotFields;
constexpr int kTableBytes = 16 + 256;  // counts, then up to 256 symbols
constexpr size_t kPad = 256 + 8;       // decode.py's zero pad + one peek

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

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
int packed_size(int s) { return s == 1 ? 1 : s == 2 ? 25 : s == 4 ? 49 : 64; }

// decode.py _build_lut: next 16 bits -> (code length << 8) | symbol, then
// the same for codes of up to kFast bits, by the next kFast bits
bool build_lut(const uint8_t* spec, uint16_t* lut) {
  std::memset(lut, 0, kLut * sizeof(uint16_t));
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
  int k;               // packed coefficients a block
  int h, v, bw;
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

// decode.py _decode_segment: `n_units` MCUs from one restart segment
int decode_segment(const uint8_t* buf, size_t len, const Comp* comps,
                   int ns, bool single, int cols, int mcux, long long first,
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
        long long block;
        if (single) {
          block = (unit / cols) * c.bw + unit % cols;
        } else {
          const long long my = unit / mcux, mx = unit % mcux;
          block = (my * c.v + b / c.h) * c.bw + mx * c.h + b % c.h;
        }
        if (pos > nbits) return kTruncated;
        int16_t* dst = c.coef + block * c.k;
        int16_t out[64];
        std::memset(out, 0, sizeof(out));
        uint64_t w = peek(buf, pos);
        const uint16_t e = lookup(c.dc, w);
        if (!e) return kBadDc;
        int ln = e >> 8, s = e & 0xFF;
        if (s > 16) return kBadDc;
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
            if (k < 64) out[kZigzag[k]] = static_cast<int16_t>(f >> 16);
            ++k;
            continue;
          }
          const uint16_t a = lookup(c.ac, w);
          if (!a) return kBadAc;
          ln = a >> 8;
          const int rs = a & 0xFF;
          s = rs & 15;
          pos += ln;
          if (s) {
            k += rs >> 4;
            const uint32_t v = static_cast<uint32_t>((w << ln) >> (64 - s));
            pos += s;
            if (k < 64) out[kZigzag[k]] = static_cast<int16_t>(extend(v, s));
            ++k;
          } else if (rs == 0xF0) {
            k += 16;
          } else {
            break;
          }
        }
        if (c.k == 64) {
          std::memcpy(dst, out, sizeof(out));
        } else {
          for (int q = 0; q < c.k; ++q) dst[q] = out[c.keep[q]];
        }
      }
    }
  }
  return kOk;
}

struct Work {
  const uint8_t* const* blobs;
  const long long* lens;
  const long long* scans;
  const long long* photo_scans;
  const uint8_t* tables;
  int n_tables;
  int16_t* coef;
  int* status;
};

int decode_photo(const Work& w, int p, std::vector<uint16_t>& luts,
                 std::vector<int32_t>& fasts, std::vector<uint8_t>& seg) {
  const uint8_t* data = w.blobs[p];
  const long long n = w.lens[p];
  std::vector<long long> zeroed;
  for (long long si = w.photo_scans[p]; si < w.photo_scans[p + 1]; ++si) {
    const long long* d = w.scans + si * kScanFields;
    const int ns = static_cast<int>(d[kNs]);
    if (ns < 1 || ns > 4 || d[kStart] < 0 || d[kEnd] > n ||
        d[kStart] > d[kEnd])
      return kBadLayout;
    Comp comps[4];
    for (int j = 0; j < ns; ++j) {
      const long long* f = d + kSlots + j * kSlotFields;
      const int pi = pack_index(static_cast<int>(f[kScale]));
      if (pi < 0 || f[kDcTab] < 0 || f[kDcTab] >= w.n_tables ||
          f[kAcTab] < 0 || f[kAcTab] >= w.n_tables)
        return kBadLayout;
      Comp& c = comps[j];
      c.coef = w.coef + f[kCoefOff];
      c.keep = kKeep.idx[pi];
      c.k = packed_size(static_cast<int>(f[kScale]));
      c.h = static_cast<int>(f[kH]);
      c.v = static_cast<int>(f[kV]);
      c.bw = static_cast<int>(f[kBw]);
      uint16_t* dc = luts.data() + (2 * j) * kLut;
      uint16_t* ac = luts.data() + (2 * j + 1) * kLut;
      if (!build_lut(w.tables + f[kDcTab] * kTableBytes, dc) ||
          !build_lut(w.tables + f[kAcTab] * kTableBytes, ac))
        return kBadTable;
      c.dc = dc;
      c.ac = ac;
      int32_t* fast = fasts.data() + j * (1 << kFast);
      build_fast_ac(ac, fast);
      c.fast_ac = fast;
      bool done = false;
      for (long long z : zeroed) done |= z == f[kCoefOff];
      if (!done) {
        std::memset(c.coef, 0, sizeof(int16_t) * f[kBw] * f[kBh] * c.k);
        zeroed.push_back(f[kCoefOff]);
      }
    }
    // decode.py _decode_scan: the units of the scan
    const long long width = d[kWidth], height = d[kHeight];
    const long long hmax = d[kHmax], vmax = d[kVmax];
    const bool single = ns == 1;
    long long cols = 0, total, mcux = 0;
    if (single) {
      const long long* f = d + kSlots;
      cols = ((width * f[kH] + hmax - 1) / hmax + 7) / 8;
      const long long rows = ((height * f[kV] + vmax - 1) / vmax + 7) / 8;
      total = cols * rows;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      total = mcux * ((height + 8 * vmax - 1) / (8 * vmax));
    }
    const long long per = d[kRestart] ? d[kRestart] : total;
    // decode.py _scan_segments: split at RSTn, unstuff 0xFF00 -> 0xFF
    long long done = 0, i = d[kStart];
    const long long end = d[kEnd];
    if (seg.size() < static_cast<size_t>(end - i) + kPad)
      seg.resize(static_cast<size_t>(end - i) + kPad);
    while (done < total) {
      uint8_t* out = seg.data();
      size_t len = 0;
      bool rst = false;
      while (i < end) {
        const uint8_t b = data[i];
        if (b == 0xFF && i + 1 < n) {
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
      std::memset(out + len, 0, kPad);
      const long long k = per < total - done ? per : total - done;
      const int rc = decode_segment(seg.data(), len, comps, ns, single,
                                    static_cast<int>(cols),
                                    static_cast<int>(mcux), done, k);
      if (rc != kOk) return rc;
      done += k;
      if (!rst) break;  // the scan's last segment
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decode the scans of n_photos JPEGs on up to n_threads threads, one photo
// a thread.  blobs[p] (lens[p] bytes) is photo p's file; its scans are
// scans[photo_scans[p] .. photo_scans[p + 1]) (kScanFields int64 each);
// tables holds n_tables Huffman specs of kTableBytes; coefficients land at
// coef + each slot's offset.  status[p] gets 0 or an error code.  Returns
// 0, or -1 when a thread could not be started.
int aihab_jpeg_entropy(const uint8_t* const* blobs, const long long* lens,
                       const long long* scans, const long long* photo_scans,
                       int n_photos, const uint8_t* tables, int n_tables,
                       int16_t* coef, int* status, int n_threads) {
  Work w{blobs, lens, scans, photo_scans, tables, n_tables, coef, status};
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint16_t> luts(8 * kLut);
    std::vector<int32_t> fasts(4 << kFast);
    std::vector<uint8_t> seg;
    for (int p = next++; p < n_photos; p = next++)
      w.status[p] = decode_photo(w, p, luts, fasts, seg);
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
