// The LZ4 block format and blosc1 frames, on the host: the codec of the JAX
// package's zarr cache store (cache/array_store.py TensorStoreStore, whose
// tensorstore spec asks for compressor blosc, cname lz4, clevel 5,
// shuffle -1: the byte shuffle for items wider than a byte, the bit shuffle
// for bytes).  The card's machine has no blosc or lz4 binding, so the port
// carries its own, beside its zstd decoder (zstd_decode.cpp).
//
// A blosc1 frame: a 16-byte header (version 2, LZ4 format version 1,
// flags, typesize, nbytes, blocksize, cbytes; all little-endian), then
// either the data itself (flag 0x2, memcpyed) or a table of each block's
// offset and the blocks.  A block is typesize streams (split, unless flag
// 0x10 says not to, the item is at most 16 bytes, the block holds at least
// 128 items and it is not the short last block) or one; each stream an
// int32 size and its LZ4 block, or the stream's bytes as they are when the
// size equals them.  The shuffle runs within each block: flag 0x1 the byte
// shuffle (items wider than one byte), flag 0x4 the bit shuffle (only when
// the block's item count is a multiple of 8; otherwise the block is left as
// it is), as c-blosc does.
//
// The writer emits blocks of 256 KiB (a multiple of 8 items), each one
// stream (flag 0x10) compressed by a greedy LZ4 encoder (a 4-byte hash of
// each position tried, the last match found, LZ4's growing step over data
// that finds no match), or stored when that does not
// shrink it; a frame that would not shrink is memcpyed.  Its bytes are not
// c-blosc's, but c-blosc and tensorstore decode them to the same array.
// Blocks run on threads of their own.
//
// ops/blosc.py holds the same codec in Python for the tests.  Build: c++
// -O2 -std=c++17 -shared -fPIC -pthread (ops/_build.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline void put32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }

// ---- LZ4 ------------------------------------------------------------------

// Decodes one LZ4 block into exactly n_out bytes; false on malformed input.
bool lz4_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t n_out) {
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + n_out;
  if (n == 0) return n_out == 0;
  for (;;) {
    if (ip >= end) return false;
    unsigned token = *ip++;
    size_t ll = token >> 4;
    if (ll == 15) {
      unsigned b;
      do {
        if (ip >= end) return false;
        b = *ip++;
        ll += b;
      } while (b == 255);
    }
    if ((size_t)(end - ip) < ll || (size_t)(oend - op) < ll) return false;
    std::memcpy(op, ip, ll);
    ip += ll;
    op += ll;
    if (ip == end) break;  // the last sequence has literals only
    if (end - ip < 2) return false;
    size_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || offset > (size_t)(op - dst)) return false;
    size_t ml = token & 15;
    if (ml == 15) {
      unsigned b;
      do {
        if (ip >= end) return false;
        b = *ip++;
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    if ((size_t)(oend - op) < ml) return false;
    const uint8_t* m = op - offset;
    if (offset >= ml) {
      std::memcpy(op, m, ml);
      op += ml;
    } else {
      for (size_t k = 0; k < ml; k++) *op++ = m[k];
    }
  }
  return op == oend;
}

inline uint8_t* put_len(uint8_t* op, size_t len) {
  while (len >= 255) {
    *op++ = 255;
    len -= 255;
  }
  *op++ = (uint8_t)len;
  return op;
}

// Greedy LZ4 encoder; dst needs lz4_bound(n) bytes.  Returns the size.
size_t lz4_bound(size_t n) { return n + n / 255 + 16; }

size_t lz4_encode(const uint8_t* src, size_t n, uint8_t* dst) {
  constexpr int kHashLog = 16;
  std::vector<uint32_t> table(1u << kHashLog, 0);  // position + 1
  uint8_t* op = dst;
  size_t anchor = 0, ip = 0;
  auto emit = [&](size_t lit_end, size_t offset, size_t ml) {
    size_t ll = lit_end - anchor;
    uint8_t* token = op++;
    unsigned t = (unsigned)(ll >= 15 ? 15 : ll) << 4;
    if (ll >= 15) op = put_len(op, ll - 15);
    std::memcpy(op, src + anchor, ll);
    op += ll;
    if (ml) {
      *op++ = (uint8_t)(offset & 255);
      *op++ = (uint8_t)(offset >> 8);
      size_t m = ml - 4;
      t |= m >= 15 ? 15 : (unsigned)m;
      if (m >= 15) op = put_len(op, m - 15);
    }
    *token = (uint8_t)t;
  };
  if (n >= 13) {
    const size_t mflimit = n - 12, mlimit = n - 5;
    size_t misses = 0;  // since the last match: LZ4's skip over data
    while (ip < mflimit) {
      uint32_t seq = le32(src + ip);
      uint32_t h = (seq * 2654435761u) >> (32 - kHashLog);
      size_t ref = table[h];
      table[h] = (uint32_t)(ip + 1);
      if (ref && ip + 1 - ref <= 65535 && le32(src + ref - 1) == seq) {
        size_t r = ref - 1;
        size_t ml = 4;
        while (ip + ml < mlimit && src[r + ml] == src[ip + ml]) ml++;
        emit(ip, ip - r, ml);
        ip += ml;
        anchor = ip;
        misses = 0;
      } else {
        ip += 1 + (misses++ >> 6);  // that does not compress
      }
    }
  }
  emit(n, 0, 0);
  return (size_t)(op - dst);
}

// ---- shuffles -------------------------------------------------------------

void byte_shuffle(const uint8_t* in, uint8_t* out, size_t n, size_t ts) {
  size_t items = n / ts;
  for (size_t j = 0; j < ts; j++)
    for (size_t i = 0; i < items; i++) out[j * items + i] = in[i * ts + j];
  std::memcpy(out + items * ts, in + items * ts, n - items * ts);
}

void byte_unshuffle(const uint8_t* in, uint8_t* out, size_t n, size_t ts) {
  size_t items = n / ts;
  for (size_t j = 0; j < ts; j++)
    for (size_t i = 0; i < items; i++) out[i * ts + j] = in[j * items + i];
  std::memcpy(out + items * ts, in + items * ts, n - items * ts);
}

// bitshuffle's layout: row (byte j of the item, bit k) holds bit k of byte j
// of each item, 8 items a byte, the first item in bit 0.
void bit_shuffle(const uint8_t* in, uint8_t* out, size_t n, size_t ts) {
  size_t items = n / ts;
  if (items % 8) {
    std::memcpy(out, in, n);
    return;
  }
  size_t row = items / 8;
  std::memset(out, 0, items * ts);
  for (size_t i = 0; i < items; i++)
    for (size_t j = 0; j < ts; j++) {
      uint8_t b = in[i * ts + j];
      for (int k = 0; k < 8; k++)
        out[(j * 8 + k) * row + i / 8] |= ((b >> k) & 1) << (i % 8);
    }
  std::memcpy(out + items * ts, in + items * ts, n - items * ts);
}

void bit_unshuffle(const uint8_t* in, uint8_t* out, size_t n, size_t ts) {
  size_t items = n / ts;
  if (items % 8) {
    std::memcpy(out, in, n);
    return;
  }
  size_t row = items / 8;
  std::memset(out, 0, items * ts);
  for (size_t i = 0; i < items; i++)
    for (size_t j = 0; j < ts; j++) {
      uint8_t b = 0;
      for (int k = 0; k < 8; k++)
        b |= ((in[(j * 8 + k) * row + i / 8] >> (i % 8)) & 1) << k;
      out[i * ts + j] = b;
    }
  std::memcpy(out + items * ts, in + items * ts, n - items * ts);
}

// ---- blosc1 frames --------------------------------------------------------

constexpr int kHeader = 16;

template <typename F>
void parallel_blocks(size_t nblocks, int threads, F&& f) {
  threads = std::max(1, std::min<int>(threads, (int)nblocks));
  if (threads == 1) {
    for (size_t b = 0; b < nblocks; b++) f(b);
    return;
  }
  std::atomic<size_t> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++)
    pool.emplace_back([&] {
      for (size_t b; (b = next.fetch_add(1)) < nblocks;) f(b);
    });
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Decodes a blosc1 frame of n bytes into dst (dst_len bytes: the header's
// nbytes).  Returns 0, or a code: 1 bad header, 2 wrong size, 3 unsupported
// codec, 4 bad block table, 5 corrupt stream.
int aihab_blosc_decompress(const uint8_t* src, long long n, uint8_t* dst,
                           long long dst_len, int threads) {
  if (n < kHeader) return 1;
  int version = src[0], flags = src[2], ts = src[3];
  (void)version;
  uint32_t nbytes = le32(src + 4), blocksize = le32(src + 8),
           cbytes = le32(src + 12);
  if ((long long)nbytes != dst_len) return 2;
  if (cbytes > (uint64_t)n || ts < 1) return 1;
  if (flags & 0x2) {  // memcpyed
    if ((uint64_t)kHeader + nbytes > cbytes) return 1;
    std::memcpy(dst, src + kHeader, nbytes);
    return 0;
  }
  if (nbytes == 0) return 0;
  if ((flags >> 5) != 1) return 3;  // only the LZ4 format
  if (blocksize == 0 || (flags & 0x8)) return 1;
  size_t nblocks = (nbytes + blocksize - 1) / blocksize;
  if ((uint64_t)kHeader + 4 * nblocks > cbytes) return 4;
  bool dont_split = flags & 0x10;
  std::atomic<int> status{0};
  parallel_blocks(nblocks, threads, [&](size_t b) {
    size_t bsize = std::min<size_t>(blocksize, nbytes - b * blocksize);
    bool leftover = bsize < blocksize;
    size_t start = le32(src + kHeader + 4 * b);
    int nsplit = (!dont_split && ts <= 16 && blocksize / ts >= 128 && !leftover)
                     ? ts
                     : 1;
    size_t neblock = bsize / nsplit;
    std::vector<uint8_t> tmp(bsize);
    bool shuffled = (flags & 0x1) ? ts > 1 : (flags & 0x4) != 0;
    uint8_t* target = shuffled ? tmp.data() : dst + b * blocksize;
    size_t at = start;
    for (int s = 0; s < nsplit; s++) {
      if (at + 4 > cbytes) {
        status = 5;
        return;
      }
      uint32_t cs = le32(src + at);
      at += 4;
      if (at + cs > cbytes || cs > neblock) {
        status = 5;
        return;
      }
      if (cs == neblock) {
        std::memcpy(target + s * neblock, src + at, neblock);
      } else if (!lz4_decode(src + at, cs, target + s * neblock, neblock)) {
        status = 5;
        return;
      }
      at += cs;
    }
    if (flags & 0x1) {
      if (ts > 1) byte_unshuffle(tmp.data(), dst + b * blocksize, bsize, ts);
    } else if (flags & 0x4) {
      bit_unshuffle(tmp.data(), dst + b * blocksize, bsize, ts);
    }
  });
  return status;
}

// Encodes n bytes of items of ts bytes as a blosc1 frame (LZ4, shuffle -1's
// pick); writes at most 16 + n + 8 * (n / 8192 + 1) bytes (each block of at
// least 8 KiB costs 8 bytes of table and size, a block that does not
// shrink is stored), the size to *out_len.
int aihab_blosc_compress(const uint8_t* src, long long n, int ts, uint8_t* dst,
                         long long* out_len, int threads) {
  const size_t kBlock = 1 << 18;
  if (ts < 1 || ts > 255 || n < 0 || n > 0x7FFFFFF0LL) return 1;
  size_t block = std::max<size_t>(kBlock - kBlock % (8 * ts), 8 * ts);
  size_t nbytes = (size_t)n;
  if (nbytes < block) block = nbytes ? nbytes : 1;
  int flags = 0x20 | 0x10 | (ts > 1 ? 0x1 : 0x4);
  dst[0] = 2;
  dst[1] = 1;
  dst[3] = (uint8_t)ts;
  put32(dst + 4, (uint32_t)nbytes);
  put32(dst + 8, (uint32_t)block);
  auto memcpyed = [&] {
    dst[2] = (uint8_t)(flags | 0x2);
    std::memcpy(dst + kHeader, src, nbytes);
    put32(dst + 12, (uint32_t)(kHeader + nbytes));
    *out_len = kHeader + nbytes;
    return 0;
  };
  if (nbytes == 0) return memcpyed();
  size_t nblocks = (nbytes + block - 1) / block;
  std::vector<std::vector<uint8_t>> outs(nblocks);
  parallel_blocks(nblocks, threads, [&](size_t b) {
    size_t bsize = std::min(block, nbytes - b * block);
    std::vector<uint8_t> sh(bsize);
    if (ts > 1)
      byte_shuffle(src + b * block, sh.data(), bsize, ts);
    else
      bit_shuffle(src + b * block, sh.data(), bsize, ts);
    std::vector<uint8_t>& o = outs[b];
    o.resize(4 + lz4_bound(bsize));
    size_t cs = lz4_encode(sh.data(), bsize, o.data() + 4);
    if (cs >= bsize) {
      std::memcpy(o.data() + 4, sh.data(), bsize);
      cs = bsize;
    }
    put32(o.data(), (uint32_t)cs);
    o.resize(4 + cs);
  });
  size_t total = kHeader + 4 * nblocks;
  for (auto& o : outs) total += o.size();
  if (total >= kHeader + nbytes) return memcpyed();
  dst[2] = (uint8_t)flags;
  size_t at = kHeader + 4 * nblocks;
  for (size_t b = 0; b < nblocks; b++) {
    put32(dst + kHeader + 4 * b, (uint32_t)at);
    std::memcpy(dst + at, outs[b].data(), outs[b].size());
    at += outs[b].size();
  }
  put32(dst + 12, (uint32_t)at);
  *out_len = (long long)at;
  return 0;
}

// One LZ4 block: decode into exactly dst_len bytes (0, or 1 if malformed).
int aihab_lz4_decompress(const uint8_t* src, long long n, uint8_t* dst,
                         long long dst_len) {
  return lz4_decode(src, (size_t)n, dst, (size_t)dst_len) ? 0 : 1;
}

// One LZ4 block: encode (dst holds n + n / 255 + 16 bytes).
int aihab_lz4_compress(const uint8_t* src, long long n, uint8_t* dst,
                       long long* out_len) {
  *out_len = (long long)lz4_encode(src, (size_t)n, dst);
  return 0;
}

}  // extern "C"
