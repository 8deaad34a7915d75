// LZ4 block-format codec (compress + safe decompress), built from the public
// format spec (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md).
//
// Reference analogue: the Go engine ships LZ4 + ZSTD block compression for
// segment sections (upstream vecgo's internal/segment/diskann/compression.go:15-65
// via github.com/pierrec/lz4). No Python lz4/zstd module is assumed, so
// the codec is native C++ loaded via ctypes (storage/lz4.py) —
// segment compression is host-side runtime work, where native code pays.
// zlib-1 ("deflate") remains as the fallback; LZ4
// is the right point on the speed/ratio curve for cloud block reads
// (decompression ~10x zlib).
//
// Implementation: single-pass greedy matcher with a 2^16-entry hash table
// (the classic LZ4-fast algorithm shape). Output is standard LZ4 block
// format: token | literals | 2-byte LE offset | matchlen extensions.
// The decompressor is the "safe" variant: every read/write bounds-checked,
// returns -1 on any malformed input (adversarial bytes must never crash the
// reader — reference: engine/fuzz_test.go FuzzFlatSegmentOpen).
//
// Build: g++ -O3 -shared -fPIC lz4codec.cpp -o libvglz4.so   (done lazily by
// lz4.py, cached by source hash).

#include <cstdint>
#include <cstring>

namespace {

constexpr int MINMATCH = 4;
constexpr int MFLIMIT = 12;       // last match must start 12+ bytes from end
constexpr int LASTLITERALS = 5;   // last 5 bytes are always literals
constexpr int MAX_DISTANCE = 65535;
constexpr int HASH_LOG = 16;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - HASH_LOG);
}

}  // namespace

extern "C" {

// Worst-case compressed size for n input bytes (matches LZ4_compressBound).
int vg_lz4_compress_bound(int n) {
  if (n < 0) return 0;
  return n + n / 255 + 16;
}

// Compress src[0..n) into dst (capacity dst_cap). Returns compressed size,
// or 0 if dst_cap is too small (callers pass vg_lz4_compress_bound).
int vg_lz4_compress(const uint8_t* src, int n, uint8_t* dst, int dst_cap) {
  if (n < 0 || dst_cap < vg_lz4_compress_bound(n)) return 0;

  uint8_t* op = dst;
  const uint8_t* ip = src;
  const uint8_t* anchor = src;
  const uint8_t* const iend = src + n;
  const uint8_t* const mflimit = iend - MFLIMIT;
  const uint8_t* const matchlimit = iend - LASTLITERALS;

  auto emit_literals = [&](const uint8_t* from, const uint8_t* to,
                           bool final_run) -> uint8_t* {
    int lit = static_cast<int>(to - from);
    uint8_t* token = op++;
    if (lit >= 15) {
      *token = 15u << 4;
      int rest = lit - 15;
      while (rest >= 255) {
        *op++ = 255;
        rest -= 255;
      }
      *op++ = static_cast<uint8_t>(rest);
    } else {
      *token = static_cast<uint8_t>(lit) << 4;
    }
    std::memcpy(op, from, lit);
    op += lit;
    (void)final_run;
    return token;
  };

  if (n >= MFLIMIT + 1) {
    uint32_t table[1 << HASH_LOG];
    std::memset(table, 0xFF, sizeof(table));  // 0xFFFFFFFF = empty

    ip++;  // first byte can't be a match target of itself
    uint32_t search_accel = 1 << 6;

    while (ip <= mflimit) {
      uint32_t h = hash4(read32(ip));
      uint32_t ref_idx = table[h];
      table[h] = static_cast<uint32_t>(ip - src);
      const uint8_t* ref = src + ref_idx;
      if (ref_idx == 0xFFFFFFFFu || ip - ref > MAX_DISTANCE ||
          read32(ref) != read32(ip)) {
        // no match: skip forward, accelerating on barren stretches
        ip += (search_accel++ >> 6);
        continue;
      }
      search_accel = 1 << 6;
      // extend match backward over pending literals
      while (ip > anchor && ref > src && ip[-1] == ref[-1]) {
        ip--;
        ref--;
      }
      // extend forward
      const uint8_t* mp = ip + MINMATCH;
      const uint8_t* rp = ref + MINMATCH;
      while (mp < matchlimit && *mp == *rp) {
        mp++;
        rp++;
      }
      int mlen = static_cast<int>(mp - ip);  // >= MINMATCH

      uint8_t* token = emit_literals(anchor, ip, false);
      // offset
      uint16_t off = static_cast<uint16_t>(ip - ref);
      *op++ = static_cast<uint8_t>(off);
      *op++ = static_cast<uint8_t>(off >> 8);
      // match length
      int ml = mlen - MINMATCH;
      if (ml >= 15) {
        *token |= 15;
        ml -= 15;
        while (ml >= 255) {
          *op++ = 255;
          ml -= 255;
        }
        *op++ = static_cast<uint8_t>(ml);
      } else {
        *token |= static_cast<uint8_t>(ml);
      }
      ip = mp;
      anchor = ip;
      if (ip > mflimit) break;
      // prime the table at the match tail for the next iteration
      table[hash4(read32(ip - 2))] = static_cast<uint32_t>(ip - 2 - src);
    }
  }

  emit_literals(anchor, iend, true);
  return static_cast<int>(op - dst);
}

// Safe decompress: src[0..n) -> dst (capacity dst_cap must equal the exact
// raw size). Returns bytes written, or -1 on ANY malformed input.
int vg_lz4_decompress_safe(const uint8_t* src, int n, uint8_t* dst,
                           int dst_cap) {
  if (n < 0 || dst_cap < 0) return -1;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  if (n == 0) return dst_cap == 0 ? 0 : -1;

  for (;;) {
    if (ip >= iend) return -1;
    uint32_t token = *ip++;
    // --- literals ---
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint32_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
        if (lit > (int64_t)1 << 33) return -1;
      } while (b == 255);
    }
    if (lit > iend - ip || lit > oend - op) return -1;
    std::memcpy(op, ip, static_cast<size_t>(lit));
    ip += lit;
    op += lit;
    if (ip == iend) {
      // proper end: last sequence is literals-only
      return op == oend ? static_cast<int>(op - dst) : -1;
    }
    // --- match ---
    if (iend - ip < 2) return -1;
    uint32_t off = ip[0] | (uint32_t(ip[1]) << 8);
    ip += 2;
    if (off == 0 || off > op - dst) return -1;
    int64_t mlen = (token & 15) + MINMATCH;
    if ((token & 15) == 15) {
      uint32_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
        if (mlen > (int64_t)1 << 33) return -1;
      } while (b == 255);
    }
    if (mlen > oend - op) return -1;
    const uint8_t* match = op - off;
    if (off >= mlen) {
      std::memcpy(op, match, static_cast<size_t>(mlen));
      op += mlen;
    } else {
      // overlapping copy (run-length style): byte-wise
      for (int64_t i = 0; i < mlen; i++) op[i] = match[i];
      op += mlen;
    }
  }
}

}  // extern "C"
