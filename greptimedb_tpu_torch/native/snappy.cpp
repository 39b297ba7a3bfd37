// Snappy block-format codec (compress + decompress).
//
// Prometheus remote read/write bodies are snappy-compressed protobuf
// (reference: src/servers/src/prometheus.rs:286-373, via the snappy
// crate). The image ships no snappy library, so this implements the
// block format natively: greedy 4-byte hash matching on the compress
// side (the classic snappy scheme), full tag support on the decompress
// side. Bound via ctypes (utils/snappy.py) with the pure-
// Python codec as fallback.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) {
  return (v * 0x1e35a7bdu) >> 18;   // 14-bit table
}

constexpr int kHashBits = 14;
constexpr int kHashSize = 1 << kHashBits;

size_t write_varint(uint8_t* dst, uint64_t n) {
  size_t i = 0;
  while (n >= 0x80) {
    dst[i++] = (uint8_t)(n | 0x80);
    n >>= 7;
  }
  dst[i++] = (uint8_t)n;
  return i;
}

size_t emit_literal(uint8_t* dst, const uint8_t* src, size_t len) {
  size_t i = 0;
  size_t n = len - 1;
  if (n < 60) {
    dst[i++] = (uint8_t)(n << 2);
  } else if (n < (1u << 8)) {
    dst[i++] = 60 << 2;
    dst[i++] = (uint8_t)n;
  } else if (n < (1u << 16)) {
    dst[i++] = 61 << 2;
    dst[i++] = (uint8_t)n;
    dst[i++] = (uint8_t)(n >> 8);
  } else if (n < (1u << 24)) {
    dst[i++] = 62 << 2;
    dst[i++] = (uint8_t)n;
    dst[i++] = (uint8_t)(n >> 8);
    dst[i++] = (uint8_t)(n >> 16);
  } else {
    dst[i++] = 63 << 2;
    dst[i++] = (uint8_t)n;
    dst[i++] = (uint8_t)(n >> 8);
    dst[i++] = (uint8_t)(n >> 16);
    dst[i++] = (uint8_t)(n >> 24);
  }
  std::memcpy(dst + i, src, len);
  return i + len;
}

size_t emit_copy(uint8_t* dst, size_t offset, size_t len) {
  size_t i = 0;
  // prefer copy-1 (4..11 len, offset < 2048)
  while (len > 0) {
    if (len >= 4 && len <= 11 && offset < 2048) {
      dst[i++] = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
      dst[i++] = (uint8_t)offset;
      return i;
    }
    size_t chunk = len > 64 ? 64 : len;
    if (chunk < 4 && len > 64) chunk = 60;  // keep remainder >= 4
    if (len - chunk != 0 && len - chunk < 4) chunk = len - 4;
    dst[i++] = (uint8_t)(2 | ((chunk - 1) << 2));
    dst[i++] = (uint8_t)offset;
    dst[i++] = (uint8_t)(offset >> 8);
    len -= chunk;
  }
  return i;
}

}  // namespace

extern "C" {

// Worst-case output size for n input bytes (snappy's MaxCompressedLength).
uint64_t snappy_max_compressed(uint64_t n) { return 32 + n + n / 6; }

// Returns compressed size, or 0 on error. dst must have
// snappy_max_compressed(n) bytes.
uint64_t snappy_compress(const uint8_t* src, uint64_t n, uint8_t* dst) {
  size_t d = write_varint(dst, n);
  if (n == 0) return d;

  uint16_t table[kHashSize];
  std::memset(table, 0, sizeof(table));
  // table stores pos+1 within the current 64KB-ish window; reset per block
  const size_t kBlock = 1 << 16;

  size_t ip = 0;
  while (ip < n) {
    size_t block_end = ip + kBlock < n ? ip + kBlock : n;
    size_t base = ip;
    std::memset(table, 0, sizeof(table));
    size_t lit_start = ip;
    while (ip + 4 <= block_end) {
      uint32_t h = hash32(load32(src + ip));
      size_t cand = base + table[h];     // 1-based within block
      table[h] = (uint16_t)(ip - base + 1);
      if (table[h] == 0) {               // overflowed uint16: skip
        ip++;
        continue;
      }
      if (cand > base && cand - 1 < ip &&
          load32(src + (cand - 1)) == load32(src + ip) &&
          ip - (cand - 1) < 65536) {
        size_t match_pos = cand - 1;
        // flush pending literal
        if (ip > lit_start)
          d += emit_literal(dst + d, src + lit_start, ip - lit_start);
        // extend the match
        size_t len = 4;
        while (ip + len < block_end &&
               src[match_pos + len] == src[ip + len] && len < 0xFFFF)
          len++;
        d += emit_copy(dst + d, ip - match_pos, len);
        ip += len;
        lit_start = ip;
      } else {
        ip++;
      }
    }
    // trailing literal of this block
    if (block_end > lit_start) {
      d += emit_literal(dst + d, src + lit_start, block_end - lit_start);
    }
    ip = block_end;
  }
  return d;
}

// Returns decompressed size, or 0 on error (call snappy_uncompressed_length
// first to size dst).
uint64_t snappy_uncompressed_length(const uint8_t* src, uint64_t n) {
  uint64_t result = 0;
  int shift = 0;
  for (uint64_t i = 0; i < n && i < 10; i++) {
    result |= (uint64_t)(src[i] & 0x7F) << shift;
    if (!(src[i] & 0x80)) return result;
    shift += 7;
  }
  return 0;
}

int64_t snappy_uncompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                          uint64_t dst_cap) {
  // skip varint
  uint64_t pos = 0;
  while (pos < n && (src[pos] & 0x80)) pos++;
  if (pos >= n) return -1;
  pos++;

  uint64_t d = 0;
  while (pos < n) {
    uint8_t tag = src[pos];
    int elem = tag & 3;
    if (elem == 0) {                        // literal
      uint64_t len = (tag >> 2) + 1;
      pos++;
      if (len > 60) {
        uint64_t extra = len - 60;
        if (pos + extra > n) return -1;
        len = 0;
        for (uint64_t j = 0; j < extra; j++)
          len |= (uint64_t)src[pos + j] << (8 * j);
        len += 1;
        pos += extra;
      }
      if (pos + len > n || d + len > dst_cap) return -1;
      std::memcpy(dst + d, src + pos, len);
      pos += len;
      d += len;
    } else {
      uint64_t len, offset;
      if (elem == 1) {
        if (pos + 2 > n) return -1;
        len = ((tag >> 2) & 0x7) + 4;
        offset = ((uint64_t)(tag >> 5) << 8) | src[pos + 1];
        pos += 2;
      } else if (elem == 2) {
        if (pos + 3 > n) return -1;
        len = (tag >> 2) + 1;
        offset = (uint64_t)src[pos + 1] | ((uint64_t)src[pos + 2] << 8);
        pos += 3;
      } else {
        if (pos + 5 > n) return -1;
        len = (tag >> 2) + 1;
        offset = (uint64_t)src[pos + 1] | ((uint64_t)src[pos + 2] << 8) |
                 ((uint64_t)src[pos + 3] << 16) |
                 ((uint64_t)src[pos + 4] << 24);
        pos += 5;
      }
      if (offset == 0 || offset > d || d + len > dst_cap) return -1;
      // byte-by-byte: overlapping copies are part of the format
      for (uint64_t j = 0; j < len; j++) {
        dst[d] = dst[d - offset];
        d++;
      }
    }
  }
  return (int64_t)d;
}

}  // extern "C"
