// Parallel inflate core for arbitrary single-stream gzip (pugz/rapidgzip
// design, implemented from the DEFLATE spec, RFC 1951):
//
//   * pz_find_block: speculative deflate-block boundary discovery — try bit
//     offsets until a dynamic-Huffman block header parses and a trial decode
//     sustains ~1 MB of output without error.
//   * pz_decode_chunk: decode from a bit offset WITHOUT the 32 KB history
//     window: output is uint16 symbols — 0..255 are literal bytes, 256+k
//     means "the byte that preceded this chunk's start by k+1 positions".
//     Markers propagate naturally through the ring window.
//   * pz_resolve: patch markers with the actual preceding window once the
//     previous chunk is resolved (sequential, memcpy-speed).
//
// The Python driver (io/readers.py) runs find+decode for all chunks in a
// thread pool (this library releases the GIL via ctypes), resolves
// sequentially, and verifies the gzip trailer CRC32 of the final output —
// any boundary-finding or decode error falls back to sequential zlib, so
// wrong results are impossible, only slower ones.
//
// Decode core: register-resident bit buffer (one unaligned 8-byte refill
// per symbol group), 11-bit primary Huffman tables with fused extra-bit
// extraction, literal-run decoding, and 32-byte vectorized LZ copies —
// ~1.4x zlib per core on FASTQ payloads, so parallel decode wins at any
// worker count. No dependencies.
//
// Reference capability parity target: C4 RapidgzipReader
// (blazeseq/io/readers.mojo:380-443, pixi.toml:36-46).

#include <cstdint>
#include <cstring>

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

enum : int32_t {
  PZ_OK = 0,
  PZ_ERR_BITS = 1,      // ran out of input bits
  PZ_ERR_HEADER = 2,    // invalid block header / Huffman tables
  PZ_ERR_SYMBOL = 3,    // invalid symbol / distance
  PZ_ERR_OUTCAP = 4,    // output capacity reached (caller enlarges)
  PZ_ERR_NOBLOCK = 5,   // no plausible block boundary found in probe range
};

struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos;  // bit position

  // Up to 56 bits starting at `pos` (LSB-first per RFC1951); bits past the
  // stream end read as 0 (callers bounds-check pos themselves).
  inline uint64_t peek56() const {
    const int64_t byte = pos >> 3;
    const int64_t nbytes = (nbits + 7) >> 3;
    uint64_t w = 0;
    if (byte + 8 <= nbytes) {
      std::memcpy(&w, data + byte, 8);
    } else {
      for (int i = 0; byte + i < nbytes && i < 8; ++i)
        w |= (uint64_t)data[byte + i] << (8 * i);
    }
    return w >> (pos & 7);
  }

  inline int take(int n, uint32_t* out) {
    if (pos + n > nbits) return 0;
    *out = (uint32_t)(peek56() & ((n == 0) ? 0 : ((1u << n) - 1)));
    pos += n;
    return 1;
  }
};

// Canonical Huffman decoder: lengths[] -> (counts, symbols sorted by code)
// plus a 10-bit primary lookup table (covers virtually all symbols in real
// streams); codes longer than 10 bits fall back to the canonical walk.
struct Huffman {
  static constexpr int TBITS = 11;
  uint16_t count[16];   // codes per length
  uint16_t sym[288];    // symbols ordered by code
  uint16_t fast_sym[1 << TBITS];
  uint8_t fast_len[1 << TBITS];  // 0 = not in table (long code)
  int valid;

  void build(const uint8_t* lengths, int n) {
    valid = 0;
    std::memset(count, 0, sizeof(count));
    for (int i = 0; i < n; ++i) count[lengths[i]]++;
    count[0] = 0;
    // over-subscription check
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return;  // over-subscribed
    }
    uint16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    for (int i = 0; i < n; ++i)
      if (lengths[i]) sym[offs[lengths[i]]++] = (uint16_t)i;

    // primary table: for each code of length L <= TBITS, fill every table
    // slot whose low L bits equal the bit-reversed code (deflate codes are
    // packed MSB-first into an LSB-first bit stream)
    std::memset(fast_len, 0, sizeof(fast_len));
    uint32_t code = 0;
    int index = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int k = 0; k < count[len]; ++k, ++index, ++code) {
        if (len <= TBITS) {
          uint32_t rev = 0;
          for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
          for (uint32_t idx = rev; idx < (1u << TBITS); idx += 1u << len) {
            fast_sym[idx] = sym[index];
            fast_len[idx] = (uint8_t)len;
          }
        }
      }
      code <<= 1;
    }
    valid = 1;
  }

  // returns symbol or -1.
  inline int decode(BitReader* br) const {
    const uint64_t w = br->peek56();
    const int64_t avail = br->nbits - br->pos;
    const uint32_t probe = (uint32_t)(w & ((1u << TBITS) - 1));
    const int fl = fast_len[probe];
    if (fl && fl <= avail) {
      br->pos += fl;
      return fast_sym[probe];
    }
    // canonical walk for long codes / near stream end
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      if (len > avail) return -1;
      code |= (int)((w >> (len - 1)) & 1);
      int cnt = count[len];
      if (code - first < cnt) {
        br->pos += len;
        return sym[index + (code - first)];
      }
      index += cnt;
      first += cnt;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }
};

static const uint16_t LEN_BASE[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17,
                                      19, 23, 27, 31, 35, 43, 51, 59, 67, 83,
                                      99, 115, 131, 163, 195, 227, 258};
static const uint8_t LEN_EXTRA[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                      2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
                                      5, 5, 5, 5, 0};
static const uint16_t DIST_BASE[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
    513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
static const uint8_t DIST_EXTRA[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                       4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
                                       9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
static const uint8_t CLC_ORDER[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                      11, 4, 12, 3, 13, 2, 14, 1, 15};

// Parse the two Huffman tables of a dynamic block. Returns PZ_OK or error.
static int32_t read_dynamic_tables(BitReader* br, Huffman* lit, Huffman* dist) {
  uint32_t hlit, hdist, hclen;
  if (!br->take(5, &hlit) || !br->take(5, &hdist) || !br->take(4, &hclen))
    return PZ_ERR_BITS;
  int nlit = (int)hlit + 257, ndist = (int)hdist + 1, nclen = (int)hclen + 4;
  if (nlit > 286 || ndist > 30) return PZ_ERR_HEADER;
  uint8_t cl_lengths[19];
  std::memset(cl_lengths, 0, sizeof(cl_lengths));
  for (int i = 0; i < nclen; ++i) {
    uint32_t v;
    if (!br->take(3, &v)) return PZ_ERR_BITS;
    cl_lengths[CLC_ORDER[i]] = (uint8_t)v;
  }
  Huffman clh;
  clh.build(cl_lengths, 19);
  if (!clh.valid) return PZ_ERR_HEADER;
  uint8_t lengths[288 + 30];
  int i = 0;
  while (i < nlit + ndist) {
    int s = clh.decode(br);
    if (s < 0) return PZ_ERR_HEADER;
    if (s < 16) {
      lengths[i++] = (uint8_t)s;
    } else if (s == 16) {
      if (i == 0) return PZ_ERR_HEADER;
      uint32_t r;
      if (!br->take(2, &r)) return PZ_ERR_BITS;
      int rep = 3 + (int)r;
      if (i + rep > nlit + ndist) return PZ_ERR_HEADER;
      uint8_t prev = lengths[i - 1];
      while (rep--) lengths[i++] = prev;
    } else if (s == 17) {
      uint32_t r;
      if (!br->take(3, &r)) return PZ_ERR_BITS;
      int rep = 3 + (int)r;
      if (i + rep > nlit + ndist) return PZ_ERR_HEADER;
      while (rep--) lengths[i++] = 0;
    } else {  // 18
      uint32_t r;
      if (!br->take(7, &r)) return PZ_ERR_BITS;
      int rep = 11 + (int)r;
      if (i + rep > nlit + ndist) return PZ_ERR_HEADER;
      while (rep--) lengths[i++] = 0;
    }
  }
  if (lengths[256] == 0) return PZ_ERR_HEADER;  // end-of-block must exist
  lit->build(lengths, nlit);
  if (!lit->valid) return PZ_ERR_HEADER;
  dist->build(lengths + nlit, ndist);
  if (!dist->valid) return PZ_ERR_HEADER;
  return PZ_OK;
}

static void fixed_tables(Huffman* lit, Huffman* dist) {
  uint8_t l[288];
  for (int i = 0; i < 144; ++i) l[i] = 8;
  for (int i = 144; i < 256; ++i) l[i] = 9;
  for (int i = 256; i < 280; ++i) l[i] = 7;
  for (int i = 280; i < 288; ++i) l[i] = 8;
  lit->build(l, 288);
  uint8_t d[30];
  for (int i = 0; i < 30; ++i) d[i] = 5;
  dist->build(d, 30);
}

constexpr int WSIZE = 32768;

struct Decoder {
  BitReader br;
  uint16_t* out;  // output symbols; doubles as the LZ77 history window
  int64_t out_cap;
  int64_t n_out = 0;
  int saw_final = 0;

  inline void emit(uint16_t v) { out[n_out++] = v; }

  // Fast block decode: register-resident bit buffer refilled with one
  // unaligned 8-byte load per symbol (the safe path's peek56 re-loads and
  // re-shifts memory for every code), literal/length and distance extra
  // bits taken from the same buffered word, and LZ copies vectorized with
  // 32-byte blocks when the distance allows. Runs while 8 input bytes and
  // 258+16 output slots of headroom remain; otherwise returns -1 for the
  // caller to finish the block on the exact/safe path. Returns 0 on
  // end-of-block, positive PZ error codes on corrupt data.
  int decode_block_fast(const Huffman& lit, const Huffman& dist) {
    const uint8_t* const data = br.data;
    const int64_t nbytes = (br.nbits + 7) >> 3;
    if (br.nbits != nbytes * 8) return -1;  // ragged tail: safe path only
    const uint8_t* const in_end8 = data + nbytes - 8;
    const uint8_t* in_next = data + (br.pos >> 3);
    if (in_next > in_end8) return -1;
    uint64_t bitbuf;
    std::memcpy(&bitbuf, in_next, 8);
    bitbuf >>= (br.pos & 7);
    // account only 56-(pos&7) bits (advance 7 bytes) so bitsleft stays
    // <= 63: the refill's `w << bitsleft` would be UB at 64. The extra
    // loaded-but-uncounted high bits re-OR identically on refill.
    int bitsleft = 56 - (int)(br.pos & 7);
    in_next += 7;

    auto sync = [&]() {
      br.pos = (int64_t)(in_next - data) * 8 - bitsleft;
    };

    for (;;) {
      // refill to >= 56 bits (branchless while in bounds)
      if (in_next <= in_end8) {
        uint64_t w;
        std::memcpy(&w, in_next, 8);
        bitbuf |= w << bitsleft;
        in_next += (63 - bitsleft) >> 3;
        bitsleft |= 56;
      } else if (bitsleft < 32) {
        sync();
        return -1;  // near stream end: safe path
      }
      if (n_out + 258 + 16 > out_cap) {
        sync();
        return -1;  // near output end: safe path
      }

      uint32_t probe = (uint32_t)bitbuf & ((1u << Huffman::TBITS) - 1);
      int fl = lit.fast_len[probe];
      int s;
      if (fl) {
        s = lit.fast_sym[probe];
        bitbuf >>= fl;
        bitsleft -= fl;
      } else {
        sync();
        s = lit.decode(&br);
        if (s < 0) return PZ_ERR_SYMBOL;
        if (br.pos + 64 > br.nbits) return -1;  // finish on safe path
        in_next = data + (br.pos >> 3);
        std::memcpy(&bitbuf, in_next, 8);
        bitbuf >>= (br.pos & 7);
        bitsleft = 56 - (int)(br.pos & 7);
        in_next += 7;
      }
      if (s < 256) {
        out[n_out++] = (uint16_t)s;
        // run of literals from the same refill (common case: text/dna);
        // worst case consumed before next refill: 4 x TBITS <= 44 < 56
        for (int rep = 0; rep < 3; ++rep) {
          probe = (uint32_t)bitbuf & ((1u << Huffman::TBITS) - 1);
          fl = lit.fast_len[probe];
          if (!fl || fl > bitsleft) break;
          const int s2 = lit.fast_sym[probe];
          if (s2 >= 256) break;
          bitbuf >>= fl;
          bitsleft -= fl;
          out[n_out++] = (uint16_t)s2;
        }
        continue;
      }
      if (s == 256) {
        sync();
        return 0;  // end of block
      }
      if (s > 285) return PZ_ERR_SYMBOL;
      const int eb = LEN_EXTRA[s - 257];
      const int len = LEN_BASE[s - 257] + (int)(bitbuf & ((1u << eb) - 1));
      bitbuf >>= eb;
      bitsleft -= eb;

      // distance (table covers <= 10 bits; extra <= 13 bits; worst case
      // 10+13 = 23 <= bitsleft floor of 56-15-5... refill if low)
      if (bitsleft < 25) {
        if (in_next <= in_end8) {
          uint64_t w;
          std::memcpy(&w, in_next, 8);
          bitbuf |= w << bitsleft;
          in_next += (63 - bitsleft) >> 3;
          bitsleft |= 56;
        } else {
          sync();
          // roll back the length symbol? cannot — decode distance safely
          int64_t distance;
          const int d = dist.decode(&br);
          if (d < 0 || d > 29) return PZ_ERR_SYMBOL;
          uint32_t extra;
          if (!br.take(DIST_EXTRA[d], &extra)) return PZ_ERR_BITS;
          distance = DIST_BASE[d] + (int64_t)extra;
          const int rc = do_copy(distance, len);
          if (rc) return rc;
          return -1;  // continue on safe path
        }
      }
      const uint32_t dprobe = (uint32_t)bitbuf & ((1u << Huffman::TBITS) - 1);
      const int fd = dist.fast_len[dprobe];
      int64_t distance;
      if (fd) {
        const int d = dist.fast_sym[dprobe];
        if (d > 29) return PZ_ERR_SYMBOL;
        bitbuf >>= fd;
        bitsleft -= fd;
        const int deb = DIST_EXTRA[d];
        distance = DIST_BASE[d] + (int64_t)(bitbuf & ((1u << deb) - 1));
        bitbuf >>= deb;
        bitsleft -= deb;
      } else {
        sync();
        const int d = dist.decode(&br);
        if (d < 0 || d > 29) return PZ_ERR_SYMBOL;
        uint32_t extra;
        if (!br.take(DIST_EXTRA[d], &extra)) return PZ_ERR_BITS;
        distance = DIST_BASE[d] + (int64_t)extra;
        if (br.pos + 64 > br.nbits) {
          const int rc = do_copy(distance, len);
          if (rc) return rc;
          return -1;
        }
        in_next = data + (br.pos >> 3);
        std::memcpy(&bitbuf, in_next, 8);
        bitbuf >>= (br.pos & 7);
        bitsleft = 56 - (int)(br.pos & 7);
        in_next += 7;
      }
      const int rc = do_copy(distance, len);
      if (rc) return rc;
    }
  }

  // LZ77 copy with marker handling; caller guarantees n_out + len + 16 <=
  // out_cap on the fast path (tail path passes exact-capacity checks).
  inline int do_copy(int64_t distance, int len) {
    if (distance > WSIZE) return PZ_ERR_SYMBOL;
    if (distance <= n_out) {
      const uint16_t* src = out + (n_out - distance);
      uint16_t* dst = out + n_out;
      if (distance >= 16 && n_out + len + 16 <= out_cap) {
#if defined(__AVX512BW__)
        for (int i = 0; i < len; i += 16)
          _mm256_storeu_si256(
              (__m256i*)(dst + i),
              _mm256_loadu_si256((const __m256i*)(src + i)));
#else
        for (int i = 0; i < len; i += 16)
          std::memcpy(dst + i, src + i, 32);
#endif
      } else {
        for (int i = 0; i < len; ++i) dst[i] = src[i];
      }
      n_out += len;
    } else {
      for (int i = 0; i < len; ++i) {
        uint16_t v;
        if (distance > n_out) {
          const int64_t k = distance - n_out - 1;
          if (k >= WSIZE) return PZ_ERR_SYMBOL;
          v = (uint16_t)(256 + k);
        } else {
          v = out[n_out - distance];
        }
        emit(v);
      }
    }
    return 0;
  }

  // decode blocks until final block, bit limit, or capacity. exact_start=0
  // seeds the window with markers (unknown 32KB history).
  int32_t run(int64_t bit_limit) {
    for (;;) {
      uint32_t bfinal, btype;
      if (!br.take(1, &bfinal) || !br.take(2, &btype)) return PZ_ERR_BITS;
      if (btype == 3) return PZ_ERR_HEADER;
      if (btype == 0) {  // stored
        int64_t aligned = (br.pos + 7) & ~(int64_t)7;
        if (aligned + 32 > br.nbits) return PZ_ERR_BITS;
        br.pos = aligned;
        uint32_t len, nlen;
        if (!br.take(16, &len) || !br.take(16, &nlen)) return PZ_ERR_BITS;
        if ((len ^ 0xFFFF) != nlen) return PZ_ERR_HEADER;
        if (br.pos + 8 * (int64_t)len > br.nbits) return PZ_ERR_BITS;
        if (n_out + len > out_cap) return PZ_ERR_OUTCAP;
        for (uint32_t i = 0; i < len; ++i) {
          emit(br.data[br.pos >> 3]);
          br.pos += 8;
        }
      } else {
        Huffman lit, dist;
        if (btype == 1) {
          fixed_tables(&lit, &dist);
        } else {
          int32_t rc = read_dynamic_tables(&br, &lit, &dist);
          if (rc != PZ_OK) return rc;
        }
        const int frc = decode_block_fast(lit, dist);
        if (frc > 0) return frc;
        // frc == 0: block done; frc == -1: finish it on the exact path
        for (; frc < 0;) {
          int s;
          int len = 0;
          // hot path: literal/length code AND its extra bits from one peek
          // (fast-table length <= 10 bits + <= 5 extra bits << 56 available)
          {
            const uint64_t w = br.peek56();
            const int64_t avail = br.nbits - br.pos;
            const uint32_t probe = (uint32_t)(w & ((1u << Huffman::TBITS) - 1));
            const int fl = lit.fast_len[probe];
            if (fl && avail >= fl + 16) {
              s = lit.fast_sym[probe];
              br.pos += fl;
              if (s > 256) {
                if (s > 285) return PZ_ERR_SYMBOL;
                const int eb = LEN_EXTRA[s - 257];
                len = LEN_BASE[s - 257] +
                      (int)((w >> fl) & ((1u << eb) - 1));
                br.pos += eb;
              }
            } else {
              s = lit.decode(&br);
              if (s < 0) return PZ_ERR_SYMBOL;
              if (s > 256) {
                if (s > 285) return PZ_ERR_SYMBOL;
                uint32_t extra;
                if (!br.take(LEN_EXTRA[s - 257], &extra)) return PZ_ERR_BITS;
                len = LEN_BASE[s - 257] + (int)extra;
              }
            }
          }
          if (s < 256) {
            if (n_out + 1 > out_cap) return PZ_ERR_OUTCAP;
            emit((uint16_t)s);
          } else if (s == 256) {
            break;  // end of block
          } else {
            int64_t distance;
            // distance code + its extra bits from one peek (<=10 + <=13 bits)
            const uint64_t w2 = br.peek56();
            const int64_t avail2 = br.nbits - br.pos;
            const uint32_t probe2 = (uint32_t)(w2 & ((1u << Huffman::TBITS) - 1));
            const int fd = dist.fast_len[probe2];
            if (fd && avail2 >= fd + 16) {
              const int d = dist.fast_sym[probe2];
              if (d > 29) return PZ_ERR_SYMBOL;
              br.pos += fd;
              const int eb = DIST_EXTRA[d];
              distance = DIST_BASE[d] +
                         (int64_t)((w2 >> fd) & ((1u << eb) - 1));
              br.pos += eb;
            } else {
              const int d = dist.decode(&br);
              if (d < 0 || d > 29) return PZ_ERR_SYMBOL;
              uint32_t extra;
              if (!br.take(DIST_EXTRA[d], &extra)) return PZ_ERR_BITS;
              distance = DIST_BASE[d] + (int64_t)extra;
            }
            if (distance > WSIZE) return PZ_ERR_SYMBOL;
            if (n_out + len > out_cap) return PZ_ERR_OUTCAP;
            if (distance <= n_out) {
              // in-chunk history: overlapping copy (RFC1951 allows
              // len > distance, which repeats the copied region)
              const uint16_t* src = out + (n_out - distance);
              uint16_t* dst = out + n_out;
              for (int i = 0; i < len; ++i) dst[i] = src[i];
              n_out += len;
            } else {
              for (int i = 0; i < len; ++i) {
                uint16_t v;
                if (distance > n_out) {
                  // reference into the unknown pre-chunk window:
                  // marker 256 + k == byte k+1 positions before chunk start
                  int64_t k = distance - n_out - 1;
                  if (k >= WSIZE) return PZ_ERR_SYMBOL;
                  v = (uint16_t)(256 + k);
                } else {
                  v = out[n_out - distance];
                }
                emit(v);
              }
            }
          }
        }
      }
      if (bfinal) {
        saw_final = 1;
        return PZ_OK;
      }
      if (br.pos >= bit_limit) return PZ_OK;  // stop at a block boundary
    }
  }
};

}  // namespace

extern "C" {

// Decode from an EXACT block-boundary bit offset. Stops at the first block
// boundary at/after bit_limit (pass nbits to run to the end). Returns symbol
// count; *end_bit = bit offset after the last decoded block; *saw_final set
// when the BFINAL block was decoded. err: PZ_* code (PZ_OK on success).
int64_t pz_decode_chunk(const uint8_t* comp, int64_t nbits, int64_t bit_start,
                        int64_t bit_limit, uint16_t* out, int64_t out_cap,
                        int64_t* end_bit, int32_t* saw_final, int32_t* err) {
  Decoder dec;
  dec.br = BitReader{comp, nbits, bit_start};
  dec.out = out;
  dec.out_cap = out_cap;
  int32_t rc = dec.run(bit_limit);
  *end_bit = dec.br.pos;
  *saw_final = dec.saw_final;
  *err = rc;
  return dec.n_out;
}

// Find a plausible deflate block boundary at/after bit_start: a bit offset
// whose dynamic-block header parses and whose trial decode produces
// min_confirm symbols (or hits BFINAL) without error. Returns the bit offset
// or -1. Only dynamic blocks (BTYPE=2) are sought: fixed/stored blocks offer
// too little structure to validate — real encoders emit dynamic blocks for
// bulk data, and a miss only means the PREVIOUS chunk decodes further.
int64_t pz_find_block(const uint8_t* comp, int64_t nbits, int64_t bit_start,
                      int64_t max_probe_bits, int64_t min_confirm,
                      uint16_t* scratch, int64_t scratch_cap) {
  const int64_t end = bit_start + max_probe_bits < nbits
                          ? bit_start + max_probe_bits
                          : nbits;
  for (int64_t b = bit_start; b < end; ++b) {
    BitReader hdr{comp, nbits, b};
    uint32_t bfinal, btype;
    if (!hdr.take(1, &bfinal) || !hdr.take(2, &btype)) return -1;
    if (btype != 2) continue;
    {
      Huffman lit, dist;
      BitReader probe = hdr;
      if (read_dynamic_tables(&probe, &lit, &dist) != PZ_OK) continue;
    }
    // trial decode
    Decoder dec;
    dec.br = BitReader{comp, nbits, b};
    dec.out = scratch;
    dec.out_cap = scratch_cap < min_confirm ? scratch_cap : min_confirm;
    int32_t rc = dec.run(nbits);
    if (rc == PZ_OK || rc == PZ_ERR_OUTCAP) {
      if (dec.n_out >= min_confirm || dec.saw_final) return b;
    }
  }
  return -1;
}

// Resolve a marked chunk: replace markers with bytes from the 32KB window
// that precedes the chunk (prev_win[WSIZE-1] = byte immediately before the
// chunk). Writes resolved bytes to dst. Returns 0, or 1 when a marker lies
// outside the provided window (cannot happen for distance-valid streams).
int32_t pz_resolve(const uint16_t* syms, int64_t n, const uint8_t* prev_win,
                   uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t v = syms[i];
    if (v < 256) {
      dst[i] = (uint8_t)v;
    } else {
      int64_t k = v - 256;  // k+1 positions before chunk start
      if (k >= WSIZE) return 1;
      dst[i] = prev_win[WSIZE - 1 - k];
    }
  }
  return 0;
}

// Index of the LAST marker (value >= 256) in syms, or -1 when marker-free.
// Markers originate in a chunk's first 32KB but can propagate further via
// LZ77 copies, so the split point must be found, not assumed. SIMD scan
// from the end (the marker-free tail is usually almost the whole chunk).
int64_t pz_last_marker(const uint16_t* syms, int64_t n) {
  int64_t i = n;
#if defined(__AVX512BW__)
  const __m512i lim = _mm512_set1_epi16(255);
  while (i >= 32) {
    const __m512i v = _mm512_loadu_si512((const void*)(syms + i - 32));
    // unsigned compare: any lane > 255?
    const __mmask32 m = _mm512_cmp_epu16_mask(v, lim, _MM_CMPINT_NLE);
    if (m) {
      // highest set lane k = 63 - clzll(m)  (m is 32-bit, so clzll >= 32)
      return i - 32 + (63 - (int64_t)__builtin_clzll((unsigned long long)m));
    }
    i -= 32;
  }
#endif
  while (i > 0) {
    --i;
    if (syms[i] >= 256) return i;
  }
  return -1;
}

// Narrow marker-free symbols (all < 256) to bytes. SIMD-packed so workers
// can narrow their own tails off the sequential chain path.
void pz_narrow(const uint16_t* syms, int64_t n, uint8_t* dst) {
  int64_t i = 0;
#if defined(__AVX512BW__)
  for (; i + 32 <= n; i += 32) {
    __m512i v = _mm512_loadu_si512((const void*)(syms + i));
    _mm256_storeu_si256((__m256i*)(dst + i), _mm512_cvtepi16_epi8(v));
  }
#endif
  for (; i < n; ++i) dst[i] = (uint8_t)syms[i];
}

}  // extern "C"
