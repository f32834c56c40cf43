// Clean-room LZ4 block-format codec.
//
// The reference stores all data/*.bin buffers and data/bvh.bin LZ4-block
// compressed (src/driver/buffer.h uses liblz4's LZ4_compress_default /
// LZ4_decompress_safe). This is an independent implementation of the
// published LZ4 block format: sequences of
//   [token][literals...][2-byte LE match offset][ext match len...]
// with 4-bit literal/match length fields extended by 255-run bytes,
// minimum match length 4, and end-of-block rules (last sequence is
// literals-only; matches must not start within the last 12 bytes and must
// end >= 5 bytes before the block end).

#include <cstdint>
#include <cstring>

namespace {

constexpr int MIN_MATCH = 4;
constexpr int HASH_LOG = 16;

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

} // namespace

extern "C" {

int rt_lz4_compress_bound(int n) {
    return n + n / 255 + 16;
}

// Greedy hash-chain-free LZ4 block compressor. Returns compressed size or
// -1 if dst is too small.
int rt_lz4_compress(const uint8_t* src, int src_len, uint8_t* dst,
                    int dst_cap) {
    if (src_len < 0) return -1;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    // matches may not start in the last 12 bytes of input
    const uint8_t* const mflimit = src_len > 12 ? iend - 12 : src;
    const uint8_t* anchor = src;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;

    static thread_local int32_t table[1 << HASH_LOG];
    std::memset(table, -1, sizeof(table));

    auto write_literals = [&](const uint8_t* from, int lit_len,
                              int match_len_code, bool has_match) -> bool {
        // token + extended literal length
        if (op >= oend) return false;
        uint8_t* token = op++;
        int ll = lit_len;
        if (ll >= 15) {
            *token = uint8_t(15 << 4);
            ll -= 15;
            while (ll >= 255) {
                if (op >= oend) return false;
                *op++ = 255;
                ll -= 255;
            }
            if (op >= oend) return false;
            *op++ = uint8_t(ll);
        } else {
            *token = uint8_t(ll << 4);
        }
        if (op + lit_len > oend) return false;
        std::memcpy(op, from, lit_len);
        op += lit_len;
        if (has_match) *token |= uint8_t(match_len_code);
        return true;
    };

    while (ip < mflimit) {
        uint32_t seq = read32(ip);
        uint32_t h = hash4(seq);
        int32_t cand = table[h];
        table[h] = int32_t(ip - src);
        const uint8_t* match = src + cand;
        if (cand < 0 || (ip - match) > 65535 || read32(match) != seq) {
            ++ip;
            continue;
        }
        // extend the match forward; must end >= 5 bytes before block end
        const uint8_t* const match_limit = iend - 5;
        const uint8_t* mp = match + MIN_MATCH;
        const uint8_t* cp = ip + MIN_MATCH;
        while (cp < match_limit && *cp == *mp) { ++cp; ++mp; }
        int match_len = int(cp - ip);
        int lit_len = int(ip - anchor);

        int ml_code = match_len - MIN_MATCH;
        uint8_t* token_pos = op;
        if (!write_literals(anchor, lit_len, ml_code >= 15 ? 15 : ml_code,
                            true))
            return -1;
        // offset
        uint16_t off = uint16_t(ip - match);
        if (op + 2 > oend) return -1;
        *op++ = uint8_t(off & 0xFF);
        *op++ = uint8_t(off >> 8);
        if (ml_code >= 15) {
            int rest = ml_code - 15;
            while (rest >= 255) {
                if (op >= oend) return -1;
                *op++ = 255;
                rest -= 255;
            }
            if (op >= oend) return -1;
            *op++ = uint8_t(rest);
        }
        (void)token_pos;
        ip = cp;
        anchor = ip;
        if (ip < mflimit) table[hash4(read32(ip - 2))] = int32_t(ip - 2 - src);
    }

    // trailing literals
    int lit_len = int(iend - anchor);
    if (!write_literals(anchor, lit_len, 0, false)) return -1;
    return int(op - dst);
}

// Safe LZ4 block decompressor. Returns decompressed size or -1 on any
// malformed input / overflow.
int rt_lz4_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                      int dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;

    while (ip < iend) {
        uint8_t token = *ip++;
        // literals — accumulate in 64-bit and bound-check against the
        // remaining input/output BEFORE any pointer arithmetic: an ~8 MB
        // run of 0xFF extension bytes would overflow a 32-bit length and
        // the `ip + lit` comparison would be pointer-overflow UB
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
                if (lit > int64_t(dst_cap) + 255) return -1;
            } while (b == 255);
        }
        if (lit > iend - ip || lit > oend - op) return -1;
        std::memcpy(op, ip, size_t(lit));
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last sequence: literals only

        // match
        if (iend - ip < 2) return -1;
        int offset = ip[0] | (ip[1] << 8);
        ip += 2;
        if (offset == 0 || op - dst < offset) return -1;
        int64_t mlen = (token & 15) + MIN_MATCH;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
                if (mlen > int64_t(dst_cap) + 255) return -1;
            } while (b == 255);
        }
        if (mlen > oend - op) return -1;
        const uint8_t* mp = op - offset;
        // byte-wise copy: offsets < mlen overlap intentionally
        for (int64_t i = 0; i < mlen; ++i) op[i] = mp[i];
        op += mlen;
    }
    return int(op - dst);
}

} // extern "C"
