// snail native tile codec — the rebuild of the reference's quicklz
// tile-compression path (reference extern/quicklz + src/compression.cpp:
// whole-node-buffer compress at node.cpp:342-346, threaded decompress at
// compression.cpp:155-163). Self-contained LZSS with a 3-byte hash head
// table: control bytes carry 8 literal/match flags; a match is a 16-bit
// (offset:12, len-3:4) token against a 4 KiB window. Written for the
// planar RGB-delta tile layout (render.cpp:157-163) where long runs and
// short-range repeats dominate.
//
// C ABI (used from Python via ctypes — no pybind11 in this image):
//   snail_compress(src, n, dst, cap)   -> compressed size, or -1 if cap
//                                         too small (caller sends raw)
//   snail_decompress(src, n, dst, cap) -> decompressed size, or -1 on
//                                         malformed input / cap overflow
// Compressed stream: [u32 raw_len][ctrl/token bytes...]; all little-endian.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWindow = 4096;   // 12-bit offsets
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 18;   // 4-bit length field + kMinMatch
constexpr int kHashBits = 13;
constexpr int kHashSize = 1 << kHashBits;

inline uint32_t hash3(const uint8_t* p) {
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (v * 2654435761u) >> (32 - kHashBits);
}

inline void put32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)v; p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16); p[3] = (uint8_t)(v >> 24);
}

inline uint32_t get32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8)
         | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

}  // namespace

extern "C" {

long snail_compress(const uint8_t* src, long n, uint8_t* dst, long cap) {
    if (n < 0 || cap < 5) return -1;
    int32_t head[kHashSize];
    memset(head, -1, sizeof(head));

    put32(dst, (uint32_t)n);
    long out = 4;
    long i = 0;
    while (i < n) {
        long ctrl_pos = out++;
        if (out > cap) return -1;
        uint8_t ctrl = 0;
        for (int bit = 0; bit < 8 && i < n; ++bit) {
            long best_len = 0, best_off = 0;
            if (i + kMinMatch <= n) {
                uint32_t h = hash3(src + i);
                long cand = head[h];
                head[h] = (int32_t)i;
                if (cand >= 0 && i - cand <= kWindow && cand < i) {
                    long lim = n - i < kMaxMatch ? n - i : kMaxMatch;
                    long len = 0;
                    while (len < lim && src[cand + len] == src[i + len]) ++len;
                    if (len >= kMinMatch) { best_len = len; best_off = i - cand; }
                }
            }
            if (best_len >= kMinMatch) {
                if (out + 2 > cap) return -1;
                uint16_t tok = (uint16_t)(((best_off - 1) << 4) | (best_len - kMinMatch));
                dst[out++] = (uint8_t)tok;
                dst[out++] = (uint8_t)(tok >> 8);
                // seed hash heads inside the match so later data can
                // reference it (skip-ahead keeps compression fast)
                long end = i + best_len;
                for (long j = i + 1; j + kMinMatch <= n && j < end; j += 2)
                    head[hash3(src + j)] = (int32_t)j;
                i = end;
                // ctrl bit stays 0 for a match
            } else {
                if (out + 1 > cap) return -1;
                ctrl |= (uint8_t)(1 << bit);
                dst[out++] = src[i++];
            }
        }
        dst[ctrl_pos] = ctrl;
    }
    return out;
}

long snail_decompress(const uint8_t* src, long n, uint8_t* dst, long cap) {
    if (n < 4) return -1;
    long raw = (long)get32(src);
    if (raw > cap) return -1;
    long ip = 4, op = 0;
    while (op < raw) {
        if (ip >= n) return -1;
        uint8_t ctrl = src[ip++];
        for (int bit = 0; bit < 8 && op < raw; ++bit) {
            if (ctrl & (1 << bit)) {
                if (ip >= n) return -1;
                dst[op++] = src[ip++];
            } else {
                if (ip + 2 > n) return -1;
                uint16_t tok = (uint16_t)src[ip] | ((uint16_t)src[ip + 1] << 8);
                ip += 2;
                long off = (tok >> 4) + 1;
                long len = (tok & 0xF) + kMinMatch;
                if (off > op || op + len > raw) return -1;
                for (long k = 0; k < len; ++k, ++op) dst[op] = dst[op - off];
            }
        }
    }
    return op;
}

// Planar RGB delta transform (render.cpp:157-163): planar R, then G and B
// stored as byte deltas from R. In-place-safe only with distinct buffers.
void snail_rgb_delta(const uint8_t* rgb, long npix, uint8_t* out) {
    for (long i = 0; i < npix; ++i) {
        uint8_t r = rgb[i * 3];
        out[i] = r;
        out[npix + i] = (uint8_t)(rgb[i * 3 + 1] - r);
        out[2 * npix + i] = (uint8_t)(rgb[i * 3 + 2] - r);
    }
}

void snail_rgb_undelta(const uint8_t* planar, long npix, uint8_t* rgb) {
    for (long i = 0; i < npix; ++i) {
        uint8_t r = planar[i];
        rgb[i * 3] = r;
        rgb[i * 3 + 1] = (uint8_t)(planar[npix + i] + r);
        rgb[i * 3 + 2] = (uint8_t)(planar[2 * npix + i] + r);
    }
}

}  // extern "C"
