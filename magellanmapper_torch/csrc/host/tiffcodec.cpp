// Native TIFF strip codecs: LZW and PackBits decode.
//
// The pure-Python LZW decoder in io/tiff.py runs ~1 MB/s, far too slow
// for production microscopy stacks (a single 2k x 2k uint16 page is
// 8 MB). These hot decoders mirror the Python implementations
// bit-for-bit (TIFF 6.0 sections 9/13: MSB-first bit packing, ClearCode
// 256, EOI 257, early change at table sizes 511/1023/2047). The port
// builds this file with g++ at first use and loads it with ctypes
// (io/_tiffcodec.py); the Python decoders are their plain versions.

#include <cstdint>
#include <cstring>

namespace {

struct LzwTable {
    int16_t prefix[4096];
    uint8_t suffix[4096];
    int32_t length[4096];
    uint8_t first[4096];
    int next;

    void reset() {
        for (int i = 0; i < 256; ++i) {
            prefix[i] = -1;
            suffix[i] = (uint8_t)i;
            length[i] = 1;
            first[i] = (uint8_t)i;
        }
        next = 258;  // 256/257 reserved for Clear/EOI
    }
};

}  // namespace

extern "C" {

// returns 0 on success, -1 on corrupt stream, -2 on output overflow
int tiff_lzw_decode(const uint8_t* src, int64_t src_len,
                    uint8_t* dst, int64_t dst_cap, int64_t* out_len) {
    static const int kClear = 256, kEoi = 257;
    LzwTable t;
    t.reset();
    int width = 9;
    uint64_t buf = 0;
    int nbits = 0;
    int64_t out = 0;
    int prev = -1;

    // write the (reversed-chain) string for `code` at dst+out
    auto emit = [&](int code) -> int {
        int64_t len = t.length[code];
        if (out + len > dst_cap) return -2;
        int64_t pos = out + len;
        for (int c = code; c >= 0; c = t.prefix[c]) dst[--pos] = t.suffix[c];
        out += len;
        return 0;
    };
    auto add_entry = [&](int prev_code, uint8_t append_first) {
        if (t.next >= 4096) return;
        t.prefix[t.next] = (int16_t)prev_code;
        t.suffix[t.next] = append_first;
        t.length[t.next] = t.length[prev_code] + 1;
        t.first[t.next] = t.first[prev_code];
        ++t.next;
    };

    for (int64_t i = 0; i < src_len; ++i) {
        buf = (buf << 8) | src[i];
        nbits += 8;
        while (nbits >= width) {
            int code = (int)((buf >> (nbits - width)) & ((1u << width) - 1));
            nbits -= width;
            if (code == kClear) {
                t.reset();
                width = 9;
                prev = -1;
                continue;
            }
            if (code == kEoi) {
                *out_len = out;
                return 0;
            }
            if (prev < 0) {
                if (code >= 256) return -1;
                if (emit(code)) return -2;
                prev = code;
            } else if (code < t.next) {
                if (code == kClear || code == kEoi) return -1;
                if (emit(code)) return -2;
                add_entry(prev, t.first[code]);
                prev = code;
            } else if (code == t.next && t.next < 4096) {
                add_entry(prev, t.first[prev]);       // KwKwK
                if (emit(t.next - 1)) return -2;
                prev = t.next - 1;
            } else {
                return -1;
            }
            if (t.next == 511 || t.next == 1023 || t.next == 2047) ++width;
        }
    }
    *out_len = out;
    return 0;
}

int tiff_packbits_decode(const uint8_t* src, int64_t src_len,
                         uint8_t* dst, int64_t dst_cap, int64_t* out_len) {
    int64_t i = 0, out = 0;
    while (i < src_len) {
        uint8_t ctl = src[i++];
        if (ctl < 128) {
            int64_t n = (int64_t)ctl + 1;
            if (i + n > src_len || out + n > dst_cap) return -2;
            std::memcpy(dst + out, src + i, (size_t)n);
            i += n;
            out += n;
        } else if (ctl > 128) {
            int64_t n = 257 - (int64_t)ctl;
            if (i >= src_len || out + n > dst_cap) return -2;
            std::memset(dst + out, src[i], (size_t)n);
            ++i;
            out += n;
        }
        // ctl == 128: no-op
    }
    *out_len = out;
    return 0;
}

}  // extern "C"
