// Minimal PNG decoder: 8/16-bit gray, RGB, RGBA; non-interlaced.
//
// The framework's host-side IO path.  The reference loads images through
// skimage (Python, single-threaded); feeding an accelerator at hundreds of frames
// per second needs decode off the interpreter, so this library decodes
// PNGs natively and the prefetcher (dataset_loader.cpp) pipelines them
// across threads.  zlib supplies inflate; filters and layout are handled
// here (PNG spec: https://www.w3.org/TR/png-3/).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>
#include <zlib.h>

namespace {

struct Reader {
    const uint8_t* p;
    size_t n;
    size_t off = 0;

    bool read(void* dst, size_t k) {
        if (off + k > n) return false;
        std::memcpy(dst, p + off, k);
        off += k;
        return true;
    }
    bool skip(size_t k) {
        if (off + k > n) return false;
        off += k;
        return true;
    }
};

uint32_t be32(const uint8_t* b) {
    return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
           (uint32_t(b[2]) << 8) | uint32_t(b[3]);
}

int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

bool inflate_all(const std::vector<uint8_t>& src, std::vector<uint8_t>& dst) {
    z_stream zs{};
    if (inflateInit(&zs) != Z_OK) return false;
    zs.next_in = const_cast<uint8_t*>(src.data());
    zs.avail_in = static_cast<uInt>(src.size());
    zs.next_out = dst.data();
    zs.avail_out = static_cast<uInt>(dst.size());
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return ret == Z_STREAM_END && zs.avail_out == 0;
}

}  // namespace

extern "C" {

// Parse header only: fills (width, height, channels, bit_depth).
// Returns 0 on success.
int png_probe(const uint8_t* data, long size,
              int* width, int* height, int* channels, int* bit_depth) {
    static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (size < 33 || std::memcmp(data, magic, 8) != 0) return -1;
    if (std::memcmp(data + 12, "IHDR", 4) != 0) return -2;
    *width = static_cast<int>(be32(data + 16));
    *height = static_cast<int>(be32(data + 20));
    int depth = data[24];
    int color = data[25];
    int interlace = data[28];
    if (interlace != 0) return -3;  // Adam7 unsupported
    int ch;
    switch (color) {
        case 0: ch = 1; break;   // gray
        case 2: ch = 3; break;   // rgb
        case 4: ch = 2; break;   // gray+alpha
        case 6: ch = 4; break;   // rgba
        default: return -4;      // palette unsupported
    }
    if (depth != 8 && depth != 16) return -5;
    *channels = ch;
    *bit_depth = depth;
    return 0;
}

// Decode into caller-allocated buffer ``out`` of
// height*width*channels*(bit_depth/8) bytes; 16-bit output is
// NATIVE-endian uint16.  Returns 0 on success.
int png_decode(const uint8_t* data, long size, uint8_t* out) {
    int w, h, ch, depth;
    int rc = png_probe(data, size, &w, &h, &ch, &depth);
    if (rc != 0) return rc;

    // gather IDAT payloads
    std::vector<uint8_t> compressed;
    Reader r{data, static_cast<size_t>(size), 8};
    while (r.off + 8 <= r.n) {
        uint32_t len = be32(data + r.off);
        const uint8_t* type = data + r.off + 4;
        if (r.off + 12 + len > r.n) return -6;
        if (std::memcmp(type, "IDAT", 4) == 0) {
            compressed.insert(compressed.end(), data + r.off + 8,
                              data + r.off + 8 + len);
        } else if (std::memcmp(type, "IEND", 4) == 0) {
            break;
        }
        r.off += 12 + len;
    }
    if (compressed.empty()) return -7;

    const int bytes_per_sample = depth / 8;
    const size_t stride = static_cast<size_t>(w) * ch * bytes_per_sample;
    const int fbpp = ch * bytes_per_sample;  // filter byte offset

    std::vector<uint8_t> raw((stride + 1) * h);
    if (!inflate_all(compressed, raw)) return -8;

    // undo per-scanline filters in place into ``out``
    std::vector<uint8_t> prev(stride, 0);
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = raw.data() + static_cast<size_t>(y) * (stride + 1);
        uint8_t filter = src[0];
        const uint8_t* line = src + 1;
        uint8_t* cur = out + static_cast<size_t>(y) * stride;
        switch (filter) {
            case 0:
                std::memcpy(cur, line, stride);
                break;
            case 1:
                for (size_t i = 0; i < stride; ++i) {
                    uint8_t left = i >= static_cast<size_t>(fbpp)
                                       ? cur[i - fbpp] : 0;
                    cur[i] = static_cast<uint8_t>(line[i] + left);
                }
                break;
            case 2:
                for (size_t i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(line[i] + prev[i]);
                break;
            case 3:
                for (size_t i = 0; i < stride; ++i) {
                    int left = i >= static_cast<size_t>(fbpp)
                                   ? cur[i - fbpp] : 0;
                    cur[i] = static_cast<uint8_t>(
                        line[i] + ((left + prev[i]) >> 1));
                }
                break;
            case 4:
                for (size_t i = 0; i < stride; ++i) {
                    int left = i >= static_cast<size_t>(fbpp)
                                   ? cur[i - fbpp] : 0;
                    int up = prev[i];
                    int ul = i >= static_cast<size_t>(fbpp)
                                 ? prev[i - fbpp] : 0;
                    cur[i] = static_cast<uint8_t>(
                        line[i] + paeth(left, up, ul));
                }
                break;
            default:
                return -9;
        }
        std::memcpy(prev.data(), cur, stride);
    }

    // PNG 16-bit samples are big-endian; swap to native little-endian
    if (depth == 16) {
        size_t total = static_cast<size_t>(w) * h * ch;
        for (size_t i = 0; i < total; ++i) {
            uint8_t hi = out[2 * i];
            out[2 * i] = out[2 * i + 1];
            out[2 * i + 1] = hi;
        }
    }
    return 0;
}

}  // extern "C"
