// sdfio — native image codec for chaq_sdfgen (C ABI, ctypes-bound).
//
// Counterpart of the reference's vendored stb_image /
// stb_image_write layer (reference .gitmodules:1-3, openmp/sdfgen.c:17-20):
// the host-side runtime component stays native C++ while the compute path
// is JAX. Implements the formats the reference emits natively:
// PNG (via zlib), BMP, TGA, and baseline JPEG encode with the -q quality
// knob (openmp/sdfgen.c:327-333 writes JPG via stbi_write_jpg(quality));
// decode covers PNG/BMP/TGA/PNM and converts to the same 2-channel
// gray+alpha buffer stbi_load(..., 2) produces, including stb's integer
// luminance ((r*77 + g*150 + 29*b) >> 8). JPEG decode and exotic PNG
// variants return "unsupported" and the Python layer falls back to PIL.
//
// All entry points return 0 on success, negative on failure; buffers are
// allocated with malloc and released by sdfio_free.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

void sdfio_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

static inline uint8_t stb_luminance(uint8_t r, uint8_t g, uint8_t b) {
    return (uint8_t)(((unsigned)r * 77u + (unsigned)g * 150u + 29u * (unsigned)b) >> 8);
}

static uint32_t rd_be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

static void wr_be32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back((uint8_t)(x >> 24));
    v.push_back((uint8_t)(x >> 16));
    v.push_back((uint8_t)(x >> 8));
    v.push_back((uint8_t)x);
}

static uint16_t rd_le16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }
static uint32_t rd_le32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

// ---------------------------------------------------------------------------
// PNG decode (8/16-bit depth; color types 0 gray, 2 RGB, 3 palette, 4 GA,
// 6 RGBA; sequential or Adam7 interlace). Output: gray+alpha interleaved,
// h*w*2 bytes.
// ---------------------------------------------------------------------------

static int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

int sdfio_decode_png(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 8 || memcmp(data, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
    size_t pos = 8;
    uint32_t width = 0, height = 0;
    int bit_depth = 0, color_type = -1, interlace = 0;
    std::vector<uint8_t> idat;
    std::vector<uint8_t> palette;      // rgb triples
    std::vector<uint8_t> trns;         // per-palette-entry alpha
    bool seen_ihdr = false, seen_iend = false;

    while (pos + 8 <= len && !seen_iend) {
        uint32_t clen = rd_be32(data + pos);
        const uint8_t* ctype = data + pos + 4;
        if (pos + 12 + (size_t)clen > len) return -2;
        const uint8_t* cdata = data + pos + 8;
        if (!memcmp(ctype, "IHDR", 4)) {
            if (clen < 13) return -3;
            width = rd_be32(cdata);
            height = rd_be32(cdata + 4);
            bit_depth = cdata[8];
            color_type = cdata[9];
            interlace = cdata[12];
            seen_ihdr = true;
        } else if (!memcmp(ctype, "PLTE", 4)) {
            palette.assign(cdata, cdata + clen);
        } else if (!memcmp(ctype, "tRNS", 4)) {
            trns.assign(cdata, cdata + clen);
        } else if (!memcmp(ctype, "IDAT", 4)) {
            idat.insert(idat.end(), cdata, cdata + clen);
        } else if (!memcmp(ctype, "IEND", 4)) {
            seen_iend = true;
        }
        pos += 12 + clen;
    }
    if (!seen_ihdr || width == 0 || height == 0) return -3;
    // 8- and 16-bit depths, sequential or Adam7 interlace — the formats
    // stb_image's PNG reader handles (reference O9); 16-bit samples
    // convert to 8 by taking the high (first, big-endian) byte, stb's
    // stbi__convert_16_to_8 rule.
    if (bit_depth != 8 && bit_depth != 16) return -10;  // 1/2/4-bit -> PIL
    if (interlace != 0 && interlace != 1) return -10;
    if (bit_depth == 16 && color_type == 3) return -3;  // invalid per spec
    int ch;
    switch (color_type) {
        case 0: ch = 1; break;
        case 2: ch = 3; break;
        case 3: ch = 1; break;  // palette index
        case 4: ch = 2; break;
        case 6: ch = 4; break;
        default: return -10;
    }
    if (color_type == 3 && palette.empty()) return -3;

    const size_t bps = bit_depth / 8;       // bytes per sample
    const size_t bpp = (size_t)ch * bps;    // filter byte distance

    // pass geometry: one full-frame pass, or the 7 Adam7 sub-images
    struct Pass { uint32_t x0, y0, dx, dy, w, h; };
    Pass passes[7];
    int npass = 0;
    if (interlace == 0) {
        passes[npass++] = {0, 0, 1, 1, width, height};
    } else {
        static const uint32_t X0[7] = {0, 4, 0, 2, 0, 1, 0};
        static const uint32_t Y0[7] = {0, 0, 4, 0, 2, 0, 1};
        static const uint32_t DX[7] = {8, 8, 4, 4, 2, 2, 1};
        static const uint32_t DY[7] = {8, 8, 8, 4, 4, 2, 2};
        for (int p = 0; p < 7; ++p) {
            uint32_t pw = width > X0[p] ? (width - X0[p] + DX[p] - 1) / DX[p] : 0;
            uint32_t ph = height > Y0[p] ? (height - Y0[p] + DY[p] - 1) / DY[p] : 0;
            passes[npass++] = {X0[p], Y0[p], DX[p], DY[p], pw, ph};
        }
    }
    size_t total_raw = 0;
    for (int p = 0; p < npass; ++p)
        if (passes[p].w && passes[p].h)
            total_raw += ((size_t)passes[p].w * bpp + 1) * passes[p].h;

    std::vector<uint8_t> raw(total_raw);
    uLongf raw_len = (uLongf)raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size()) != Z_OK ||
        raw_len != raw.size())
        return -4;

    // de-filter each pass, distribute 8-bit samples into the frame
    size_t stride = (size_t)width * ch;
    std::vector<uint8_t> img(stride * height);
    std::vector<uint8_t> prevrow, currow;
    size_t off = 0;
    for (int p = 0; p < npass; ++p) {
        const Pass& ps = passes[p];
        if (!ps.w || !ps.h) continue;
        size_t rstride = (size_t)ps.w * bpp;
        prevrow.assign(rstride, 0);
        currow.resize(rstride);
        for (uint32_t y = 0; y < ps.h; ++y) {
            const uint8_t* src = raw.data() + off + y * (rstride + 1);
            uint8_t filter = src[0];
            const uint8_t* cur_in = src + 1;
            for (size_t x = 0; x < rstride; ++x) {
                int a = x >= bpp ? currow[x - bpp] : 0;
                int b = prevrow[x];
                int c = x >= bpp ? prevrow[x - bpp] : 0;
                int v = cur_in[x];
                switch (filter) {
                    case 0: break;
                    case 1: v += a; break;
                    case 2: v += b; break;
                    case 3: v += (a + b) / 2; break;
                    case 4: v += paeth(a, b, c); break;
                    default: return -5;
                }
                currow[x] = (uint8_t)v;
            }
            uint8_t* dst = img.data() + (size_t)(ps.y0 + y * ps.dy) * stride;
            for (uint32_t px = 0; px < ps.w; ++px) {
                uint8_t* d = dst + (size_t)(ps.x0 + px * ps.dx) * ch;
                const uint8_t* s = currow.data() + (size_t)px * bpp;
                for (int ci = 0; ci < ch; ++ci)
                    d[ci] = s[(size_t)ci * bps];  // byte 0 = value (8-bit) or high byte (16-bit BE)
            }
            prevrow.swap(currow);
        }
        off += (rstride + 1) * ps.h;
    }

    uint8_t* res = (uint8_t*)malloc((size_t)width * height * 2);
    if (!res) return -6;
    for (size_t i = 0; i < (size_t)width * height; ++i) {
        const uint8_t* p = img.data() + i * ch;
        uint8_t gray, alpha = 255;
        switch (color_type) {
            case 0: gray = p[0]; break;
            case 2: gray = stb_luminance(p[0], p[1], p[2]); break;
            case 3: {
                unsigned idx = p[0];
                if ((size_t)idx * 3 + 2 >= palette.size()) { free(res); return -7; }
                gray = stb_luminance(palette[idx * 3], palette[idx * 3 + 1], palette[idx * 3 + 2]);
                if (idx < trns.size()) alpha = trns[idx];
                break;
            }
            case 4: gray = p[0]; alpha = p[1]; break;
            default: gray = stb_luminance(p[0], p[1], p[2]); alpha = p[3]; break;
        }
        res[i * 2] = gray;
        res[i * 2 + 1] = alpha;
    }
    *out = res;
    *w = (int)width;
    *h = (int)height;
    return 0;
}

// ---------------------------------------------------------------------------
// PNG encode: 8-bit grayscale or gray+alpha, filter 0, one IDAT.
// ---------------------------------------------------------------------------

static void png_chunk(std::vector<uint8_t>& out, const char* type, const uint8_t* data, size_t len) {
    wr_be32(out, (uint32_t)len);
    size_t start = out.size();
    out.insert(out.end(), type, type + 4);
    out.insert(out.end(), data, data + len);
    uint32_t crc = (uint32_t)crc32(0, out.data() + start, (uInt)(len + 4));
    wr_be32(out, crc);
}

static int encode_png(const uint8_t* px, int w, int h, int channels, uint8_t** out,
                      size_t* out_len) {
    if (w <= 0 || h <= 0) return -1;
    const size_t row = (size_t)w * channels;
    std::vector<uint8_t> raw((row + 1) * h);
    for (int y = 0; y < h; ++y) {
        raw[(size_t)y * (row + 1)] = 0;  // filter: none
        memcpy(raw.data() + (size_t)y * (row + 1) + 1, px + (size_t)y * row, row);
    }
    uLongf comp_cap = compressBound((uLong)raw.size());
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 9) != Z_OK) return -2;

    std::vector<uint8_t> png;
    const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    png.insert(png.end(), sig, sig + 8);
    uint8_t ihdr[13];
    ihdr[0] = (uint8_t)(w >> 24); ihdr[1] = (uint8_t)(w >> 16); ihdr[2] = (uint8_t)(w >> 8); ihdr[3] = (uint8_t)w;
    ihdr[4] = (uint8_t)(h >> 24); ihdr[5] = (uint8_t)(h >> 16); ihdr[6] = (uint8_t)(h >> 8); ihdr[7] = (uint8_t)h;
    ihdr[8] = 8;   // bit depth
    ihdr[9] = channels == 2 ? 4 : 0;  // gray+alpha or grayscale
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    png_chunk(png, "IHDR", ihdr, 13);
    png_chunk(png, "IDAT", comp.data(), comp_cap);
    png_chunk(png, "IEND", nullptr, 0);

    uint8_t* res = (uint8_t*)malloc(png.size());
    if (!res) return -3;
    memcpy(res, png.data(), png.size());
    *out = res;
    *out_len = png.size();
    return 0;
}

int sdfio_encode_png(const uint8_t* gray, int w, int h, uint8_t** out, size_t* out_len) {
    return encode_png(gray, w, h, 1, out, out_len);
}

// (H, W, 2) interleaved gray+alpha, the layout sdfio_decode_* produce
int sdfio_encode_png_ga(const uint8_t* ga, int w, int h, uint8_t** out, size_t* out_len) {
    return encode_png(ga, w, h, 2, out, out_len);
}

// ---------------------------------------------------------------------------
// BMP: decode 8bpp-palette / 24bpp / 32bpp uncompressed; encode 24bpp (the
// layout stbi_write_bmp produces for 1-channel input).
// ---------------------------------------------------------------------------

int sdfio_decode_bmp(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 54 || data[0] != 'B' || data[1] != 'M') return -1;
    uint32_t off = rd_le32(data + 10);
    uint32_t hdr_size = rd_le32(data + 14);
    if (hdr_size < 40) return -10;
    int32_t width = (int32_t)rd_le32(data + 18);
    int32_t height_raw = (int32_t)rd_le32(data + 22);
    uint16_t bpp = rd_le16(data + 28);
    uint32_t compression = rd_le32(data + 30);
    if (width <= 0 || height_raw == 0 || compression != 0) return -10;
    int flip = height_raw > 0;
    int height = height_raw > 0 ? height_raw : -height_raw;
    const uint8_t* pal = data + 14 + hdr_size;
    int nch = bpp / 8;
    if (bpp != 8 && bpp != 24 && bpp != 32) return -10;
    size_t row_bytes = (((size_t)width * bpp + 31) / 32) * 4;
    if (off + row_bytes * height > len) return -2;

    uint8_t* res = (uint8_t*)malloc((size_t)width * height * 2);
    if (!res) return -3;
    for (int y = 0; y < height; ++y) {
        int sy = flip ? height - 1 - y : y;
        const uint8_t* row = data + off + row_bytes * (size_t)sy;
        for (int x = 0; x < width; ++x) {
            uint8_t gray, alpha = 255;
            if (bpp == 8) {
                unsigned idx = row[x];
                const uint8_t* pe = pal + idx * 4;  // BGRA palette entries
                gray = stb_luminance(pe[2], pe[1], pe[0]);
            } else {
                const uint8_t* p = row + (size_t)x * nch;  // BGR(A)
                gray = stb_luminance(p[2], p[1], p[0]);
                if (bpp == 32) alpha = p[3];
            }
            res[((size_t)y * width + x) * 2] = gray;
            res[((size_t)y * width + x) * 2 + 1] = alpha;
        }
    }
    *out = res;
    *w = width;
    *h = height;
    return 0;
}

int sdfio_encode_bmp(const uint8_t* gray, int w, int h, uint8_t** out, size_t* out_len) {
    if (w <= 0 || h <= 0) return -1;
    size_t row_bytes = (((size_t)w * 24 + 31) / 32) * 4;
    size_t total = 54 + row_bytes * h;
    uint8_t* res = (uint8_t*)calloc(total, 1);
    if (!res) return -3;
    res[0] = 'B'; res[1] = 'M';
    auto le32 = [&](size_t at, uint32_t v) {
        res[at] = (uint8_t)v; res[at + 1] = (uint8_t)(v >> 8);
        res[at + 2] = (uint8_t)(v >> 16); res[at + 3] = (uint8_t)(v >> 24);
    };
    le32(2, (uint32_t)total);
    le32(10, 54);
    le32(14, 40);
    le32(18, (uint32_t)w);
    le32(22, (uint32_t)h);
    res[26] = 1;           // planes
    res[28] = 24;          // bpp
    for (int y = 0; y < h; ++y) {
        uint8_t* row = res + 54 + row_bytes * (size_t)(h - 1 - y);
        for (int x = 0; x < w; ++x) {
            uint8_t v = gray[(size_t)y * w + x];
            row[x * 3] = v; row[x * 3 + 1] = v; row[x * 3 + 2] = v;
        }
    }
    *out = res;
    *out_len = total;
    return 0;
}

// ---------------------------------------------------------------------------
// TGA: decode type 2 (truecolor) / type 3 (grayscale), bottom- or top-origin,
// uncompressed; encode type 3 grayscale top-origin.
// ---------------------------------------------------------------------------

int sdfio_decode_tga(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 18) return -1;
    uint8_t id_len = data[0], cmap_type = data[1], img_type = data[2];
    if (cmap_type != 0) return -10;
    if (img_type != 2 && img_type != 3) return -10;
    int width = rd_le16(data + 12), height = rd_le16(data + 14);
    int bpp = data[16];
    int top_origin = (data[17] >> 5) & 1;
    if (width <= 0 || height <= 0) return -1;
    int nch;
    if (img_type == 3 && bpp == 8) nch = 1;
    else if (img_type == 2 && bpp == 24) nch = 3;
    else if (img_type == 2 && bpp == 32) nch = 4;
    else return -10;
    size_t need = 18 + (size_t)id_len + (size_t)width * height * nch;
    if (len < need) return -2;
    const uint8_t* px = data + 18 + id_len;

    uint8_t* res = (uint8_t*)malloc((size_t)width * height * 2);
    if (!res) return -3;
    for (int y = 0; y < height; ++y) {
        int sy = top_origin ? y : height - 1 - y;
        for (int x = 0; x < width; ++x) {
            const uint8_t* p = px + ((size_t)sy * width + x) * nch;  // BGR(A)
            uint8_t gray, alpha = 255;
            if (nch == 1) gray = p[0];
            else {
                gray = stb_luminance(p[2], p[1], p[0]);
                if (nch == 4) alpha = p[3];
            }
            res[((size_t)y * width + x) * 2] = gray;
            res[((size_t)y * width + x) * 2 + 1] = alpha;
        }
    }
    *out = res;
    *w = width;
    *h = height;
    return 0;
}

int sdfio_encode_tga(const uint8_t* gray, int w, int h, uint8_t** out, size_t* out_len) {
    if (w <= 0 || h <= 0) return -1;
    size_t total = 18 + (size_t)w * h;
    uint8_t* res = (uint8_t*)calloc(total, 1);
    if (!res) return -3;
    res[2] = 3;                       // grayscale, uncompressed
    res[12] = (uint8_t)w; res[13] = (uint8_t)(w >> 8);
    res[14] = (uint8_t)h; res[15] = (uint8_t)(h >> 8);
    res[16] = 8;                      // bpp
    res[17] = 0x20;                   // top-left origin
    memcpy(res + 18, gray, (size_t)w * h);
    *out = res;
    *out_len = total;
    return 0;
}

// ---------------------------------------------------------------------------
// PNM decode: P2/P5 (PGM ascii/raw) and P3/P6 (PPM), maxval <= 255.
// stb_image reads PNM (openmp/sdfgen.c inherits it via stbi_load).
// ---------------------------------------------------------------------------

static int pnm_token(const uint8_t* d, size_t len, size_t* pos, long* out) {
    // skip whitespace and '#' comments, then parse a decimal integer
    while (*pos < len) {
        uint8_t c = d[*pos];
        if (c == '#') {
            while (*pos < len && d[*pos] != '\n') ++*pos;
        } else if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
            ++*pos;
        } else {
            break;
        }
    }
    if (*pos >= len || d[*pos] < '0' || d[*pos] > '9') return -1;
    long v = 0;
    while (*pos < len && d[*pos] >= '0' && d[*pos] <= '9') {
        v = v * 10 + (d[*pos] - '0');
        if (v > 1 << 30) return -1;
        ++*pos;
    }
    *out = v;
    return 0;
}

int sdfio_decode_pnm(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 2 || data[0] != 'P') return -1;
    int kind = data[1];
    if (kind != '2' && kind != '3' && kind != '5' && kind != '6') return -10;
    int nch = (kind == '3' || kind == '6') ? 3 : 1;
    int raw = (kind == '5' || kind == '6');
    size_t pos = 2;
    long width, height, maxval;
    if (pnm_token(data, len, &pos, &width) || pnm_token(data, len, &pos, &height) ||
        pnm_token(data, len, &pos, &maxval))
        return -2;
    if (width <= 0 || height <= 0 || maxval <= 0 || maxval > 255) return -10;
    size_t n = (size_t)width * height;
    std::vector<uint8_t> px(n * nch);
    if (raw) {
        ++pos;  // single whitespace byte after maxval
        if (pos + n * nch > len) return -2;
        memcpy(px.data(), data + pos, n * nch);
    } else {
        for (size_t i = 0; i < n * (size_t)nch; ++i) {
            long v;
            if (pnm_token(data, len, &pos, &v) || v > maxval) return -2;
            px[i] = (uint8_t)v;
        }
    }
    uint8_t* res = (uint8_t*)malloc(n * 2);
    if (!res) return -3;
    for (size_t i = 0; i < n; ++i) {
        uint8_t g = nch == 1 ? px[i]
                             : stb_luminance(px[i * 3], px[i * 3 + 1], px[i * 3 + 2]);
        if (maxval != 255) g = (uint8_t)((unsigned)g * 255u / (unsigned)maxval);
        res[i * 2] = g;
        res[i * 2 + 1] = 255;
    }
    *out = res;
    *w = (int)width;
    *h = (int)height;
    return 0;
}

// ---------------------------------------------------------------------------
// Baseline JPEG encode: 8-bit grayscale, quality 1..100 via the IJG
// scaling the reference's stbi_write_jpg uses (openmp/sdfgen.c:327-333).
// Annex-K luminance quantization + Huffman tables, plain float FDCT.
// ---------------------------------------------------------------------------

static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static const uint8_t kQBase[64] = {  // Annex K table K.1, natural order
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

static const uint8_t kDcBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kAcBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kAcVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCode {
    uint16_t code[256];
    uint8_t len[256];
};

static void build_huff(const uint8_t bits[17], const uint8_t* vals, int nvals, HuffCode* hc) {
    memset(hc->len, 0, sizeof(hc->len));
    uint16_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l] && k < nvals; ++i, ++k) {
            hc->code[vals[k]] = code++;
            hc->len[vals[k]] = (uint8_t)l;
        }
        code <<= 1;
    }
}

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int nbits = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void put(uint32_t code, int len) {
        acc = (acc << len) | (code & ((1u << len) - 1));
        nbits += len;
        while (nbits >= 8) {
            uint8_t b = (uint8_t)(acc >> (nbits - 8));
            out.push_back(b);
            if (b == 0xff) out.push_back(0x00);  // byte stuffing
            nbits -= 8;
        }
    }
    void flush() {
        if (nbits > 0) put(0x7f, 8 - nbits);  // pad with 1s
    }
};

static int bit_size(int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
        a >>= 1;
        ++n;
    }
    return n;
}

struct DctTab {
    float cs[8][8];
    DctTab() {
        for (int u = 0; u < 8; ++u)
            for (int x = 0; x < 8; ++x)
                cs[u][x] = (float)(cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0) *
                                   (u == 0 ? 0.353553390593273762 : 0.5));  // C(u)/2
    }
};

static void fdct8x8(float blk[64]) {
    // separable direct DCT-II with JPEG normalization: rows then columns
    static const DctTab tab;  // magic static: thread-safe init
    const auto& cs = tab.cs;
    float tmp[64];
    for (int y = 0; y < 8; ++y)
        for (int u = 0; u < 8; ++u) {
            float s = 0;
            for (int x = 0; x < 8; ++x) s += blk[y * 8 + x] * cs[u][x];
            tmp[y * 8 + u] = s;
        }
    for (int u = 0; u < 8; ++u)
        for (int v = 0; v < 8; ++v) {
            float s = 0;
            for (int y = 0; y < 8; ++y) s += tmp[y * 8 + u] * cs[v][y];
            blk[v * 8 + u] = s;
        }
}

static void wr_marker(std::vector<uint8_t>& o, uint8_t m, const uint8_t* d, size_t len) {
    o.push_back(0xff);
    o.push_back(m);
    o.push_back((uint8_t)((len + 2) >> 8));
    o.push_back((uint8_t)(len + 2));
    o.insert(o.end(), d, d + len);
}

int sdfio_encode_jpg(const uint8_t* gray, int w, int h, int quality, uint8_t** out,
                     size_t* out_len) {
    if (w <= 0 || h <= 0) return -1;
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;  // IJG/stb
    uint8_t qtab[64];
    for (int i = 0; i < 64; ++i) {
        int q = (kQBase[i] * scale + 50) / 100;
        qtab[i] = (uint8_t)(q < 1 ? 1 : (q > 255 ? 255 : q));
    }

    HuffCode dc, ac;
    build_huff(kDcBits, kDcVals, 12, &dc);
    build_huff(kAcBits, kAcVals, 162, &ac);

    std::vector<uint8_t> o;
    o.push_back(0xff);
    o.push_back(0xd8);  // SOI
    static const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    wr_marker(o, 0xe0, jfif, sizeof(jfif));
    uint8_t dqt[65];
    dqt[0] = 0;  // 8-bit, table 0
    for (int i = 0; i < 64; ++i) dqt[1 + i] = qtab[kZigzag[i]];  // zigzag order
    wr_marker(o, 0xdb, dqt, 65);
    uint8_t sof[] = {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w,
                     1, 1, 0x11, 0};
    wr_marker(o, 0xc0, sof, sizeof(sof));
    {
        std::vector<uint8_t> dht;
        dht.push_back(0x00);  // DC table 0
        dht.insert(dht.end(), kDcBits + 1, kDcBits + 17);
        dht.insert(dht.end(), kDcVals, kDcVals + 12);
        dht.push_back(0x10);  // AC table 0
        dht.insert(dht.end(), kAcBits + 1, kAcBits + 17);
        dht.insert(dht.end(), kAcVals, kAcVals + 162);
        wr_marker(o, 0xc4, dht.data(), dht.size());
    }
    static const uint8_t sos[] = {1, 1, 0x00, 0, 63, 0};
    wr_marker(o, 0xda, sos, sizeof(sos));

    BitWriter bw(o);
    int prev_dc = 0;
    for (int by = 0; by < h; by += 8) {
        for (int bx = 0; bx < w; bx += 8) {
            float blk[64];
            for (int y = 0; y < 8; ++y) {
                int sy = by + y < h ? by + y : h - 1;  // edge replication
                for (int x = 0; x < 8; ++x) {
                    int sx = bx + x < w ? bx + x : w - 1;
                    blk[y * 8 + x] = (float)gray[(size_t)sy * w + sx] - 128.0f;
                }
            }
            fdct8x8(blk);
            int q[64];
            for (int i = 0; i < 64; ++i) {
                float v = blk[kZigzag[i]] / (float)qtab[kZigzag[i]];
                q[i] = (int)(v < 0 ? v - 0.5f : v + 0.5f);
            }
            // DC
            int diff = q[0] - prev_dc;
            prev_dc = q[0];
            int sz = bit_size(diff);
            bw.put(dc.code[sz], dc.len[sz]);
            if (sz) bw.put((uint32_t)(diff < 0 ? diff + (1 << sz) - 1 : diff), sz);
            // AC: run-length of zeros, ZRL for 16, EOB
            int last = 63;
            while (last > 0 && q[last] == 0) --last;
            int run = 0;
            for (int i = 1; i <= last; ++i) {
                if (q[i] == 0) {
                    ++run;
                    continue;
                }
                while (run >= 16) {
                    bw.put(ac.code[0xf0], ac.len[0xf0]);
                    run -= 16;
                }
                int s = bit_size(q[i]);
                int sym = (run << 4) | s;
                bw.put(ac.code[sym], ac.len[sym]);
                bw.put((uint32_t)(q[i] < 0 ? q[i] + (1 << s) - 1 : q[i]), s);
                run = 0;
            }
            if (last < 63) bw.put(ac.code[0x00], ac.len[0x00]);  // EOB
        }
    }
    bw.flush();
    o.push_back(0xff);
    o.push_back(0xd9);  // EOI

    uint8_t* res = (uint8_t*)malloc(o.size());
    if (!res) return -3;
    memcpy(res, o.data(), o.size());
    *out = res;
    *out_len = o.size();
    return 0;
}

// ---------------------------------------------------------------------------
// PSD decode: composite image of 8-bit grayscale/RGB PSDs, raw or RLE
// (PackBits) — the slice of the format stb_image reads. 16-bit depth,
// CMYK/duotone and absent composites return -20 (PIL fallback).
// ---------------------------------------------------------------------------

int sdfio_decode_psd(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 26 + 4 || memcmp(data, "8BPS", 4) != 0) return -1;
    if (((data[4] << 8) | data[5]) != 1) return -20;  // version
    int channels = (data[12] << 8) | data[13];
    uint32_t height = rd_be32(data + 14);
    uint32_t width = rd_be32(data + 18);
    int depth = (data[22] << 8) | data[23];
    int mode = (data[24] << 8) | data[25];
    if (depth != 8) return -20;
    if (mode != 1 && mode != 3) return -20;  // grayscale / RGB only
    if (width == 0 || height == 0 || width > 1u << 24 || height > 1u << 24) return -2;
    if (channels < 1 || channels > 16) return -2;
    size_t pos = 26;
    for (int s = 0; s < 3; ++s) {  // color mode data, resources, layers
        if (pos + 4 > len) return -2;
        uint32_t n = rd_be32(data + pos);
        pos += 4 + n;
        if (pos > len) return -2;
    }
    if (pos + 2 > len) return -2;
    int compression = (data[pos] << 8) | data[pos + 1];
    pos += 2;
    size_t npx = (size_t)width * height;
    int nch = channels > 4 ? 4 : channels;
    std::vector<uint8_t> plane(npx * nch);
    if (compression == 0) {
        if (pos + npx * channels > len) return -2;
        for (int c = 0; c < nch; ++c)
            memcpy(plane.data() + (size_t)c * npx, data + pos + (size_t)c * npx, npx);
    } else if (compression == 1) {
        // PackBits RLE: u16BE byte count per (channel, row), then streams
        size_t tab = pos;
        pos += (size_t)channels * height * 2;
        if (pos > len) return -2;
        for (int c = 0; c < channels; ++c) {
            for (uint32_t y = 0; y < height; ++y) {
                size_t rowlen = ((size_t)data[tab] << 8) | data[tab + 1];
                tab += 2;
                size_t end = pos + rowlen;
                if (end > len) return -2;
                if (c < nch) {
                    uint8_t* dst = plane.data() + (size_t)c * npx + (size_t)y * width;
                    size_t xo = 0;
                    while (pos < end && xo < width) {
                        int8_t n = (int8_t)data[pos++];
                        if (n >= 0) {
                            size_t cnt = (size_t)n + 1;
                            if (pos + cnt > end || xo + cnt > width) return -2;
                            memcpy(dst + xo, data + pos, cnt);
                            pos += cnt;
                            xo += cnt;
                        } else if (n != -128) {
                            size_t cnt = (size_t)(1 - n);
                            if (pos >= end || xo + cnt > width) return -2;
                            memset(dst + xo, data[pos++], cnt);
                            xo += cnt;
                        }
                    }
                }
                pos = end;
            }
        }
    } else {
        return -20;
    }
    uint8_t* res = (uint8_t*)malloc(npx * 2);
    if (!res) return -3;
    for (size_t i = 0; i < npx; ++i) {
        uint8_t g, a = 255;
        if (mode == 1) {
            g = plane[i];
            if (nch >= 2) a = plane[npx + i];
        } else {
            uint8_t r = plane[i];
            uint8_t gg = nch >= 2 ? plane[npx + i] : r;
            uint8_t b = nch >= 3 ? plane[2 * npx + i] : r;
            g = stb_luminance(r, gg, b);
            if (nch >= 4) a = plane[3 * npx + i];
        }
        res[i * 2] = g;
        res[i * 2 + 1] = a;
    }
    *out = res;
    *w = (int)width;
    *h = (int)height;
    return 0;
}

// ---------------------------------------------------------------------------
// Radiance HDR (RGBE) decode with stb's HDR->LDR conversion
// (pow(x, 1/2.2)*255 + 0.5, scale 1) then stb luminance. Supports the
// standard "-Y h +X w" orientation, flat and new-style (2,2) RLE
// scanlines; old-style RLE returns -20.
// ---------------------------------------------------------------------------

static uint8_t hdr_ldr(float f) {
    float z = powf(f, 1.0f / 2.2f) * 255.0f + 0.5f;
    return (uint8_t)(z < 0 ? 0 : (z > 255 ? 255 : z));
}

int sdfio_decode_hdr(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 11 || data[0] != '#' || data[1] != '?') return -1;
    size_t pos = 0;
    // header lines until the blank line
    bool fmt_ok = false;
    while (pos < len) {
        size_t eol = pos;
        while (eol < len && data[eol] != '\n') ++eol;
        if (eol == pos) {
            ++pos;
            break;  // blank line: header done
        }
        std::string line((const char*)data + pos, eol - pos);
        if (line.find("FORMAT=32-bit_rle_rgbe") != std::string::npos) fmt_ok = true;
        pos = eol + 1;
    }
    if (!fmt_ok) return -20;
    // resolution line
    size_t eol = pos;
    while (eol < len && data[eol] != '\n') ++eol;
    std::string res_line((const char*)data + pos, eol - pos);
    int width = 0, height = 0;
    if (sscanf(res_line.c_str(), "-Y %d +X %d", &height, &width) != 2) return -20;
    if (width <= 0 || height <= 0) return -2;
    pos = eol + 1;

    std::vector<uint8_t> rgbe((size_t)width * height * 4);
    for (int y = 0; y < height; ++y) {
        uint8_t* row = rgbe.data() + (size_t)y * width * 4;
        if (pos + 4 > len) return -2;
        if (width >= 8 && width < 32768 && data[pos] == 2 && data[pos + 1] == 2 &&
            ((data[pos + 2] << 8) | data[pos + 3]) == width) {
            pos += 4;  // new-style RLE: 4 per-component streams
            for (int c = 0; c < 4; ++c) {
                int x = 0;
                while (x < width) {
                    if (pos >= len) return -2;
                    int cnt = data[pos++];
                    if (cnt > 128) {  // run
                        cnt -= 128;
                        if (pos >= len || x + cnt > width) return -2;
                        uint8_t v = data[pos++];
                        for (int i = 0; i < cnt; ++i) row[(x + i) * 4 + c] = v;
                        x += cnt;
                    } else {  // literals
                        if (cnt == 0 || pos + cnt > len || x + cnt > width) return -2;
                        for (int i = 0; i < cnt; ++i) row[(x + i) * 4 + c] = data[pos++];
                        x += cnt;
                    }
                }
            }
        } else {
            if (data[pos] == 1 && data[pos + 1] == 1 && data[pos + 2] == 1)
                return -20;  // old-style RLE: rare, PIL/None fallback
            if (pos + (size_t)width * 4 > len) return -2;
            memcpy(row, data + pos, (size_t)width * 4);
            pos += (size_t)width * 4;
        }
    }
    uint8_t* res = (uint8_t*)malloc((size_t)width * height * 2);
    if (!res) return -3;
    for (size_t i = 0; i < (size_t)width * height; ++i) {
        const uint8_t* p = rgbe.data() + i * 4;
        uint8_t r8 = 0, g8 = 0, b8 = 0;
        if (p[3] != 0) {
            float s = ldexpf(1.0f, (int)p[3] - (128 + 8));
            r8 = hdr_ldr(p[0] * s);
            g8 = hdr_ldr(p[1] * s);
            b8 = hdr_ldr(p[2] * s);
        }
        res[i * 2] = stb_luminance(r8, g8, b8);
        res[i * 2 + 1] = 255;
    }
    *out = res;
    *w = width;
    *h = height;
    return 0;
}

// ---------------------------------------------------------------------------
// Softimage PIC decode (the last stb_image input format the framework
// reads: the reference's openmp/sdfgen.c:252-256 inherits it). Written
// from the published format description: 104-byte header (magic
// 0x5380f634, version float, 80-byte comment, "PICT", u16be w/h, ratio,
// fields, pad) then chained 4-byte channel packets
// {chained, size(bits), type, channel-mask RGBA=0x80/40/20/10} and
// ---------------------------------------------------------------------------
// GIF decode — raster only, FIRST frame (stb_image reads GIF, so the
// reference binaries do: openmp/sdfgen.c:252-256 inherits stb's full
// decoder set). GIF87a/89a, variable-code LZW, global/local color
// tables, interlace, GCE transparency (transparent pixels -> alpha 0).
// The first frame is composited onto a screen-sized canvas initialized
// transparent; animation beyond frame 1 stays on the PIL fallback.
// ---------------------------------------------------------------------------

int sdfio_decode_gif(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 13) return -1;
    if (memcmp(data, "GIF87a", 6) != 0 && memcmp(data, "GIF89a", 6) != 0) return -1;
    int sw = rd_le16(data + 6), sh = rd_le16(data + 8);
    if (sw <= 0 || sh <= 0 || (int64_t)sw * sh > (int64_t)1 << 30) return -2;
    uint8_t flags = data[10];
    size_t pos = 13;
    uint8_t gct[256][3];
    int gct_n = 0;
    if (flags & 0x80) {
        gct_n = 2 << (flags & 7);
        if (pos + (size_t)gct_n * 3 > len) return -3;
        for (int i = 0; i < gct_n; i++) {
            gct[i][0] = data[pos + 3 * i];
            gct[i][1] = data[pos + 3 * i + 1];
            gct[i][2] = data[pos + 3 * i + 2];
        }
        pos += (size_t)gct_n * 3;
    }
    int transparent = -1;
    while (pos < len) {
        uint8_t b = data[pos++];
        if (b == 0x3b) return -4;  // trailer before any image
        if (b == 0x21) {           // extension: label + sub-blocks
            if (pos >= len) return -3;
            uint8_t label = data[pos++];
            if (label == 0xf9 && pos + 5 < len && data[pos] == 4) {
                if (data[pos + 1] & 1) transparent = data[pos + 4];
            }
            while (pos < len && data[pos] != 0) pos += 1 + data[pos];
            if (pos >= len) return -3;
            pos++;  // block terminator
            continue;
        }
        if (b != 0x2c) return -5;  // not an image descriptor
        if (pos + 9 > len) return -3;
        int fx = rd_le16(data + pos), fy = rd_le16(data + pos + 2);
        int fw = rd_le16(data + pos + 4), fh = rd_le16(data + pos + 6);
        uint8_t iflags = data[pos + 8];
        pos += 9;
        uint8_t lct[256][3];
        const uint8_t(*pal)[3] = gct;
        int pal_n = gct_n;
        if (iflags & 0x80) {
            int n = 2 << (iflags & 7);
            if (pos + (size_t)n * 3 > len) return -3;
            for (int i = 0; i < n; i++) {
                lct[i][0] = data[pos + 3 * i];
                lct[i][1] = data[pos + 3 * i + 1];
                lct[i][2] = data[pos + 3 * i + 2];
            }
            pos += (size_t)n * 3;
            pal = lct;
            pal_n = n;
        }
        if (pal_n == 0) return -6;
        if (fx < 0 || fy < 0 || fw <= 0 || fh <= 0 || fx + fw > sw || fy + fh > sh)
            return -7;
        if (pos >= len) return -3;
        int min_code = data[pos++];
        if (min_code < 1 || min_code > 11) return -8;

        // gather the LZW sub-blocks into one contiguous stream
        std::vector<uint8_t> lzw;
        while (pos < len && data[pos] != 0) {
            uint8_t n = data[pos++];
            if (pos + n > len) return -3;
            lzw.insert(lzw.end(), data + pos, data + pos + n);
            pos += n;
        }

        // LZW decode into the frame's index raster (textbook GIF LZW:
        // variable code width, clear/EOI, the KwKwK code == next case)
        std::vector<uint8_t> idx((size_t)fw * fh, 0);
        {
            const int clear = 1 << min_code;
            const int eoi = clear + 1;
            std::vector<int16_t> prefix(4096, -1);
            std::vector<uint8_t> suffix(4096), first(4096);
            for (int i = 0; i < clear; i++) {
                suffix[i] = first[i] = (uint8_t)i;
            }
            int next = eoi + 1, width = min_code + 1;
            uint32_t acc = 0;
            int nbits = 0;
            size_t bp = 0, outp = 0;
            int prev = -1;
            std::vector<uint8_t> expand;
            auto emit = [&](int code) {  // append string(code) to idx
                expand.clear();
                int c = code;
                while (c >= clear) {
                    expand.push_back(suffix[c]);
                    c = prefix[c];
                }
                expand.push_back(suffix[c]);
                for (size_t i = expand.size(); i-- > 0;)
                    if (outp < idx.size()) idx[outp++] = expand[i];
            };
            while (outp < idx.size()) {
                while (nbits < width && bp < lzw.size()) {
                    acc |= (uint32_t)lzw[bp++] << nbits;
                    nbits += 8;
                }
                if (nbits < width) break;  // stream exhausted
                int code = (int)(acc & ((1u << width) - 1));
                acc >>= width;
                nbits -= width;
                if (code == clear) {
                    next = eoi + 1;
                    width = min_code + 1;
                    prev = -1;
                    continue;
                }
                if (code == eoi) break;
                if (prev < 0) {
                    if (code >= clear) return -9;  // first code must be a root
                    emit(code);
                    prev = code;
                } else {
                    if (code > next) return -9;
                    if (code == next) {
                        // KwKwK: string(prev) + first(prev)
                        if (next >= 4096) return -9;
                        prefix[next] = (int16_t)prev;
                        suffix[next] = first[prev];
                        first[next] = first[prev];
                        emit(next);
                        next++;
                    } else {
                        if (next < 4096) {
                            prefix[next] = (int16_t)prev;
                            suffix[next] = first[code];
                            first[next] = first[prev];
                            next++;
                        }
                        emit(code);
                    }
                    prev = code;
                }
                if (next == (1 << width) && width < 12) width++;
            }
        }

        // composite onto the canvas (transparent-initialized), honoring
        // interlace row order
        uint8_t* buf = (uint8_t*)malloc((size_t)sw * sh * 2);
        if (!buf) return -10;
        memset(buf, 0, (size_t)sw * sh * 2);  // gray 0, alpha 0
        static const int ioff[4] = {0, 4, 2, 1};
        static const int istep[4] = {8, 8, 4, 2};
        size_t src = 0;
        if (iflags & 0x40) {
            for (int p = 0; p < 4; p++)
                for (int y = ioff[p]; y < fh; y += istep[p]) {
                    for (int x = 0; x < fw; x++) {
                        uint8_t ci = idx[src + (size_t)x];
                        uint8_t* px = buf + (((size_t)(fy + y) * sw) + fx + x) * 2;
                        if ((int)ci == transparent) {
                            px[0] = 0;
                            px[1] = 0;
                        } else {
                            const uint8_t* c = pal[ci < pal_n ? ci : 0];
                            px[0] = stb_luminance(c[0], c[1], c[2]);
                            px[1] = 255;
                        }
                    }
                    src += (size_t)fw;
                }
        } else {
            for (int y = 0; y < fh; y++)
                for (int x = 0; x < fw; x++) {
                    uint8_t ci = idx[(size_t)y * fw + x];
                    uint8_t* px = buf + (((size_t)(fy + y) * sw) + fx + x) * 2;
                    if ((int)ci == transparent) {
                        px[0] = 0;
                        px[1] = 0;
                    } else {
                        const uint8_t* c = pal[ci < pal_n ? ci : 0];
                        px[0] = stb_luminance(c[0], c[1], c[2]);
                        px[1] = 255;
                    }
                }
        }
        *out = buf;
        *w = sw;
        *h = sh;
        return 0;  // first frame only
    }
    return -3;
}

// per-scanline per-packet streams: type 0 raw, 1 pure RLE
// (count, pixel), 2 mixed RLE (count<128: count+1 literals; 128:
// u16be count + pixel; >128: count-127 + pixel). Missing channels stay
// 255 (stb semantics); output is the codec's gray+alpha pair.
// ---------------------------------------------------------------------------

int sdfio_decode_pic(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 104 + 4) return -1;
    if (!(data[0] == 0x53 && data[1] == 0x80 && data[2] == 0xf6 && data[3] == 0x34))
        return -1;
    if (memcmp(data + 88, "PICT", 4) != 0) return -1;
    uint32_t width = ((uint32_t)data[92] << 8) | data[93];
    uint32_t height = ((uint32_t)data[94] << 8) | data[95];
    if (width == 0 || height == 0 || width > 1u << 16 || height > 1u << 16) return -2;
    size_t pos = 104;

    struct Packet {
        int type;
        uint8_t mask;
        int nch;
    };
    Packet packets[10];
    int npk = 0;
    int chained = 1;
    while (chained) {
        if (npk >= 10 || pos + 4 > len) return -2;
        chained = data[pos];
        int size = data[pos + 1];
        int type = data[pos + 2];
        uint8_t mask = data[pos + 3];
        pos += 4;
        if (size != 8) return -20;  // only 8-bit channels (stb too)
        if (type != 0 && type != 1 && type != 2) return -20;
        int nch = 0;
        for (uint8_t m = 0x80; m >= 0x10; m >>= 1)
            if (mask & m) ++nch;
        if (nch == 0 || nch > 4) return -2;
        packets[npk++] = {type, mask, nch};
    }

    size_t npx = (size_t)width * height;
    std::vector<uint8_t> rgba(npx * 4, 0xff);  // absent channels stay 255
    std::vector<uint8_t> px(4);
    for (uint32_t y = 0; y < height; ++y) {
        uint8_t* row = rgba.data() + (size_t)y * width * 4;
        for (int p = 0; p < npk; ++p) {
            const Packet& pk = packets[p];
            int chidx[4];
            int nch = 0;
            const uint8_t codes[4] = {0x80, 0x40, 0x20, 0x10};
            for (int c = 0; c < 4; ++c)
                if (pk.mask & codes[c]) chidx[nch++] = c;
            auto put = [&](uint32_t x) {
                for (int c = 0; c < nch; ++c) row[x * 4 + chidx[c]] = px[c];
            };
            auto rdpx = [&]() -> bool {
                if (pos + (size_t)nch > len) return false;
                for (int c = 0; c < nch; ++c) px[c] = data[pos++];
                return true;
            };
            if (pk.type == 0) {  // uncompressed
                for (uint32_t x = 0; x < width; ++x) {
                    if (!rdpx()) return -2;
                    put(x);
                }
            } else if (pk.type == 1) {  // pure run length
                uint32_t x = 0;
                while (x < width) {
                    if (pos >= len) return -2;
                    uint32_t count = data[pos++];
                    if (count == 0) return -2;
                    if (count > width - x) count = width - x;
                    if (!rdpx()) return -2;
                    for (uint32_t i = 0; i < count; ++i) put(x + i);
                    x += count;
                }
            } else {  // mixed run length
                uint32_t x = 0;
                while (x < width) {
                    if (pos >= len) return -2;
                    uint32_t count = data[pos++];
                    if (count >= 128) {
                        if (count == 128) {
                            if (pos + 2 > len) return -2;
                            count = ((uint32_t)data[pos] << 8) | data[pos + 1];
                            pos += 2;
                        } else {
                            count -= 127;
                        }
                        if (count > width - x) return -2;
                        if (!rdpx()) return -2;
                        for (uint32_t i = 0; i < count; ++i) put(x + i);
                        x += count;
                    } else {
                        count += 1;
                        if (count > width - x) return -2;
                        for (uint32_t i = 0; i < count; ++i) {
                            if (!rdpx()) return -2;
                            put(x + i);
                        }
                        x += count;
                    }
                }
            }
        }
    }

    uint8_t* res = (uint8_t*)malloc(npx * 2);
    if (!res) return -3;
    for (size_t i = 0; i < npx; ++i) {
        const uint8_t* q = rgba.data() + i * 4;
        res[i * 2] = stb_luminance(q[0], q[1], q[2]);
        res[i * 2 + 1] = q[3];
    }
    *out = res;
    *w = (int)width;
    *h = (int)height;
    return 0;
}

// ---------------------------------------------------------------------------
// Baseline JPEG decode: sequential DCT, 8-bit precision, 1-3 components,
// subsampling factors 1 and 2, restart markers. Float separable IDCT
// (exact mirror of the encoder's FDCT basis), libjpeg-style triangle
// ("fancy") chroma upsampling, JFIF YCbCr -> stb integer luminance.
// Progressive (SOF2) / arithmetic / 12-bit inputs return -20 and the
// Python layer falls back to PIL — same split the reference's stb layer
// has between its decoder and unsupported variants.
// ---------------------------------------------------------------------------

namespace {

struct JDHuff {
    // spec F.2.2.3 decode tables built from the DHT BITS/HUFFVAL lists
    uint8_t vals[256];
    int32_t mincode[17];
    int32_t maxcode[18];
    int32_t valptr[17];
    bool defined = false;

    void prepare(const uint8_t bits[17]) {
        int code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            valptr[l] = k;
            mincode[l] = code;
            code += bits[l];
            k += bits[l];
            maxcode[l] = code - 1;
            if (bits[l] == 0) maxcode[l] = -1;
            code <<= 1;
        }
        maxcode[17] = 0x7fffffff;  // sentinel
        defined = true;
    }
};

struct JDBits {
    const uint8_t* d;
    size_t len;
    size_t pos;
    uint32_t acc = 0;
    int n = 0;
    int pending_marker = 0;  // 0xD0.. seen inside entropy data
    bool truncated = false;

    int next_bit() {
        if (n == 0) {
            if (pending_marker || pos >= len) {
                truncated = true;
                return 0;  // pad (spec: decoder may pad a truncated stream)
            }
            uint8_t b = d[pos++];
            if (b == 0xff) {
                uint8_t m = pos < len ? d[pos] : 0xd9;
                if (m == 0x00) {
                    ++pos;  // stuffed 0xff data byte
                } else {
                    pending_marker = m;
                    truncated = m == 0xd9 ? truncated : truncated;
                    return 0;
                }
            }
            acc = b;
            n = 8;
        }
        --n;
        return (acc >> n) & 1;
    }

    void byte_align() { n = 0; }
};

static int jd_decode(JDBits& br, const JDHuff& h) {
    // spec F.2.2.3 DECODE
    int code = br.next_bit();
    int l = 1;
    while (code > h.maxcode[l]) {
        code = (code << 1) | br.next_bit();
        ++l;
        if (l > 16) return -1;
    }
    return h.vals[h.valptr[l] + code - h.mincode[l]];
}

static int jd_receive_extend(JDBits& br, int s) {
    if (s == 0) return 0;
    int v = 0;
    for (int i = 0; i < s; ++i) v = (v << 1) | br.next_bit();
    if (v < (1 << (s - 1))) v += (int)(~0u << s) + 1;  // EXTEND (F.2.2.1)
    return v;
}

static void idct8x8(const int coef[64], const uint16_t qt[64], uint8_t* out, int stride) {
    // separable inverse of the encoder's fdct8x8 (same cosine/scale table)
    static const DctTab tab;
    const auto& cs = tab.cs;
    float dq[64], tmp[64];
    for (int i = 0; i < 64; ++i) dq[i] = (float)coef[i] * (float)qt[i];
    for (int v = 0; v < 8; ++v)  // columns: sum over v of cs[v][y]
        for (int x = 0; x < 8; ++x) {
            float s = 0;
            for (int u = 0; u < 8; ++u) s += dq[u * 8 + x] * cs[u][v];
            tmp[v * 8 + x] = s;
        }
    for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) {
            float s = 0;
            for (int u = 0; u < 8; ++u) s += tmp[y * 8 + u] * cs[u][x];
            int p = (int)lrintf(s + 128.0f);
            out[y * stride + x] = (uint8_t)(p < 0 ? 0 : (p > 255 ? 255 : p));
        }
}

// libjpeg-style fancy (triangle) 2x upsampling along one dimension:
// out[2i] = (3*in[i] + in[i-1] + 2) >> 2, out[2i+1] = (3*in[i] + in[i+1] + 1) >> 2
static void upsample2_row(const uint8_t* in, int n, uint8_t* out) {
    for (int i = 0; i < n; ++i) {
        int prev = in[i > 0 ? i - 1 : 0], cur = in[i], nxt = in[i + 1 < n ? i + 1 : n - 1];
        out[2 * i] = (uint8_t)((3 * cur + prev + 2) >> 2);
        out[2 * i + 1] = (uint8_t)((3 * cur + nxt + 1) >> 2);
    }
}

struct JComp {
    int id = 0, hs = 1, vs = 1, tq = 0, td = 0, ta = 0;
    int bw = 0, bh = 0;          // blocks across/down for this component
    std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
};

}  // namespace

int sdfio_decode_jpg(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h) {
    if (len < 4 || data[0] != 0xff || data[1] != 0xd8) return -1;
    size_t pos = 2;
    uint16_t qt[4][64] = {};
    bool qt_def[4] = {};
    JDHuff hdc[4], hac[4];
    JComp comp[3];
    int ncomp = 0, width = 0, height = 0, dri = 0;
    bool have_sof = false;

    auto rd16 = [&](size_t p) { return (int)((data[p] << 8) | data[p + 1]); };

    while (pos + 4 <= len) {
        if (data[pos] != 0xff) return -2;
        uint8_t m = data[pos + 1];
        if (m == 0xd8 || (m >= 0xd0 && m <= 0xd7) || m == 0x01) {
            pos += 2;
            continue;
        }
        if (m == 0xd9) break;  // EOI before SOS: no image
        int seglen = rd16(pos + 2);
        if (seglen < 2 || pos + 2 + seglen > len) return -2;
        const uint8_t* seg = data + pos + 4;
        int segn = seglen - 2;
        if (m == 0xdb) {  // DQT
            int i = 0;
            while (i < segn) {
                int pq = seg[i] >> 4, tq_ = seg[i] & 15;
                ++i;
                if (tq_ > 3) return -2;
                if (pq == 1) {
                    if (i + 128 > segn) return -2;
                    for (int k = 0; k < 64; ++k, i += 2)
                        qt[tq_][kZigzag[k]] = (uint16_t)((seg[i] << 8) | seg[i + 1]);
                } else {
                    if (i + 64 > segn) return -2;
                    for (int k = 0; k < 64; ++k, ++i) qt[tq_][kZigzag[k]] = seg[i];
                }
                qt_def[tq_] = true;
            }
        } else if (m == 0xc4) {  // DHT
            int i = 0;
            while (i + 17 <= segn) {
                int tc = seg[i] >> 4, th = seg[i] & 15;
                ++i;
                if (tc > 1 || th > 3) return -2;
                uint8_t bits[17] = {0};
                int total = 0;
                for (int l = 1; l <= 16; ++l) {
                    bits[l] = seg[i + l - 1];
                    total += bits[l];
                }
                i += 16;
                if (total > 256 || i + total > segn) return -2;
                JDHuff& hh = tc == 0 ? hdc[th] : hac[th];
                memcpy(hh.vals, seg + i, total);
                hh.prepare(bits);
                i += total;
            }
        } else if (m == 0xc0 || m == 0xc1) {  // SOF0/1: baseline sequential
            if (segn < 6) return -2;
            if (seg[0] != 8) return -20;  // 12-bit: unsupported
            height = (seg[1] << 8) | seg[2];
            width = (seg[3] << 8) | seg[4];
            ncomp = seg[5];
            if (width <= 0 || height <= 0) return -2;
            if (ncomp != 1 && ncomp != 3) return -20;
            if (segn < 6 + ncomp * 3) return -2;
            for (int c = 0; c < ncomp; ++c) {
                comp[c].id = seg[6 + c * 3];
                comp[c].hs = seg[7 + c * 3] >> 4;
                comp[c].vs = seg[7 + c * 3] & 15;
                comp[c].tq = seg[8 + c * 3];
                if (comp[c].hs < 1 || comp[c].hs > 2 || comp[c].vs < 1 || comp[c].vs > 2)
                    return -20;  // subsampling beyond 2x: unsupported
                if (comp[c].tq > 3) return -2;
            }
            have_sof = true;
        } else if (m == 0xc2 || (m >= 0xc5 && m <= 0xc7) || (m >= 0xc9 && m <= 0xcf)) {
            return -20;  // progressive / arithmetic / hierarchical
        } else if (m == 0xdd) {  // DRI
            if (segn < 2) return -2;
            dri = (seg[0] << 8) | seg[1];
        } else if (m == 0xda) {  // SOS — entropy data follows
            if (!have_sof) return -2;
            int ns = seg[0];
            if (ns != ncomp || segn < 1 + ns * 2 + 3) return -20;  // multi-scan: unsupported
            for (int s = 0; s < ns; ++s) {
                int cid = seg[1 + s * 2];
                int c = -1;
                for (int k = 0; k < ncomp; ++k)
                    if (comp[k].id == cid) c = k;
                if (c < 0) return -2;
                comp[c].td = seg[2 + s * 2] >> 4;
                comp[c].ta = seg[2 + s * 2] & 15;
            }
            pos += 2 + seglen;

            int hmax = 1, vmax = 1;
            for (int c = 0; c < ncomp; ++c) {
                hmax = comp[c].hs > hmax ? comp[c].hs : hmax;
                vmax = comp[c].vs > vmax ? comp[c].vs : vmax;
            }
            int mcux = (width + 8 * hmax - 1) / (8 * hmax);
            int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
            for (int c = 0; c < ncomp; ++c) {
                comp[c].bw = mcux * comp[c].hs;
                comp[c].bh = mcuy * comp[c].vs;
                comp[c].plane.assign((size_t)comp[c].bw * 8 * comp[c].bh * 8, 0);
                if (!qt_def[comp[c].tq]) return -2;
                if (!hdc[comp[c].td].defined || !hac[comp[c].ta].defined) return -2;
            }

            JDBits br{data, len, pos};
            int pred[3] = {0, 0, 0};
            int mcu_count = 0;
            for (int my = 0; my < mcuy; ++my) {
                for (int mx = 0; mx < mcux; ++mx) {
                    if (dri > 0 && mcu_count > 0 && mcu_count % dri == 0) {
                        // restart: byte-align, consume RSTn, reset DC preds
                        br.byte_align();
                        if (!br.pending_marker && br.pos + 2 <= br.len &&
                            br.d[br.pos] == 0xff && br.d[br.pos + 1] >= 0xd0 &&
                            br.d[br.pos + 1] <= 0xd7)
                            br.pos += 2;
                        else if (br.pending_marker >= 0xd0 && br.pending_marker <= 0xd7)
                            br.pending_marker = 0;
                        pred[0] = pred[1] = pred[2] = 0;
                    }
                    for (int c = 0; c < ncomp; ++c) {
                        for (int v = 0; v < comp[c].vs; ++v) {
                            for (int hh = 0; hh < comp[c].hs; ++hh) {
                                int coef[64] = {0};
                                int t = jd_decode(br, hdc[comp[c].td]);
                                if (t < 0 || t > 15) return -2;
                                pred[c] += jd_receive_extend(br, t);
                                coef[0] = pred[c];
                                for (int k = 1; k < 64;) {
                                    int rs = jd_decode(br, hac[comp[c].ta]);
                                    if (rs < 0) return -2;
                                    int r = rs >> 4, s = rs & 15;
                                    if (s == 0) {
                                        if (r != 15) break;  // EOB
                                        k += 16;             // ZRL
                                        continue;
                                    }
                                    k += r;
                                    if (k > 63) return -2;
                                    coef[kZigzag[k]] = jd_receive_extend(br, s);
                                    ++k;
                                }
                                int bx = mx * comp[c].hs + hh, by = my * comp[c].vs + v;
                                idct8x8(coef, qt[comp[c].tq],
                                        comp[c].plane.data() +
                                            ((size_t)by * 8 * comp[c].bw * 8 + bx * 8),
                                        comp[c].bw * 8);
                            }
                        }
                    }
                    ++mcu_count;
                }
            }

            // upsample subsampled components to full resolution (triangle
            // filter per doubled dimension, matching libjpeg's default)
            std::vector<uint8_t> full[3];
            for (int c = 0; c < ncomp; ++c) {
                int cw = comp[c].bw * 8, ch = comp[c].bh * 8;
                std::vector<uint8_t>* cur = &comp[c].plane;
                std::vector<uint8_t> tmp;
                int fw = cw, fh = ch;
                if (comp[c].hs < hmax) {  // double horizontally
                    tmp.resize((size_t)fh * cw * 2);
                    for (int y = 0; y < fh; ++y)
                        upsample2_row(cur->data() + (size_t)y * cw, cw,
                                      tmp.data() + (size_t)y * cw * 2);
                    fw = cw * 2;
                    *cur = tmp;
                }
                if (comp[c].vs < vmax) {  // double vertically (triangle on columns)
                    tmp.assign((size_t)fw * fh * 2, 0);
                    for (int y = 0; y < fh; ++y) {
                        const uint8_t* rp = cur->data() + (size_t)(y > 0 ? y - 1 : 0) * fw;
                        const uint8_t* rc = cur->data() + (size_t)y * fw;
                        const uint8_t* rn =
                            cur->data() + (size_t)(y + 1 < fh ? y + 1 : fh - 1) * fw;
                        uint8_t* o0 = tmp.data() + (size_t)(2 * y) * fw;
                        uint8_t* o1 = tmp.data() + (size_t)(2 * y + 1) * fw;
                        for (int x = 0; x < fw; ++x) {
                            o0[x] = (uint8_t)((3 * rc[x] + rp[x] + 2) >> 2);
                            o1[x] = (uint8_t)((3 * rc[x] + rn[x] + 1) >> 2);
                        }
                    }
                    fh *= 2;
                    *cur = tmp;
                }
                full[c] = std::move(*cur);
                comp[c].bw = fw / 8;  // record full-res stride via bw*8
            }

            uint8_t* res = (uint8_t*)malloc((size_t)width * height * 2);
            if (!res) return -3;
            int stride0 = comp[0].bw * 8;
            if (ncomp == 1) {
                for (int y = 0; y < height; ++y)
                    for (int x = 0; x < width; ++x) {
                        res[((size_t)y * width + x) * 2] = full[0][(size_t)y * stride0 + x];
                        res[((size_t)y * width + x) * 2 + 1] = 255;
                    }
            } else {
                int stride1 = comp[1].bw * 8, stride2 = comp[2].bw * 8;
                for (int y = 0; y < height; ++y)
                    for (int x = 0; x < width; ++x) {
                        float Y = full[0][(size_t)y * stride0 + x];
                        float cb = full[1][(size_t)y * stride1 + x] - 128.0f;
                        float cr = full[2][(size_t)y * stride2 + x] - 128.0f;
                        int r = (int)lrintf(Y + 1.402f * cr);
                        int g = (int)lrintf(Y - 0.344136f * cb - 0.714136f * cr);
                        int b = (int)lrintf(Y + 1.772f * cb);
                        uint8_t r8 = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
                        uint8_t g8 = (uint8_t)(g < 0 ? 0 : (g > 255 ? 255 : g));
                        uint8_t b8 = (uint8_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
                        res[((size_t)y * width + x) * 2] = stb_luminance(r8, g8, b8);
                        res[((size_t)y * width + x) * 2 + 1] = 255;
                    }
            }
            *out = res;
            *w = width;
            *h = height;
            return 0;
        } else {
            // APPn / COM / anything else: skip
        }
        pos += 2 + seglen;
    }
    return -2;  // no SOS found
}

}  // extern "C"
