// vq_native: the host's asset loops for vqengine_tpu_torch, in C++.
//
// Counterpart of the JAX package's native asset library: the PNG row
// unfilter with the palette expansion, and one 2x2 box-filtered mip level.
// The chunk walk and the inflate stay in Python (utils/image_io.parse_png,
// zlib.decompress), so this file needs no zlib. The loops are the JAX
// package's, unchanged.
//
// Built on the host at first use by vqengine_tpu_torch/utils/native.py
// (g++ -O3 -fPIC -shared -ffp-contract=off, no -march=native: the mip's
// sum order is part of its result); bound with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// PNG unfilter of an inflated stream: h rows of (1 filter byte, w * channels
// bytes). palette (768 bytes, zero past the PLTE chunk) is non-null for a
// paletted image (channels 1), whose rows come out as RGB.
// out holds h * w * (palette ? 3 : channels) bytes.
// Returns 0, -5 when out of memory, -6 on a bad filter byte.
// ---------------------------------------------------------------------------

int vq_png_unfilter(const uint8_t* raw, int w, int h, int channels,
                    const uint8_t* palette, uint8_t* out) {
    const int ch = channels;
    const size_t stride = (size_t)w * ch;
    uint8_t* prev = (uint8_t*)calloc(stride, 1);
    uint8_t* line = (uint8_t*)malloc(stride);
    if (!prev || !line) { free(prev); free(line); return -5; }
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = raw + y * (stride + 1);
        const int ft = src[0];
        memcpy(line, src + 1, stride);
        switch (ft) {
            case 0: break;
            case 1:
                for (size_t x = ch; x < stride; ++x) line[x] += line[x - ch];
                break;
            case 2:
                for (size_t x = 0; x < stride; ++x) line[x] += prev[x];
                break;
            case 3:
                for (size_t x = 0; x < stride; ++x) {
                    int a = x >= (size_t)ch ? line[x - ch] : 0;
                    line[x] += (uint8_t)((a + prev[x]) >> 1);
                }
                break;
            case 4:
                for (size_t x = 0; x < stride; ++x) {
                    int a = x >= (size_t)ch ? line[x - ch] : 0;
                    int b = prev[x];
                    int c = x >= (size_t)ch ? prev[x - ch] : 0;
                    int p = a + b - c;
                    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                    int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    line[x] += (uint8_t)pred;
                }
                break;
            default:
                free(prev); free(line); return -6;
        }
        if (palette) {
            uint8_t* dst = out + (size_t)y * w * 3;
            for (int x = 0; x < w; ++x) {
                const uint8_t* p = palette + line[x] * 3;
                dst[x * 3] = p[0]; dst[x * 3 + 1] = p[1]; dst[x * 3 + 2] = p[2];
            }
        } else {
            memcpy(out + (size_t)y * stride, line, stride);
        }
        memcpy(prev, line, stride);
    }
    free(prev); free(line);
    return 0;
}

// ---------------------------------------------------------------------------
// box-filter mip generation: src [h, w, c] f32 -> dst [max(h/2, 1),
// max(w/2, 1), c]; the last row and column are clamped on a side of 1
// ---------------------------------------------------------------------------

void vq_mip_box(const float* src, int h, int w, int c, float* dst) {
    const int h2 = h / 2 > 0 ? h / 2 : 1;
    const int w2 = w / 2 > 0 ? w / 2 : 1;
    for (int y = 0; y < h2; ++y) {
        const float* r0 = src + (size_t)(2 * y) * w * c;
        const float* r1 = src + (size_t)(2 * y + 1 < h ? 2 * y + 1 : 2 * y) * w * c;
        float* d = dst + (size_t)y * w2 * c;
        for (int x = 0; x < w2; ++x) {
            const int x1 = 2 * x + 1 < w ? 2 * x + 1 : 2 * x;
            for (int k = 0; k < c; ++k) {
                d[x * c + k] = 0.25f * (r0[2 * x * c + k] + r0[x1 * c + k] +
                                        r1[2 * x * c + k] + r1[x1 * c + k]);
            }
        }
    }
}

}  // extern "C"
