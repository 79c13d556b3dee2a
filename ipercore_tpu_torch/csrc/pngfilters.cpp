// PNG scanline filtering / unfiltering for the frame IO (host code).
//
// The port's copy of `native/pngfilters.cpp`, built by
// `ipercore_tpu_torch/utils/cuda_build.py` with the host C++ compiler and
// bound by `ipercore_tpu_torch/utils/native.py`. The per-pixel filter loops
// (Paeth, average, sub) are serial by nature; `utils/video.py` keeps zlib and
// the chunk framing in Python.
//
// Exposed C ABI (used via ctypes):
//   png_unfilter(raw, height, stride, bpp, out)  -> 0 on success
//       raw: height * (1 + stride) bytes of filter-tagged scanlines
//       out: height * stride reconstructed bytes
//   png_filter_sub(img, height, stride, bpp, out) -> 0
//       img: height * stride bytes; out: height * (1 + stride) bytes with
//       per-row filter tags (heuristic: Sub filter — cheap and compresses
//       natural images well).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline uint8_t paeth_predict(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

int png_unfilter(const uint8_t* raw, int64_t height, int64_t stride, int bpp,
                 uint8_t* out) {
    if (!raw || !out || height <= 0 || stride <= 0 || bpp <= 0) return 1;
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* line = raw + y * (stride + 1);
        uint8_t ft = line[0];
        const uint8_t* src = line + 1;
        uint8_t* dst = out + y * stride;
        switch (ft) {
            case 0:  // None
                memcpy(dst, src, (size_t)stride);
                break;
            case 1:  // Sub
                for (int64_t i = 0; i < bpp && i < stride; ++i) dst[i] = src[i];
                for (int64_t i = bpp; i < stride; ++i)
                    dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
                break;
            case 2:  // Up
                if (prev) {
                    for (int64_t i = 0; i < stride; ++i)
                        dst[i] = (uint8_t)(src[i] + prev[i]);
                } else {
                    memcpy(dst, src, (size_t)stride);
                }
                break;
            case 3:  // Average
                for (int64_t i = 0; i < stride; ++i) {
                    int left = i >= bpp ? dst[i - bpp] : 0;
                    int up = prev ? prev[i] : 0;
                    dst[i] = (uint8_t)(src[i] + ((left + up) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t i = 0; i < stride; ++i) {
                    int left = i >= bpp ? dst[i - bpp] : 0;
                    int up = prev ? prev[i] : 0;
                    int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    dst[i] = (uint8_t)(src[i] + paeth_predict(left, up, ul));
                }
                break;
            default:
                return 2;  // invalid filter type
        }
        prev = dst;
    }
    return 0;
}

int png_filter_sub(const uint8_t* img, int64_t height, int64_t stride, int bpp,
                   uint8_t* out) {
    if (!img || !out || height <= 0 || stride <= 0 || bpp <= 0) return 1;
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* src = img + y * stride;
        uint8_t* line = out + y * (stride + 1);
        line[0] = 1;  // Sub
        uint8_t* dst = line + 1;
        for (int64_t i = 0; i < bpp && i < stride; ++i) dst[i] = src[i];
        for (int64_t i = stride - 1; i >= bpp; --i)
            dst[i] = (uint8_t)(src[i] - src[i - bpp]);
    }
    return 0;
}

}  // extern "C"
