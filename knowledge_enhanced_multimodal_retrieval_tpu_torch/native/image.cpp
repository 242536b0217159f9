// Native CLIP image preprocessing: shortest-edge bicubic resize (exact
// Pillow `Image.resize(..., BICUBIC)` semantics, 8-bit fixed-point pipeline)
// + center crop + rescale/normalize, fused in one pass over the output.
//
// Re-implements the host-side hot path of the reference's data layer
// (`src/clip/datasets/clip_dataset.py:56-78` via torchvision->PIL, and
// `evaluator_hf.py:115-147` via CLIPImageProcessor->PIL): both ultimately
// call Pillow's ImagingResample, whose two-pass separable convolution with
// INT32 fixed-point coefficients (PRECISION_BITS = 32-8-2) is reproduced
// here so the uint8 intermediate matches Pillow bit-for-bit. ctypes releases
// the GIL for the call, so the data pipeline's worker threads scale on real
// cores. Parity pinned in tests/test_native_image.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

// Pillow's bicubic kernel (Catmull-Rom family, a = -0.5), support 2.0.
double bicubic_filter(double x) {
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Python round(): half-to-even (torchvision's CenterCrop offset uses it)
inline int round_half_even(double v) {
    const double f = std::floor(v);
    const double d = v - f;
    const int fi = static_cast<int>(f);
    if (d > 0.5) return fi + 1;
    if (d < 0.5) return fi;
    return (fi % 2 == 0) ? fi : fi + 1;
}

inline uint8_t clip8(int in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> PRECISION_BITS);
}

// Pillow precompute_coeffs: antialiased kernel (support scales with the
// downscale factor), per-output-pixel window [bounds] + normalized weights.
int precompute_coeffs(
    int in_size, int out_size, std::vector<int>& bounds, std::vector<int32_t>& kk
) {
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = 2.0 * filterscale;  // bicubic support
    const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

    std::vector<double> prekk(static_cast<size_t>(out_size) * ksize, 0.0);
    bounds.assign(static_cast<size_t>(out_size) * 2, 0);
    const double ss = 1.0 / filterscale;
    for (int xx = 0; xx < out_size; xx++) {
        const double center = (xx + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &prekk[static_cast<size_t>(xx) * ksize];
        double ww = 0.0;
        for (int x = 0; x < xmax; x++) {
            const double w = bicubic_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        if (ww != 0.0) {
            for (int x = 0; x < xmax; x++) k[x] /= ww;
        }
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    // 8bpc fixed-point conversion (Pillow normalize_coeffs_8bpc)
    kk.assign(prekk.size(), 0);
    for (size_t i = 0; i < prekk.size(); i++) {
        if (prekk[i] < 0) {
            kk[i] = static_cast<int32_t>(-0.5 + prekk[i] * (1 << PRECISION_BITS));
        } else {
            kk[i] = static_cast<int32_t>(0.5 + prekk[i] * (1 << PRECISION_BITS));
        }
    }
    return ksize;
}

// Two-pass separable resample of interleaved RGB uint8, Pillow order:
// horizontal into a temp [h, nw] image, then vertical to [nh, nw].
void resample_u8(
    const uint8_t* in, int h, int w, uint8_t* out, int nh, int nw
) {
    std::vector<int> xb, yb;
    std::vector<int32_t> xk, yk;
    const int xks = precompute_coeffs(w, nw, xb, xk);
    const int yks = precompute_coeffs(h, nh, yb, yk);

    std::vector<uint8_t> temp(static_cast<size_t>(h) * nw * 3);
    const int init = 1 << (PRECISION_BITS - 1);
    for (int yy = 0; yy < h; yy++) {
        const uint8_t* row = in + static_cast<size_t>(yy) * w * 3;
        uint8_t* trow = temp.data() + static_cast<size_t>(yy) * nw * 3;
        for (int xx = 0; xx < nw; xx++) {
            const int xmin = xb[xx * 2], xmax = xb[xx * 2 + 1];
            const int32_t* k = &xk[static_cast<size_t>(xx) * xks];
            int s0 = init, s1 = init, s2 = init;
            for (int x = 0; x < xmax; x++) {
                const uint8_t* p = row + static_cast<size_t>(xmin + x) * 3;
                s0 += p[0] * k[x];
                s1 += p[1] * k[x];
                s2 += p[2] * k[x];
            }
            trow[xx * 3 + 0] = clip8(s0);
            trow[xx * 3 + 1] = clip8(s1);
            trow[xx * 3 + 2] = clip8(s2);
        }
    }
    for (int yy = 0; yy < nh; yy++) {
        const int ymin = yb[yy * 2], ymax = yb[yy * 2 + 1];
        const int32_t* k = &yk[static_cast<size_t>(yy) * yks];
        uint8_t* orow = out + static_cast<size_t>(yy) * nw * 3;
        for (int xx = 0; xx < nw; xx++) {
            int s0 = init, s1 = init, s2 = init;
            for (int y = 0; y < ymax; y++) {
                const uint8_t* p = temp.data() + (static_cast<size_t>(ymin + y) * nw + xx) * 3;
                s0 += p[0] * k[y];
                s1 += p[1] * k[y];
                s2 += p[2] * k[y];
            }
            orow[xx * 3 + 0] = clip8(s0);
            orow[xx * 3 + 1] = clip8(s1);
            orow[xx * 3 + 2] = clip8(s2);
        }
    }
}

}  // namespace

extern "C" {

// Bicubic resize of interleaved RGB uint8 [h, w, 3] -> [nh, nw, 3].
// Exposed for direct parity tests against PIL.
void kemr_resize_bicubic_u8(
    const uint8_t* in, int h, int w, uint8_t* out, int nh, int nw
) {
    if (nh == h && nw == w) {
        std::memcpy(out, in, static_cast<size_t>(h) * w * 3);
        return;
    }
    resample_u8(in, h, w, out, nh, nw);
}

// Full CLIP preprocess: shortest-edge resize to `size`, center crop
// (mode 0 = torchvision round-half offsets, 1 = HF floor offsets), then
// (x/255 - mean)/std in float32. out is [size, size, 3] float32.
// Returns 0 on success.
int kemr_clip_preprocess(
    const uint8_t* in, int h, int w, int size, int mode_hf,
    const float* mean, const float* stdv, float* out
) {
    if (h <= 0 || w <= 0 || size <= 0) return -1;
    // shortest-edge target (torchvision and HF agree: floor on the long side)
    int nw, nh;
    if (w <= h) {
        nw = size;
        nh = static_cast<int>(static_cast<double>(size) * h / w);
    } else {
        nw = static_cast<int>(static_cast<double>(size) * w / h);
        nh = size;
    }
    std::vector<uint8_t> resized(static_cast<size_t>(nh) * nw * 3);
    kemr_resize_bicubic_u8(in, h, w, resized.data(), nh, nw);

    int left, top;
    if (mode_hf) {  // HF image_transforms.center_crop: floor
        left = (nw - size) / 2;
        top = (nh - size) / 2;
    } else {  // torchvision CenterCrop: int(round(...)), Python half-to-even
        left = round_half_even((nw - size) / 2.0);
        top = round_half_even((nh - size) / 2.0);
    }
    if (left < 0 || top < 0 || left + size > nw || top + size > nh) return -2;

    // true divisions (not reciprocal multiplies) so every float op matches
    // the NumPy reference path ULP-for-ULP
    for (int y = 0; y < size; y++) {
        const uint8_t* row = resized.data() + (static_cast<size_t>(top + y) * nw + left) * 3;
        float* orow = out + static_cast<size_t>(y) * size * 3;
        for (int x = 0; x < size; x++) {
            for (int c = 0; c < 3; c++) {
                const float v = static_cast<float>(row[x * 3 + c]) / 255.0f;
                orow[x * 3 + c] = (v - mean[c]) / stdv[c];
            }
        }
    }
    return 0;
}

}  // extern "C"
