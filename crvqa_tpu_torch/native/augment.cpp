// Native augmentation hot ops for the mPLUG image pipeline (the port's own
// copy of crvqa_tpu/native/augment.cpp; same arithmetic).
//
// The train-time transforms (data/augment.py, after
// mPLUG/dataset/randaugment.py) funnel rotate/shear/translate into one
// bilinear inverse warp, and end in the CLIP normalize; at 384x384 the numpy
// versions of these take tens of ms an image and hold the GIL. Each op here
// is BIT-EXACT against the numpy version in data/augment.py: fp32 math in
// numpy's left-associated expression order, no FMA contraction (built with
// -ffp-contract=off and without -ffast-math, native/augment_native.py).
//
// C ABI + ctypes; ctypes releases the GIL for the duration of each call, so
// load_images' worker threads run the ops in parallel.
#include <cmath>
#include <cstdint>

namespace {

inline float fclampf(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// out[y, x] = img[inv @ (x, y, 1)], bilinear, constant fill (128) outside
// the source rect; mirrors data/augment.py:_affine_inverse_warp exactly:
// fp32 math, left-associated products/sums, clip then C-truncation cast.
// img/out: [h, w, c] uint8 contiguous; inv: 6 floats (2x3).
int affine_inverse_warp_u8(const uint8_t* img, int64_t h, int64_t w,
                           int64_t c, const float* inv, uint8_t* out,
                           float fill) {
    if (h <= 0 || w <= 0 || c <= 0) return 1;
    const float i00 = inv[0], i01 = inv[1], i02 = inv[2];
    const float i10 = inv[3], i11 = inv[4], i12 = inv[5];
    const float wm1 = static_cast<float>(w - 1);
    const float hm1 = static_cast<float>(h - 1);
    for (int64_t y = 0; y < h; ++y) {
        const float ys = static_cast<float>(y);
        uint8_t* orow = out + y * w * c;
        for (int64_t x = 0; x < w; ++x) {
            const float xs = static_cast<float>(x);
            const float sx = i00 * xs + i01 * ys + i02;
            const float sy = i10 * xs + i11 * ys + i12;
            const bool valid =
                sx >= 0.0f && sx <= wm1 && sy >= 0.0f && sy <= hm1;
            uint8_t* opx = orow + x * c;
            if (!valid) {
                for (int64_t k = 0; k < c; ++k)
                    opx[k] = static_cast<uint8_t>(fill);
                continue;
            }
            const float x0 = std::floor(sx);
            const float y0 = std::floor(sy);
            const float fx = sx - x0;
            const float fy = sy - y0;
            int64_t x0i = static_cast<int64_t>(fclampf(x0, 0.0f, wm1));
            int64_t y0i = static_cast<int64_t>(fclampf(y0, 0.0f, hm1));
            int64_t x1i = x0i + 1 > w - 1 ? w - 1 : x0i + 1;
            int64_t y1i = y0i + 1 > h - 1 ? h - 1 : y0i + 1;
            const uint8_t* p00 = img + (y0i * w + x0i) * c;
            const uint8_t* p01 = img + (y0i * w + x1i) * c;
            const uint8_t* p10 = img + (y1i * w + x0i) * c;
            const uint8_t* p11 = img + (y1i * w + x1i) * c;
            const float gx = 1.0f - fx;
            const float gy = 1.0f - fy;
            for (int64_t k = 0; k < c; ++k) {
                // numpy order: ((f*(1-fx))*(1-fy) + (f*fx)*(1-fy)
                //               + (f*(1-fx))*fy) + (f*fx)*fy
                const float t00 = (static_cast<float>(p00[k]) * gx) * gy;
                const float t01 = (static_cast<float>(p01[k]) * fx) * gy;
                const float t10 = (static_cast<float>(p10[k]) * gx) * fy;
                const float t11 = (static_cast<float>(p11[k]) * fx) * fy;
                const float v = ((t00 + t01) + t10) + t11;
                opx[k] = static_cast<uint8_t>(fclampf(v, 0.0f, 255.0f));
            }
        }
    }
    return 0;
}

// Per-channel min/max stretch (data/augment.py:autocontrast). Only 256
// input values exist per channel, so a fp32-exact LUT reproduces
// clip((f - off) * scale) byte-for-byte.
int autocontrast_u8(const uint8_t* img, int64_t npx, uint8_t* out) {
    uint8_t lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
    for (int64_t i = 0; i < npx; ++i) {
        const uint8_t* p = img + i * 3;
        for (int k = 0; k < 3; ++k) {
            if (p[k] < lo[k]) lo[k] = p[k];
            if (p[k] > hi[k]) hi[k] = p[k];
        }
    }
    uint8_t lut[3][256];
    for (int k = 0; k < 3; ++k) {
        const float flo = static_cast<float>(lo[k]);
        const float fhi = static_cast<float>(hi[k]);
        const bool stretch = fhi > flo;
        const float d = fhi - flo;
        const float scale =
            stretch ? 255.0f / (d > 1e-6f ? d : 1e-6f) : 1.0f;
        const float off = stretch ? flo : 0.0f;
        for (int v = 0; v < 256; ++v) {
            const float r = (static_cast<float>(v) - off) * scale;
            lut[k][v] = static_cast<uint8_t>(fclampf(r, 0.0f, 255.0f));
        }
    }
    for (int64_t i = 0; i < npx; ++i) {
        const uint8_t* p = img + i * 3;
        uint8_t* o = out + i * 3;
        for (int k = 0; k < 3; ++k) o[k] = lut[k][p[k]];
    }
    return 0;
}

// PIL-style per-channel histogram equalization (data/augment.py:equalize)
// — pure integer math, exact by construction.
int equalize_u8(const uint8_t* img, int64_t npx, uint8_t* out) {
    for (int k = 0; k < 3; ++k) {
        int64_t histo[256] = {0};
        for (int64_t i = 0; i < npx; ++i) ++histo[img[i * 3 + k]];
        int64_t total = 0, last_nonzero = -1, n_nonzero = 0;
        for (int v = 0; v < 256; ++v) {
            total += histo[v];
            if (histo[v]) { last_nonzero = v; ++n_nonzero; }
        }
        const int64_t step =
            n_nonzero > 1 ? (total - histo[last_nonzero]) / 255 : 0;
        if (step == 0) {  // identity channel
            for (int64_t i = 0; i < npx; ++i) out[i * 3 + k] = img[i * 3 + k];
            continue;
        }
        uint8_t lut[256];
        int64_t cum = 0;
        for (int v = 0; v < 256; ++v) {
            const int64_t m = (cum + step / 2) / step;
            lut[v] = static_cast<uint8_t>(m < 255 ? m : 255);
            cum += histo[v];
        }
        for (int64_t i = 0; i < npx; ++i) out[i * 3 + k] = lut[img[i * 3 + k]];
    }
    return 0;
}

// 3x3 smooth ([[1,1,1],[1,5,1],[1,1,1]]/13, reflect-101 borders, rint) +
// interior-only blend toward/away from the original with the reference's
// deliberate uint8 WRAParound on overshoot (data/augment.py:sharpness).
// Accumulation follows numpy's term order (dy-major) for fp32 exactness;
// the wrap cast goes through int64 truncation then uint8 modular cast,
// matching numpy's C-cast behavior.
int sharpness_u8(const uint8_t* img, int64_t h, int64_t w, float factor,
                 uint8_t* out) {
    if (h < 3 || w < 3) return 1;
    const float k0 = 1.0f / 13.0f;
    const float k1 = 5.0f / 13.0f;
    const float kern[3][3] = {{k0, k0, k0}, {k0, k1, k0}, {k0, k0, k0}};
    for (int64_t y = 0; y < h; ++y) {
        // reflect-101: index -1 -> 1, h -> h-2
        int64_t ys[3];
        for (int d = 0; d < 3; ++d) {
            int64_t yy = y + d - 1;
            ys[d] = yy < 0 ? -yy : (yy >= h ? 2 * h - yy - 2 : yy);
        }
        for (int64_t x = 0; x < w; ++x) {
            int64_t xs[3];
            for (int d = 0; d < 3; ++d) {
                int64_t xx = x + d - 1;
                xs[d] = xx < 0 ? -xx : (xx >= w ? 2 * w - xx - 2 : xx);
            }
            const bool interior = y > 0 && y < h - 1 && x > 0 && x < w - 1;
            uint8_t* o = out + (y * w + x) * 3;
            const uint8_t* orig = img + (y * w + x) * 3;
            if (!interior && factor != 0.0f) {
                // border keeps original pixels in the blend path
                o[0] = orig[0]; o[1] = orig[1]; o[2] = orig[2];
                continue;
            }
            for (int k = 0; k < 3; ++k) {
                float acc = 0.0f;
                for (int dy = 0; dy < 3; ++dy)
                    for (int dx = 0; dx < 3; ++dx)
                        acc += kern[dy][dx] * static_cast<float>(
                            img[(ys[dy] * w + xs[dx]) * 3 + k]);
                const float sm =
                    fclampf(std::nearbyintf(acc), 0.0f, 255.0f);
                if (factor == 0.0f) {
                    o[k] = static_cast<uint8_t>(sm);
                } else {
                    const float v =
                        sm + factor * (static_cast<float>(orig[k]) - sm);
                    // numpy astype(uint8): C truncation toward zero, then
                    // modular wrap — reproduce via int64
                    o[k] = static_cast<uint8_t>(static_cast<int64_t>(v));
                }
            }
        }
    }
    return 0;
}

// ((img/255) - mean) / std, uint8 [n, 3] -> float32 [n, 3]; mirrors the
// tail of data/augment.py:train_transform / test_transform: fp32 division
// by the literal 255.0, subtract mean, divide by std — same order.
int normalize_u8(const uint8_t* img, int64_t n, const float* mean,
                 const float* std_, float* out) {
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    const float s0 = std_[0], s1 = std_[1], s2 = std_[2];
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = img + i * 3;
        float* o = out + i * 3;
        o[0] = (static_cast<float>(p[0]) / 255.0f - m0) / s0;
        o[1] = (static_cast<float>(p[1]) / 255.0f - m1) / s1;
        o[2] = (static_cast<float>(p[2]) / 255.0f - m2) / s2;
    }
    return 0;
}

}  // extern "C"
