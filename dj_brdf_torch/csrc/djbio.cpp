// djbio: the port's host-side data plane (dj_brdf_torch/io/native.py).
//
// The reference does its file parsing and map building in C++
// (merl::merl dj_brdf.h:963-983, utia::utia 1039-1059 + normalize
// 1162-1177, utils/dmap2nmap.cpp, utils/nmap2leanmap.cpp); this
// library is the equivalent native layer: single-pass parse + dtype
// conversion + normalization on the host, handing ready-to-upload
// float32 buffers to Python through ctypes. Multithreaded with OpenMP
// where the image is large enough to matter.
//
// A copy of the JAX package's dj_brdf_tpu/io/native/djbio.cpp with the
// same arithmetic, so the two agree bit for bit, under the port's djbt_
// prefix. The environment map's alias builder lives in alias.cpp. Built
// by g++ (-fopenmp) through dj_brdf_torch/ops/_build.py at first use.

#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {
constexpr int kMerlThetaH = 90;
constexpr int kMerlThetaD = 90;
constexpr int kMerlPhiD = 180;
constexpr long kMerlCount = 3L * kMerlThetaH * kMerlThetaD * kMerlPhiD;
constexpr long kUtiaCount = 3L * 6 * 48 * 6 * 48;
}  // namespace

extern "C" {

// Returns 0 on success, negative error codes otherwise.
int djbt_load_merl(const char *path, float *out /* kMerlCount */) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    int32_t dims[3];
    if (fread(dims, 4, 3, f) != 3) { fclose(f); return -2; }
    long n = (long)dims[0] * dims[1] * dims[2];
    if (n * 3 != kMerlCount) { fclose(f); return -3; }

    const long chunk = 1 << 16;
    double buf[chunk];
    long done = 0;
    while (done < kMerlCount) {
        long want = kMerlCount - done < chunk ? kMerlCount - done : chunk;
        if ((long)fread(buf, 8, want, f) != want) { fclose(f); return -4; }
        for (long k = 0; k < want; ++k) out[done + k] = (float)buf[k];
        done += want;
    }
    fclose(f);
    return 0;
}

// Returns the number of clamped negative samples (>= 0) so the caller
// can reproduce the reference's per-value warning (dj_brdf.h:1166-1169)
// as an aggregated DJB_LOG count; negative return = error.
int djbt_load_utia(const char *path, float *out /* kUtiaCount */) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    const long chunk = 1 << 16;
    double buf[chunk];
    long done = 0;
    long negatives = 0;
    const float scale = 1.0f / 140.0f;  // dj_brdf.h:1174
    while (done < kUtiaCount) {
        long want = kUtiaCount - done < chunk ? kUtiaCount - done : chunk;
        if ((long)fread(buf, 8, want, f) != want) { fclose(f); return -4; }
        for (long k = 0; k < want; ++k) {
            negatives += buf[k] < 0.0;
            double v = buf[k] < 0.0 ? 0.0 : buf[k];  // clamp, dj_brdf.h:1170
            out[done + k] = (float)(v * scale);
        }
        done += want;
    }
    fclose(f);
    return negatives > 0x7fffffff ? 0x7fffffff : (int)negatives;
}

// displacement (h*w, [0,1]) -> unit normals (h*w*3), central differences
// (utils/dmap2nmap.cpp:13-44); border: 0 = repeat, 1 = clamp.
void djbt_dmap_to_nmap(const float *dmap, int h, int w, float scale,
                        int clamp_border, float *nmap) {
#pragma omp parallel for schedule(static)
    for (int j = 0; j < h; ++j) {
        for (int i = 0; i < w; ++i) {
            auto wrap = [&](int v, int n) {
                if (clamp_border) return v < 0 ? 0 : (v >= n ? n - 1 : v);
                return ((v % n) + n) % n;
            };
            float z_l = dmap[j * w + wrap(i - 1, w)];
            float z_r = dmap[j * w + wrap(i + 1, w)];
            float z_b = dmap[wrap(j + 1, h) * w + i];
            float z_t = dmap[wrap(j - 1, h) * w + i];
            float sx = (float)w * 0.5f * scale * (z_r - z_l);
            float sy = (float)h * 0.5f * scale * (z_t - z_b);
            float inv = 1.0f / sqrtf(1.0f + sx * sx + sy * sy);
            float *px = nmap + 3 * (j * w + i);
            px[0] = -sx * inv;
            px[1] = -sy * inv;
            px[2] = inv;
        }
    }
}

// normal map (h*w*3) -> LEAN moments, 5 planes of h*w
// (utils/nmap2leanmap.cpp:18-54; bias per nmap2leanmap_biased.cpp).
void djbt_nmap_to_lean(const float *nmap, int h, int w,
                        float base_roughness, float bias, float *lean) {
    const long n = (long)h * w;
    const float br2 = 0.5f * base_roughness * base_roughness;
    float *E1 = lean, *E2 = lean + n, *E3 = lean + 2 * n;
    float *E4 = lean + 3 * n, *E5 = lean + 4 * n;
#pragma omp parallel for schedule(static)
    for (long k = 0; k < n; ++k) {
        float nz = nmap[3 * k + 2];
        if (nz < 1e-6f) nz = 1e-6f;
        float sx = -nmap[3 * k + 0] / nz;
        float sy = -nmap[3 * k + 1] / nz;
        E1[k] = sx + bias;
        E2[k] = sy + bias;
        E3[k] = sx * sx + br2;
        E4[k] = sy * sy + br2;
        E5[k] = sx * sy + bias * bias;
    }
}

// one mip level: 2x2 mean of each of the 5 moment planes
void djbt_lean_mip_reduce(const float *lean, int h, int w, float *out) {
    const long n = (long)h * w;
    const int h2 = h / 2, w2 = w / 2;
    const long n2 = (long)h2 * w2;
    for (int p = 0; p < 5; ++p) {
        const float *src = lean + p * n;
        float *dst = out + p * n2;
#pragma omp parallel for schedule(static)
        for (int j = 0; j < h2; ++j)
            for (int i = 0; i < w2; ++i) {
                float s = src[(2 * j) * w + 2 * i]
                        + src[(2 * j) * w + 2 * i + 1]
                        + src[(2 * j + 1) * w + 2 * i]
                        + src[(2 * j + 1) * w + 2 * i + 1];
                dst[j * w2 + i] = 0.25f * s;
            }
    }
}

// ---- Radiance RGBE (.hdr) ------------------------------------------
// The reference's environment emitters are HDR lat-long images
// (mitsuba/README:21-23; host image IO is CImg/Mitsuba territory in
// the reference). This is a minimal self-contained Radiance decoder:
// header + "-Y h +X w" resolution line, then per-scanline either
// adaptive RLE (2,2,hi,lo marker) or flat/old-style RGBE records.

static int hdr_read_header(FILE *f, int *h, int *w, double *exposure) {
    char line[512];
    if (!fgets(line, sizeof line, f)) return -1;
    if (strncmp(line, "#?", 2) != 0) return -2;  // #?RADIANCE / #?RGBE
    *exposure = 1.0;
    for (;;) {
        if (!fgets(line, sizeof line, f)) return -3;
        if (line[0] == '\n' || line[0] == '\r') break;   // end of header
        if (strncmp(line, "EXPOSURE=", 9) == 0) {
            double e = atof(line + 9);
            if (e > 0.0) *exposure *= e;
        }
        // FORMAT=32-bit_rle_rgbe assumed; xyze is not supported
        if (strncmp(line, "FORMAT=", 7) == 0 &&
            strstr(line, "rgbe") == nullptr) return -4;
    }
    if (!fgets(line, sizeof line, f)) return -5;
    int hh = 0, ww = 0;
    if (sscanf(line, "-Y %d +X %d", &hh, &ww) != 2) return -6;
    if (hh <= 0 || ww <= 0) return -7;
    *h = hh;
    *w = ww;
    return 0;
}

static void rgbe_to_float(const uint8_t *rgbe, double inv_exposure,
                          float *out) {
    if (rgbe[3] == 0) {
        out[0] = out[1] = out[2] = 0.0f;
        return;
    }
    const double f = ldexp(1.0, (int)rgbe[3] - (128 + 8)) * inv_exposure;
    out[0] = (float)(rgbe[0] * f);
    out[1] = (float)(rgbe[1] * f);
    out[2] = (float)(rgbe[2] * f);
}

// reads one scanline of w RGBE quadruples into buf (w*4 bytes)
static int hdr_read_scanline(FILE *f, int w, uint8_t *buf) {
    int c0 = fgetc(f), c1 = fgetc(f), c2 = fgetc(f), c3 = fgetc(f);
    if (c3 == EOF) return -1;
    if (c0 == 2 && c1 == 2 && ((c2 << 8) | c3) == w && w >= 8 &&
        w < 32768) {
        // adaptive RLE: 4 component planes, runs or literal spans
        for (int comp = 0; comp < 4; ++comp) {
            int i = 0;
            while (i < w) {
                int count = fgetc(f);
                if (count == EOF) return -2;
                if (count > 128) {                    // run
                    int val = fgetc(f);
                    if (val == EOF) return -3;
                    count -= 128;
                    if (i + count > w) return -4;
                    for (int k = 0; k < count; ++k)
                        buf[4 * (i + k) + comp] = (uint8_t)val;
                } else {                              // literal span
                    if (count == 0 || i + count > w) return -5;
                    for (int k = 0; k < count; ++k) {
                        int val = fgetc(f);
                        if (val == EOF) return -6;
                        buf[4 * (i + k) + comp] = (uint8_t)val;
                    }
                }
                i += count;
            }
        }
        return 0;
    }
    // flat / old-style: first pixel already read; (1,1,1,n) repeats
    uint8_t prev[4] = {(uint8_t)c0, (uint8_t)c1, (uint8_t)c2, (uint8_t)c3};
    int i = 0;
    int shift = 0;
    for (;;) {
        if (prev[0] == 1 && prev[1] == 1 && prev[2] == 1) {
            int count = (int)prev[3] << shift;
            if (i == 0 || i + count > w) return -7;
            for (int k = 0; k < count; ++k)
                memcpy(buf + 4 * (i + k), buf + 4 * (i - 1), 4);
            i += count;
            shift += 8;
        } else {
            memcpy(buf + 4 * i, prev, 4);
            ++i;
            shift = 0;
        }
        if (i >= w) return 0;
        if (fread(prev, 1, 4, f) != 4) return -8;
    }
}

// probe the image size (two-call pattern: size, then pixels)
int djbt_hdr_size(const char *path, int32_t *h, int32_t *w) {
    FILE *f = fopen(path, "rb");
    if (!f) return -10;
    int hh, ww;
    double exposure;
    int rc = hdr_read_header(f, &hh, &ww, &exposure);
    fclose(f);
    if (rc != 0) return rc;
    *h = hh;
    *w = ww;
    return 0;
}

// decode the full image into out (h*w*3 float32, row-major, divided
// by any EXPOSURE headers so values are true radiance)
int djbt_load_hdr(const char *path, float *out) {
    FILE *f = fopen(path, "rb");
    if (!f) return -10;
    int h, w;
    double exposure;
    int rc = hdr_read_header(f, &h, &w, &exposure);
    if (rc != 0) {
        fclose(f);
        return rc;
    }
    const double inv_exposure = 1.0 / exposure;
    uint8_t *buf = new uint8_t[(size_t)w * 4];
    for (int j = 0; j < h && rc == 0; ++j) {
        rc = hdr_read_scanline(f, w, buf);
        if (rc == 0)
            for (int i = 0; i < w; ++i)
                rgbe_to_float(buf + 4 * i, inv_exposure,
                              out + 3 * ((size_t)j * w + i));
    }
    delete[] buf;
    fclose(f);
    return rc == 0 ? 0 : rc - 100;
}

}  // extern "C"
