// Host-side Walker/Vose alias table for environment-map importance
// sampling (render/envmap.py): one O(n) pass with two worklists, built
// once at scene load, as Mitsuba builds its emitter tables on the host
// (mitsuba/README:21-23). Plain C interface, loaded with ctypes.
//
// The arithmetic is that of the JAX package's native builder
// (dj_brdf_tpu/io/native/djbio.cpp, djbio_build_alias): the mass is
// scaled by n / sum (one double, then one product per bin), so the
// tables agree with it bit for bit.

#include <cstdint>

extern "C" {

// `mass` is an unnormalized f64 probability vector of n bins; fills
// prob[n] (the acceptance threshold, in (0, 1]) and alias[n] (the
// partner bin). Returns 0, or -1 (n <= 0), -2 (a negative or NaN mass),
// -3 (a zero sum).
int djbt_build_alias(const double *mass, long n, float *prob,
                     int32_t *alias) {
    if (n <= 0) return -1;
    double sum = 0.0;
    for (long i = 0; i < n; ++i) {
        if (!(mass[i] >= 0.0)) return -2;
        sum += mass[i];
    }
    if (!(sum > 0.0)) return -3;
    double *p = new double[n];
    int32_t *small = new int32_t[n];
    int32_t *large = new int32_t[n];
    long ns = 0, nl = 0;
    const double scale = (double)n / sum;
    for (long i = 0; i < n; ++i) {
        p[i] = mass[i] * scale;
        alias[i] = (int32_t)i;
        if (p[i] < 1.0) small[ns++] = (int32_t)i;
        else            large[nl++] = (int32_t)i;
    }
    while (ns > 0 && nl > 0) {
        int32_t s = small[--ns];
        int32_t l = large[--nl];
        prob[s] = (float)p[s];
        alias[s] = l;
        p[l] -= 1.0 - p[s];
        if (p[l] < 1.0) small[ns++] = l;
        else            large[nl++] = l;
    }
    while (nl > 0) prob[large[--nl]] = 1.0f;  // rounding leftovers: certain
    while (ns > 0) prob[small[--ns]] = 1.0f;
    delete[] p;
    delete[] small;
    delete[] large;
    return 0;
}

}  // extern "C"
