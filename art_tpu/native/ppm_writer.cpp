// Fast PPM P3 formatter (reference contract: src/main.cu:715-727).
//
// The reference's writer is a C++ loop over `int(255.99 * c)` with no
// clamping, rows top-down.  The Python fallback (utils/ppm.py) reproduces
// it with per-pixel f-strings at ~1 MB/s-of-pixels; this native writer
// formats the whole framebuffer in one pass (~50x faster), which matters
// because at production resolutions the ASCII encode is a visible slice of
// end-to-end frame time next to a render of a few seconds.
//
// Built on demand by utils/ppm.py:  g++ -O2 -shared -fPIC -o libppm.so
// Exposed via ctypes; int64 inputs arrive already truncated toward zero.

#include <cstdint>
#include <cstddef>

namespace {

// Writes v (may be negative or > 255 — the no-clamp quirk) as decimal.
// Negation goes through unsigned so INT64_MIN (a NaN pixel truncated by
// numpy) prints as -9223372036854775808 like Python, instead of the
// signed-overflow UB of -v.
inline char* write_int(char* p, long long v) {
    unsigned long long u;
    if (v < 0) {
        *p++ = '-';
        u = 0ULL - static_cast<unsigned long long>(v);
    } else {
        u = static_cast<unsigned long long>(v);
    }
    char tmp[24];
    int n = 0;
    do {
        tmp[n++] = static_cast<char>('0' + u % 10);
        u /= 10;
    } while (u);
    while (n) *p++ = tmp[--n];
    return p;
}

}  // namespace

extern "C" {

// vals: (ny, nx, 3) int64, row 0 = BOTTOM scanline (framebuffer order).
// out:  caller-allocated buffer; returns bytes written (no NUL).
// Caller sizes out generously (header + 25 bytes per pixel is safe for
// any value the renderer can produce).
size_t ppm_format_body(const int64_t* vals, int64_t ny, int64_t nx,
                       char* out) {
    char* p = out;
    for (int64_t j = ny - 1; j >= 0; --j) {
        const int64_t* row = vals + j * nx * 3;
        for (int64_t i = 0; i < nx; ++i) {
            p = write_int(p, row[i * 3 + 0]);
            *p++ = ' ';
            p = write_int(p, row[i * 3 + 1]);
            *p++ = ' ';
            p = write_int(p, row[i * 3 + 2]);
            *p++ = '\n';
        }
    }
    return static_cast<size_t>(p - out);
}

}  // extern "C"
