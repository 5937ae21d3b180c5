// Native host-runtime support for photohive_dsp_tpu_torch (a copy of
// photohive_dsp_tpu/runtime/native.cpp; the port imports nothing of the
// JAX package, so it keeps its own).
//
// The reference implements its entire runtime in C (orchestrator
// src/interface.c, fixture IO src/image_processing.c:122-201).  What remains
// host-side and hot is the input pipeline: parsing the reference's ".txt"
// fixture format ("W H" header, one "r g b" line per pixel) and packing
// pixel buffers.  numpy's loadtxt is ~6x slower for corpus-scale fixture IO,
// so these paths are C++ with ctypes bindings
// (photohive_dsp_tpu_torch/runtime/__init__.py); every entry point has a
// pure-numpy fallback.
//
// Build: c++ -O2 -shared -fPIC native.cpp -o _phnative.so, done at first use
// into photohive_dsp_tpu_torch/_build/native/ by runtime/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open_file(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size == 0) {
            ::close(fd);
            return false;
        }
        size = static_cast<size_t>(st.st_size);
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) {
            ::close(fd);
            return false;
        }
        data = static_cast<const char*>(p);
        return true;
    }

    ~MappedFile() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

// Parse the next nonnegative integer; returns -1 at end of buffer and -2 on
// malformed content.
inline long next_int(const char*& p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
        ++p;
    if (p >= end) return -1;
    if (*p < '0' || *p > '9') return -2;
    long v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
    }
    return v;
}

}  // namespace

extern "C" {

// Reads "W H" from the header.  Returns 0 on success.
int phn_read_txt_header(const char* path, int* w, int* h) {
    MappedFile mf;
    if (!mf.open_file(path)) return 1;
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    long wv = next_int(p, end);
    long hv = next_int(p, end);
    if (wv < 1 || hv < 1) return 2;
    *w = static_cast<int>(wv);
    *h = static_cast<int>(hv);
    return 0;
}

// Reads the full image into out (H*W*3 uint8, interleaved row-major).
// Returns 0 on success, 2 on malformed content, 3 on out-of-range values.
int phn_read_txt_u8(const char* path, uint8_t* out, long npixels) {
    MappedFile mf;
    if (!mf.open_file(path)) return 1;
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    if (next_int(p, end) < 1 || next_int(p, end) < 1) return 2;
    long n = npixels * 3;
    for (long i = 0; i < n; ++i) {
        long v = next_int(p, end);
        if (v < 0) return 2;
        if (v > 255) return 3;
        out[i] = static_cast<uint8_t>(v);
    }
    return 0;
}

// Writes the reference format (truncated ints, src/image_processing.c:185).
int phn_write_txt_u8(const char* path, const uint8_t* rgb, int w, int h) {
    FILE* f = fopen(path, "w");
    if (!f) return 1;
    // 12 bytes per pixel worst case ("255 255 255\n")
    size_t cap = 1 << 20;
    char* buf = static_cast<char*>(malloc(cap));
    if (!buf) {
        fclose(f);
        return 4;
    }
    size_t len = static_cast<size_t>(
        snprintf(buf, cap, "%d %d\n", w, h));
    const long n = static_cast<long>(w) * h;
    for (long i = 0; i < n; ++i) {
        if (len + 16 > cap) {
            fwrite(buf, 1, len, f);
            len = 0;
        }
        len += static_cast<size_t>(snprintf(
            buf + len, cap - len, "%d %d %d\n", rgb[i * 3], rgb[i * 3 + 1],
            rgb[i * 3 + 2]));
    }
    fwrite(buf, 1, len, f);
    free(buf);
    fclose(f);
    return 0;
}

// (H, W, 3) interleaved uint8 -> (3, H, W) planar float32 in [0, 1].
void phn_planarize_u8_to_f32(const uint8_t* hwc, float* chw, long h,
                             long w) {
    const long n = h * w;
    // C++11 static-local init is thread-safe (the decode pool calls this
    // from several threads); the previous open-coded flag was a benign
    // but real data race.
    static const struct Lut {
        float v[256];
        Lut() {
            for (int i = 0; i < 256; ++i)
                v[i] = static_cast<float>(i) / 255.0f;
        }
    } lut_s;
    const float* lut = lut_s.v;
    float* r = chw;
    float* g = chw + n;
    float* b = chw + 2 * n;
    for (long i = 0; i < n; ++i) {
        r[i] = lut[hwc[i * 3]];
        g[i] = lut[hwc[i * 3 + 1]];
        b[i] = lut[hwc[i * 3 + 2]];
    }
}

}  // extern "C"
