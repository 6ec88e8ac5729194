// Native host-side runtime for codec-eval-tpu.
//
// The accelerator owns the metric math (JAX/XLA); this library owns the
// host-side hot paths around it, the role the reference fills with native
// Rust crates (SURVEY.md §2.4): corpus checksumming (FNV-1a, reference
// src/corpus/checksum.rs), the PPM fast-decode cache (reference
// crates/codec-iter/src/source.rs:62-92), and sRGB→linear batch staging for
// device infeed (the host half of the upload pipeline that replaces
// crates/codec-iter/src/gpu.rs).
//
// Build: make -C native   (produces libcodec_eval_native.so)
// Python binding: codec_eval_tpu/utils/native.py (ctypes, with pure-Python
// fallbacks when the library is absent).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// FNV-1a 64-bit
// ---------------------------------------------------------------------------

uint64_t ce_fnv1a64(const uint8_t* data, size_t len) {
    uint64_t h = 0xcbf29ce484222325ULL;
    const uint64_t prime = 0x100000001b3ULL;
    // 8-way unrolled; the compiler vectorizes the xor-multiply chain poorly,
    // but unrolling still doubles throughput on this loop.
    size_t i = 0;
    for (; i + 8 <= len; i += 8) {
        h = (h ^ data[i + 0]) * prime;
        h = (h ^ data[i + 1]) * prime;
        h = (h ^ data[i + 2]) * prime;
        h = (h ^ data[i + 3]) * prime;
        h = (h ^ data[i + 4]) * prime;
        h = (h ^ data[i + 5]) * prime;
        h = (h ^ data[i + 6]) * prime;
        h = (h ^ data[i + 7]) * prime;
    }
    for (; i < len; ++i) h = (h ^ data[i]) * prime;
    return h;
}

uint64_t ce_fnv1a64_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return 0;
    uint64_t h = 0xcbf29ce484222325ULL;
    const uint64_t prime = 0x100000001b3ULL;
    static thread_local uint8_t buf[1 << 20];
    size_t n;
    while ((n = fread(buf, 1, sizeof(buf), f)) > 0) {
        for (size_t i = 0; i < n; ++i) h = (h ^ buf[i]) * prime;
    }
    fclose(f);
    return h;
}

// ---------------------------------------------------------------------------
// sRGB u8 -> linear f32 staging (LUT)
// ---------------------------------------------------------------------------

static float g_srgb_lut[256];
static bool g_lut_init = false;

static void init_lut() {
    if (g_lut_init) return;
    for (int i = 0; i < 256; ++i) {
        double v = i / 255.0;
        g_srgb_lut[i] = (float)(v <= 0.04045 ? v / 12.92
                                             : pow((v + 0.055) / 1.055, 2.4));
    }
    g_lut_init = true;
}

// Convert n u8 samples to linear f32.  Used to stage decoded batches for
// device transfer without burning Python time.
void ce_srgb_to_linear(const uint8_t* in, float* out, size_t n) {
    init_lut();
    for (size_t i = 0; i < n; ++i) out[i] = g_srgb_lut[in[i]];
}

// Copy an (h, w, 3) u8 image into a zero-padded (ph, pw, 3) u8 buffer
// (batch staging for fixed-shape device buckets).
void ce_pad_image_u8(const uint8_t* in, size_t h, size_t w,
                     uint8_t* out, size_t ph, size_t pw) {
    memset(out, 0, ph * pw * 3);
    for (size_t y = 0; y < h; ++y) {
        memcpy(out + y * pw * 3, in + y * w * 3, w * 3);
    }
}

// ---------------------------------------------------------------------------
// PPM fast cache (binary P6, maxval 255)
// ---------------------------------------------------------------------------

// Returns 0 on success.
int ce_write_ppm(const char* path, const uint8_t* rgb, uint32_t w, uint32_t h) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    fprintf(f, "P6\n%u %u\n255\n", w, h);
    size_t n = (size_t)w * h * 3;
    size_t written = fwrite(rgb, 1, n, f);
    fclose(f);
    return written == n ? 0 : 2;
}

// Reads dimensions into *w/*h. If rgb is null, only parses the header.
// Returns 0 on success.
int ce_read_ppm(const char* path, uint8_t* rgb, size_t rgb_cap,
                uint32_t* w, uint32_t* h) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    char magic[3] = {0};
    unsigned width = 0, height = 0, maxval = 0;
    if (fscanf(f, "%2s %u %u %u", magic, &width, &height, &maxval) != 4 ||
        strcmp(magic, "P6") != 0 || maxval != 255) {
        fclose(f);
        return 2;
    }
    fgetc(f);  // single whitespace after maxval
    *w = width;
    *h = height;
    if (rgb) {
        size_t n = (size_t)width * height * 3;
        if (rgb_cap < n || fread(rgb, 1, n, f) != n) {
            fclose(f);
            return 3;
        }
    }
    fclose(f);
    return 0;
}

}  // extern "C"
