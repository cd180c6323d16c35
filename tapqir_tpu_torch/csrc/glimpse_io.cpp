// Native Glimpse frame decoder (the port's copy of the JAX package's
// tapqir_tpu/csrc/glimpse_io.cpp; the same C interface).
//
// A raw Glimpse frame is big-endian int16 at a per-frame byte offset of a
// ``<filenumber>.glimpse`` file, stored minus 2^15. These functions fuse
// read + byte-swap + unsigned shift (+2^15) and open each file once for a
// batch of frames.
//
// Built at first use by tapqir_tpu_torch/csrc/glimpse_native.py:
// g++ -O3 -shared -fPIC -o <_build>/libglimpse_io_<tag>.so glimpse_io.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Read one frame: big-endian int16 at byte `offset`, -> int32 + 32768.
// Returns 0 on success, nonzero errno-style code on failure.
int read_frame_i32(const char* path, long long offset, int height, int width,
                   int32_t* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    if (std::fseek(f, (long)offset, SEEK_SET) != 0) {
        std::fclose(f);
        return 2;
    }
    const size_t n = (size_t)height * (size_t)width;
    uint16_t* buf = new uint16_t[n];
    size_t got = std::fread(buf, sizeof(uint16_t), n, f);
    std::fclose(f);
    if (got != n) {
        delete[] buf;
        return 3;
    }
    for (size_t i = 0; i < n; ++i) {
        uint16_t be = buf[i];
        int16_t v = (int16_t)((be >> 8) | (be << 8));  // big-endian -> host
        out[i] = (int32_t)v + 32768;
    }
    delete[] buf;
    return 0;
}

// Read a batch of frames from ONE file (one open). offsets has n entries.
int read_frames_i32(const char* path, const long long* offsets, int n,
                    int height, int width, int32_t* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    const size_t npx = (size_t)height * (size_t)width;
    uint16_t* buf = new uint16_t[npx];
    for (int k = 0; k < n; ++k) {
        if (std::fseek(f, (long)offsets[k], SEEK_SET) != 0) {
            delete[] buf;
            std::fclose(f);
            return 2;
        }
        size_t got = std::fread(buf, sizeof(uint16_t), npx, f);
        if (got != npx) {
            delete[] buf;
            std::fclose(f);
            return 3;
        }
        int32_t* dst = out + (size_t)k * npx;
        for (size_t i = 0; i < npx; ++i) {
            uint16_t be = buf[i];
            int16_t v = (int16_t)((be >> 8) | (be << 8));
            dst[i] = (int32_t)v + 32768;
        }
    }
    delete[] buf;
    std::fclose(f);
    return 0;
}

// Crop P x P AOIs from a decoded frame: for each AOI i, copy
// img[sy[i]:sy[i]+P, sx[i]:sx[i]+P] into out[i].
int crop_aois_i32(const int32_t* img, int height, int width, const int* sx,
                  const int* sy, int n_aoi, int P, int32_t* out) {
    for (int a = 0; a < n_aoi; ++a) {
        if (sy[a] < 0 || sx[a] < 0 || sy[a] + P > height || sx[a] + P > width)
            return 1;
        for (int r = 0; r < P; ++r) {
            std::memcpy(out + ((size_t)a * P + r) * P,
                        img + (size_t)(sy[a] + r) * width + sx[a],
                        (size_t)P * sizeof(int32_t));
        }
    }
    return 0;
}

}  // extern "C"
