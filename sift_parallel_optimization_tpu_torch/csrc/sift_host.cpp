// Host-side native runtime of the PyTorch port: frame synthesis and
// rendering, PGM/PPM (and, where libpng exists, PNG) image I/O, a
// multithreaded prefetching ring loader and a monotonic ms clock. No device
// code; bound with ctypes (utils/native.py).
//
// A copy of native/sift_host.cpp (the JAX package's library), which must
// stay equal to it in xorshift, uniform01, sift_synth_frame,
// sift_render_frame, the PGM/PPM/PNG readers and writers and the ring
// loader's frame order, so frames are bitwise equal to that library's when
// both are built with the same flags on the same machine
// (tests/test_torch_native_loader.py holds the frames and the loader to
// it). Where it differs, on purpose:
//   * the two libpng functions (sift_read_png, sift_write_png) exist only
//     when SIFT_HAVE_PNG is defined: utils/native.py builds with
//     -DSIFT_HAVE_PNG -lpng first and without both where libpng is missing,
//     so the rest of the library serves frames on a machine without libpng;
//   * sift_synth_frame wraps a blob's columns by whole frames (x % size).
//     The original wraps once, which agrees wherever a blob is narrower
//     than the frame (every size above 48) and writes out of bounds below;
//   * <cctype> is included explicitly.
//
//   * PGM (P5/P2) read/write and PPM (P6/P3) read, Rec.601 luma to gray.
//   * Deterministic synthetic frames (blob field + value noise) and a
//     pinhole rendering of a 3-D blob cloud (real parallax).
//   * A ring loader: N worker threads fill a ring of frame buffers ahead of
//     the consumer, so frame generation overlaps device work.
//   * sift_now_ms: a monotonic clock in ms.

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>
#include <chrono>

#ifdef SIFT_HAVE_PNG
#include <png.h>
#endif

namespace {

// xorshift64* — deterministic, seedable, fast.
static inline uint64_t xorshift(uint64_t& s) {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
}

static inline float uniform01(uint64_t& s) {
    return (xorshift(s) >> 40) * (1.0f / 16777216.0f);
}

void synth_frame(float* out, int size, int frame_idx, uint64_t seed) {
    uint64_t s = seed * 0x9E3779B97F4A7C15ULL + (uint64_t)frame_idx + 1;
    for (int i = 0; i < size * size; i++) out[i] = 0.5f;
    // Blob field: count scales with area; positions drift with frame_idx
    // so consecutive frames overlap (trackable, like a moving camera).
    int n_blobs = size * size / 820;
    if (n_blobs < 8) n_blobs = 8;
    uint64_t scene = seed * 0x9E3779B97F4A7C15ULL + 12345;  // frame-stable
    float drift = 0.9f * (float)frame_idx;
    for (int b = 0; b < n_blobs; b++) {
        float cy = uniform01(scene) * size;
        float cx = uniform01(scene) * size - drift;
        // wrap horizontally so content stays in frame
        cx = cx - size * std::floor(cx / size);
        float sig = 2.0f + uniform01(scene) * 6.0f;
        float amp = (uniform01(scene) - 0.5f) * 0.8f;
        int r = (int)(3.0f * sig);
        int y0 = (int)cy - r, y1 = (int)cy + r;
        if (y0 < 0) y0 = 0;
        if (y1 >= size) y1 = size - 1;
        float inv = 1.0f / (2.0f * sig * sig);
        for (int y = y0; y <= y1; y++) {
            float dy2 = (y - cy) * (y - cy);
            for (int x = (int)cx - r; x <= (int)cx + r; x++) {
                // Wrap by whole frames: a blob wider than a small frame
                // wraps more than once.
                int xw = x % size;
                if (xw < 0) xw += size;
                float dx2 = (x - cx) * (x - cx);
                out[y * size + xw] += amp * std::exp(-(dx2 + dy2) * inv);
            }
        }
    }
    // Per-frame value noise so descriptors are distinctive.
    for (int i = 0; i < size * size; i++) {
        out[i] += 0.06f * (uniform01(s) - 0.5f);
        if (out[i] < 0.0f) out[i] = 0.0f;
        if (out[i] > 1.0f) out[i] = 1.0f;
    }
}

struct Loader {
    int size = 0;
    int n_buffers = 0;
    uint64_t seed = 0;
    std::vector<std::vector<float>> buffers;
    std::queue<int> ready;       // filled buffer slots (with frame idx)
    std::queue<int> ready_frame;
    std::queue<int> free_slots;  // slots to refill
    std::mutex mu;
    std::condition_variable cv_ready, cv_free;
    std::atomic<int> next_frame{0};
    std::atomic<bool> stop{false};
    std::vector<std::thread> workers;

    void worker() {
        while (true) {
            int slot;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_free.wait(lk, [&] { return stop || !free_slots.empty(); });
                if (stop) return;
                slot = free_slots.front();
                free_slots.pop();
            }
            int frame = next_frame.fetch_add(1);
            synth_frame(buffers[slot].data(), size, frame, seed);
            {
                std::lock_guard<std::mutex> lk(mu);
                ready.push(slot);
                ready_frame.push(frame);
            }
            cv_ready.notify_one();
        }
    }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// PGM I/O
// ---------------------------------------------------------------------------

// Reads a P5/P2 PGM into out (row-major, [0,1] floats). Returns 0 on
// success. w/h receive dimensions; fails if w*h > max_pixels.
int sift_read_pgm(const char* path, float* out, int* w, int* h,
                  long max_pixels) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char magic[3] = {0};
    if (std::fscanf(f, "%2s", magic) != 1) { std::fclose(f); return -2; }
    bool binary = std::strcmp(magic, "P5") == 0;
    if (!binary && std::strcmp(magic, "P2") != 0) { std::fclose(f); return -3; }
    // Skip comments.
    int vals[3], got = 0;
    while (got < 3) {
        int c = std::fgetc(f);
        if (c == '#') { while (c != '\n' && c != EOF) c = std::fgetc(f); }
        else if (c == EOF) { std::fclose(f); return -4; }
        else if (!std::isspace(c)) {
            std::ungetc(c, f);
            if (std::fscanf(f, "%d", &vals[got]) != 1) { std::fclose(f); return -4; }
            got++;
        }
    }
    int W = vals[0], H = vals[1], maxv = vals[2];
    if ((long)W * H > max_pixels || maxv <= 0) { std::fclose(f); return -5; }
    float inv = 1.0f / maxv;
    if (binary) {
        std::fgetc(f);  // single whitespace after header
        if (maxv < 256) {
            std::vector<uint8_t> row(W);
            for (int y = 0; y < H; y++) {
                if (std::fread(row.data(), 1, W, f) != (size_t)W) { std::fclose(f); return -6; }
                for (int x = 0; x < W; x++) out[y * W + x] = row[x] * inv;
            }
        } else {
            std::vector<uint8_t> row(2 * W);
            for (int y = 0; y < H; y++) {
                if (std::fread(row.data(), 1, 2 * W, f) != (size_t)(2 * W)) { std::fclose(f); return -6; }
                for (int x = 0; x < W; x++)
                    out[y * W + x] = ((row[2 * x] << 8) | row[2 * x + 1]) * inv;
            }
        }
    } else {
        for (long i = 0; i < (long)W * H; i++) {
            int v;
            if (std::fscanf(f, "%d", &v) != 1) { std::fclose(f); return -6; }
            out[i] = v * inv;
        }
    }
    std::fclose(f);
    *w = W;
    *h = H;
    return 0;
}

// Writes a binary P5 PGM (8-bit) from [0,1] floats. Returns 0 on success.
int sift_write_pgm(const char* path, const float* img, int w, int h) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fprintf(f, "P5\n%d %d\n255\n", w, h);
    std::vector<uint8_t> row(w);
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            float v = img[y * w + x];
            if (v < 0) v = 0;
            if (v > 1) v = 1;
            row[x] = (uint8_t)(v * 255.0f + 0.5f);
        }
        std::fwrite(row.data(), 1, w, f);
    }
    std::fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// PPM / PNG decode (grayscale via Rec.601 luma)
// ---------------------------------------------------------------------------

// Reads a P6/P3 PPM, converting RGB -> luma. Same contract as
// sift_read_pgm. Returns 0 on success.
int sift_read_ppm(const char* path, float* out, int* w, int* h,
                  long max_pixels) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char magic[3] = {0};
    if (std::fscanf(f, "%2s", magic) != 1) { std::fclose(f); return -2; }
    bool binary = std::strcmp(magic, "P6") == 0;
    if (!binary && std::strcmp(magic, "P3") != 0) { std::fclose(f); return -3; }
    int vals[3], got = 0;
    while (got < 3) {
        int c = std::fgetc(f);
        if (c == '#') { while (c != '\n' && c != EOF) c = std::fgetc(f); }
        else if (c == EOF) { std::fclose(f); return -4; }
        else if (!std::isspace(c)) {
            std::ungetc(c, f);
            if (std::fscanf(f, "%d", &vals[got]) != 1) { std::fclose(f); return -4; }
            got++;
        }
    }
    int W = vals[0], H = vals[1], maxv = vals[2];
    if ((long)W * H > max_pixels || maxv <= 0) { std::fclose(f); return -5; }
    float inv = 1.0f / maxv;
    const float wr = 0.299f, wg = 0.587f, wb = 0.114f;
    if (binary) {
        std::fgetc(f);
        int bpp = maxv < 256 ? 3 : 6;
        std::vector<uint8_t> row((size_t)bpp * W);
        for (int y = 0; y < H; y++) {
            if (std::fread(row.data(), 1, (size_t)bpp * W, f)
                != (size_t)bpp * W) { std::fclose(f); return -6; }
            for (int x = 0; x < W; x++) {
                float r, g, b;
                if (bpp == 3) {
                    r = row[3 * x]; g = row[3 * x + 1]; b = row[3 * x + 2];
                } else {
                    r = (row[6 * x] << 8) | row[6 * x + 1];
                    g = (row[6 * x + 2] << 8) | row[6 * x + 3];
                    b = (row[6 * x + 4] << 8) | row[6 * x + 5];
                }
                out[y * W + x] = (wr * r + wg * g + wb * b) * inv;
            }
        }
    } else {
        for (long i = 0; i < (long)W * H; i++) {
            int r, g, b;
            if (std::fscanf(f, "%d %d %d", &r, &g, &b) != 3) {
                std::fclose(f); return -6;
            }
            out[i] = (wr * r + wg * g + wb * b) * inv;
        }
    }
    std::fclose(f);
    *w = W;
    *h = H;
    return 0;
}

#ifdef SIFT_HAVE_PNG
// Reads any PNG (gray/RGB/RGBA, 8/16-bit) as 8-bit grayscale via libpng's
// simplified API (libpng handles the colortype conversion). Returns 0 on
// success.
int sift_read_png(const char* path, float* out, int* w, int* h,
                  long max_pixels) {
    png_image image;
    std::memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_file(&image, path)) return -1;
    image.format = PNG_FORMAT_GRAY;
    if ((long)image.width * image.height > max_pixels) {
        png_image_free(&image);
        return -5;
    }
    std::vector<uint8_t> buf(PNG_IMAGE_SIZE(image));
    if (!png_image_finish_read(&image, nullptr, buf.data(), 0, nullptr)) {
        png_image_free(&image);
        return -6;
    }
    const float inv = 1.0f / 255.0f;
    long n = (long)image.width * image.height;
    for (long i = 0; i < n; i++) out[i] = buf[i] * inv;
    *w = (int)image.width;
    *h = (int)image.height;
    return 0;
}

// Writes an 8-bit grayscale PNG from [0,1] floats. Returns 0 on success.
int sift_write_png(const char* path, const float* img, int w, int h) {
    std::vector<uint8_t> buf((size_t)w * h);
    for (long i = 0; i < (long)w * h; i++) {
        float v = img[i];
        if (v < 0) v = 0;
        if (v > 1) v = 1;
        buf[i] = (uint8_t)(v * 255.0f + 0.5f);
    }
    png_image image;
    std::memset(&image, 0, sizeof image);
    image.version = PNG_IMAGE_VERSION;
    image.width = (png_uint_32)w;
    image.height = (png_uint_32)h;
    image.format = PNG_FORMAT_GRAY;
    if (!png_image_write_to_file(&image, path, 0, buf.data(), 0, nullptr))
        return -1;
    return 0;
}
#endif  // SIFT_HAVE_PNG

// ---------------------------------------------------------------------------
// Synthetic frames
// ---------------------------------------------------------------------------

void sift_synth_frame(float* out, int size, int frame_idx, uint64_t seed) {
    synth_frame(out, size, frame_idx, seed);
}

// Renders a view of a deterministic 3-D Gaussian-blob cloud with a pinhole
// camera — frames rendered along a moving trajectory have REAL parallax,
// which 2-D drifting textures (sift_synth_frame) cannot provide; a planar
// translating scene is degenerate for epipolar geometry / SfM.
//
// rvec: axis-angle world->cam rotation; tvec: translation; focal: pixels.
void sift_render_frame(float* out, int size, const float* rvec,
                       const float* tvec, float focal, uint64_t seed) {
    // Rodrigues.
    float th = std::sqrt(rvec[0] * rvec[0] + rvec[1] * rvec[1]
                         + rvec[2] * rvec[2]);
    float R[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    if (th > 1e-8f) {
        float kx = rvec[0] / th, ky = rvec[1] / th, kz = rvec[2] / th;
        float c = std::cos(th), s = std::sin(th), v = 1.0f - c;
        R[0] = c + kx * kx * v;      R[1] = kx * ky * v - kz * s;  R[2] = kx * kz * v + ky * s;
        R[3] = ky * kx * v + kz * s; R[4] = c + ky * ky * v;       R[5] = ky * kz * v - kx * s;
        R[6] = kz * kx * v - ky * s; R[7] = kz * ky * v + kx * s;  R[8] = c + kz * kz * v;
    }
    for (int i = 0; i < size * size; i++) out[i] = 0.5f;
    uint64_t scene = seed * 0x9E3779B97F4A7C15ULL + 777;
    int n_blobs = 220;
    float cx0 = size * 0.5f, cy0 = size * 0.5f;
    for (int b = 0; b < n_blobs; b++) {
        float X = (uniform01(scene) - 0.5f) * 12.0f;
        float Y = (uniform01(scene) - 0.5f) * 9.0f;
        float Z = 6.0f + uniform01(scene) * 12.0f;
        float wsig = 0.05f + uniform01(scene) * 0.12f;
        float amp = (uniform01(scene) - 0.5f) * 0.9f;
        float xc = R[0] * X + R[1] * Y + R[2] * Z + tvec[0];
        float yc = R[3] * X + R[4] * Y + R[5] * Z + tvec[1];
        float zc = R[6] * X + R[7] * Y + R[8] * Z + tvec[2];
        if (zc < 0.5f) continue;
        float u = focal * xc / zc + cx0;
        float v = focal * yc / zc + cy0;
        float sig = focal * wsig / zc;
        if (sig < 0.8f) sig = 0.8f;
        int r = (int)(3.0f * sig) + 1;
        if (u + r < 0 || u - r >= size || v + r < 0 || v - r >= size) continue;
        int y0 = (int)v - r, y1 = (int)v + r;
        int x0 = (int)u - r, x1 = (int)u + r;
        if (y0 < 0) y0 = 0;
        if (y1 >= size) y1 = size - 1;
        if (x0 < 0) x0 = 0;
        if (x1 >= size) x1 = size - 1;
        float inv = 1.0f / (2.0f * sig * sig);
        for (int y = y0; y <= y1; y++) {
            float dy2 = (y - v) * (y - v);
            for (int x = x0; x <= x1; x++) {
                float dx2 = (x - u) * (x - u);
                out[y * size + x] += amp * std::exp(-(dx2 + dy2) * inv);
            }
        }
    }
    // Light per-view noise; keep it small so descriptors stay matchable.
    // Seeded per POSE — screen-fixed noise repeated across views would add
    // a spurious zero-motion texture layer that corrupts SfM.
    uint64_t pose_hash = 0;
    for (int i = 0; i < 3; i++) {
        uint32_t rb, tb;
        std::memcpy(&rb, &rvec[i], 4);
        std::memcpy(&tb, &tvec[i], 4);
        pose_hash = pose_hash * 0x100000001B3ULL ^ rb;
        pose_hash = pose_hash * 0x100000001B3ULL ^ tb;
    }
    uint64_t s = seed * 0x2545F4914F6CDD1DULL + 99991 + pose_hash;
    for (int i = 0; i < size * size; i++) {
        out[i] += 0.02f * (uniform01(s) - 0.5f);
        if (out[i] < 0.0f) out[i] = 0.0f;
        if (out[i] > 1.0f) out[i] = 1.0f;
    }
}

// ---------------------------------------------------------------------------
// Prefetching ring loader
// ---------------------------------------------------------------------------

void* sift_loader_create(int size, int n_buffers, int n_threads,
                         uint64_t seed) {
    if (size <= 0 || n_buffers < 2 || n_threads < 1) return nullptr;
    Loader* ld = new Loader();
    ld->size = size;
    ld->n_buffers = n_buffers;
    ld->seed = seed;
    ld->buffers.resize(n_buffers);
    for (auto& b : ld->buffers) b.resize((size_t)size * size);
    for (int i = 0; i < n_buffers; i++) ld->free_slots.push(i);
    for (int t = 0; t < n_threads; t++)
        ld->workers.emplace_back(&Loader::worker, ld);
    return ld;
}

// Blocks until a frame is ready; returns the buffer pointer and writes the
// frame index. Caller must release the same pointer when done.
float* sift_loader_acquire(void* handle, int* frame_idx) {
    Loader* ld = (Loader*)handle;
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_ready.wait(lk, [&] { return !ld->ready.empty(); });
    int slot = ld->ready.front();
    ld->ready.pop();
    *frame_idx = ld->ready_frame.front();
    ld->ready_frame.pop();
    return ld->buffers[slot].data();
}

void sift_loader_release(void* handle, float* buf) {
    Loader* ld = (Loader*)handle;
    for (int i = 0; i < ld->n_buffers; i++) {
        if (ld->buffers[i].data() == buf) {
            {
                std::lock_guard<std::mutex> lk(ld->mu);
                ld->free_slots.push(i);
            }
            ld->cv_free.notify_one();
            return;
        }
    }
}

void sift_loader_destroy(void* handle) {
    Loader* ld = (Loader*)handle;
    {
        std::lock_guard<std::mutex> lk(ld->mu);
        ld->stop = true;
    }
    ld->cv_free.notify_all();
    for (auto& t : ld->workers) t.join();
    delete ld;
}

// ---------------------------------------------------------------------------
// Timing
// ---------------------------------------------------------------------------

double sift_now_ms() {
    auto t = std::chrono::steady_clock::now().time_since_epoch();
    return std::chrono::duration<double, std::milli>(t).count();
}

}  // extern "C"
