// ptio — native image-output runtime for cpu_path_tracing_tpu.
//
// The reference's entire output path is C++ (gamma transfer in
// src/utils.cpp:11-16, PPM writer in src/main.cpp:240-247, via fmt); this
// library is its native counterpart for this framework: tone-mapping and
// PPM/PNG encoding of multi-megapixel frames without holding the Python GIL
// on the hot loop.  Exposed as a plain C ABI consumed through ctypes
// (cpu_path_tracing_tpu/utils/native.py); the Python implementations remain
// as the portable fallback and byte-compatibility oracle.
//
// Semantics are pinned to the reference: per-channel transfer
// round(clamp(x)^(1/2.2) * 255) with round-half-even (matching np.rint), P3
// PPM "P3\n{w} {h}\n255\n" + space-separated ints (src/main.cpp:241-246).

#include <cfenv>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// Gamma-2.2 transfer: float[n] linear -> uint8[n].  Mirrors
// pt::color_to_int (src/utils.cpp:11-16) with rint (half-to-even, matching
// numpy's np.rint used by the Python path).
void ptio_tonemap_u8(const float* img, int64_t n, uint8_t* out) {
    constexpr double inv_gamma = 1.0 / 2.2;
    for (int64_t i = 0; i < n; ++i) {
        double x = static_cast<double>(img[i]);
        if (x < 0.0) x = 0.0;
        if (x > 1.0) x = 1.0;
        double corrected = std::pow(x, inv_gamma);
        out[i] = static_cast<uint8_t>(std::rint(corrected * 255.0));
    }
}

// P3 PPM writer, byte-compatible with src/main.cpp:240-247 ("{} " per
// channel, header "P3\n{w} {h}\n255\n").  Returns 0 on success.
int ptio_write_ppm(const char* path, const float* img, int32_t width, int32_t height) {
    const int64_t n = static_cast<int64_t>(width) * height * 3;
    std::vector<uint8_t> u8(n);
    ptio_tonemap_u8(img, n, u8.data());

    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    std::string buf;
    buf.reserve(static_cast<size_t>(n) * 4 + 32);
    char head[48];
    std::snprintf(head, sizeof head, "P3\n%d %d\n255\n", width, height);
    buf += head;
    char tmp[8];
    for (int64_t i = 0; i < n; ++i) {
        int len = std::snprintf(tmp, sizeof tmp, "%d ", u8[i]);
        buf.append(tmp, static_cast<size_t>(len));
    }
    size_t written = std::fwrite(buf.data(), 1, buf.size(), f);
    int rc = (written == buf.size()) ? 0 : 2;
    return std::fclose(f) == 0 ? rc : 3;
}

static void put_be32(std::string& s, uint32_t v) {
    s.push_back(static_cast<char>((v >> 24) & 0xff));
    s.push_back(static_cast<char>((v >> 16) & 0xff));
    s.push_back(static_cast<char>((v >> 8) & 0xff));
    s.push_back(static_cast<char>(v & 0xff));
}

static void put_chunk(std::string& s, const char tag[4], const std::string& data) {
    put_be32(s, static_cast<uint32_t>(data.size()));
    std::string td(tag, 4);
    td += data;
    s += td;
    put_be32(s, static_cast<uint32_t>(crc32(0L, reinterpret_cast<const Bytef*>(td.data()),
                                            static_cast<uInt>(td.size()))));
}

// RGB8 PNG writer (zlib deflate level 6, filter 0 per row — the same stream
// the Python fallback produces).  Returns 0 on success.
int ptio_write_png(const char* path, const float* img, int32_t width, int32_t height) {
    const int64_t n = static_cast<int64_t>(width) * height * 3;
    std::vector<uint8_t> u8(n);
    ptio_tonemap_u8(img, n, u8.data());

    const int64_t stride = static_cast<int64_t>(width) * 3;
    std::vector<uint8_t> raw(static_cast<size_t>((stride + 1) * height));
    for (int64_t y = 0; y < height; ++y) {
        raw[static_cast<size_t>(y * (stride + 1))] = 0;  // filter: none
        std::memcpy(&raw[static_cast<size_t>(y * (stride + 1) + 1)],
                    &u8[static_cast<size_t>(y * stride)], static_cast<size_t>(stride));
    }

    uLongf comp_cap = compressBound(static_cast<uLong>(raw.size()));
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), static_cast<uLong>(raw.size()), 6) != Z_OK)
        return 4;

    std::string png("\x89PNG\r\n\x1a\n", 8);
    std::string ihdr;
    put_be32(ihdr, static_cast<uint32_t>(width));
    put_be32(ihdr, static_cast<uint32_t>(height));
    ihdr.push_back(8);   // bit depth
    ihdr.push_back(2);   // color type RGB
    ihdr.push_back(0);   // compression
    ihdr.push_back(0);   // filter
    ihdr.push_back(0);   // interlace
    put_chunk(png, "IHDR", ihdr);
    put_chunk(png, "IDAT", std::string(reinterpret_cast<char*>(comp.data()), comp_cap));
    put_chunk(png, "IEND", std::string());

    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    size_t written = std::fwrite(png.data(), 1, png.size(), f);
    int rc = (written == png.size()) ? 0 : 2;
    return std::fclose(f) == 0 ? rc : 3;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Async writer: a background worker thread that encodes + writes frames off
// the Python thread, so progressive checkpoint/preview flushes overlap with
// device compute instead of stalling the render loop.  The counterpart of
// the concurrency role Taskflow plays in the reference (src/main.cpp:214-236)
// on the host side of the accelerator design.  Jobs copy their pixel buffer, so the
// caller may reuse/free its array immediately after submit.
// ---------------------------------------------------------------------------

namespace {

struct WriteJob {
    std::string path;
    std::vector<float> pixels;
    int32_t width = 0, height = 0;
    bool png = true;
};

struct AsyncWriter {
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable cv_done;
    std::deque<WriteJob> queue;
    std::thread worker;
    bool started = false;
    bool stop = false;
    int in_flight = 0;   // queued + currently executing
    int errors = 0;

    void run() {
        std::unique_lock<std::mutex> lk(mu);
        while (true) {
            cv.wait(lk, [&] { return stop || !queue.empty(); });
            if (queue.empty()) {
                if (stop) return;
                continue;
            }
            WriteJob job = std::move(queue.front());
            queue.pop_front();
            lk.unlock();
            int rc = job.png
                         ? ptio_write_png(job.path.c_str(), job.pixels.data(),
                                          job.width, job.height)
                         : ptio_write_ppm(job.path.c_str(), job.pixels.data(),
                                          job.width, job.height);
            lk.lock();
            if (rc != 0) ++errors;
            --in_flight;
            cv_done.notify_all();
        }
    }

    void ensure_started() {
        if (!started) {
            started = true;
            worker = std::thread([this] { run(); });
        }
    }

    // Drain outstanding jobs and join at process exit (static destruction);
    // without this the joinable thread's destructor calls std::terminate.
    ~AsyncWriter() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        if (worker.joinable()) worker.join();
    }
};

AsyncWriter g_writer;

}  // namespace

extern "C" {

// Enqueue a frame; returns immediately (the buffer is copied).  fmt_png != 0
// writes PNG, else P3 PPM.
void ptio_async_submit(const char* path, const float* img, int32_t width,
                       int32_t height, int32_t fmt_png) {
    WriteJob job;
    job.path = path;
    job.width = width;
    job.height = height;
    job.png = fmt_png != 0;
    job.pixels.assign(img, img + static_cast<int64_t>(width) * height * 3);
    std::lock_guard<std::mutex> lk(g_writer.mu);
    g_writer.ensure_started();
    g_writer.queue.push_back(std::move(job));
    ++g_writer.in_flight;
    g_writer.cv.notify_one();
}

// Number of jobs not yet fully written.
int ptio_async_pending() {
    std::lock_guard<std::mutex> lk(g_writer.mu);
    return g_writer.in_flight;
}

// Block until every submitted job has been written; returns the number of
// jobs that failed since the last call (and resets the error counter).
int ptio_async_wait() {
    std::unique_lock<std::mutex> lk(g_writer.mu);
    g_writer.cv_done.wait(lk, [&] { return g_writer.in_flight == 0; });
    int errs = g_writer.errors;
    g_writer.errors = 0;
    return errs;
}

}  // extern "C"
