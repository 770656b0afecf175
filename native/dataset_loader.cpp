// Threaded dataset prefetcher: decode-ahead pipeline for frame sequences.
//
// The native runtime piece of the framework's IO path: a worker pool reads
// and PNG-decodes files ahead of the consumer, keeping a bounded in-order
// buffer full, so the Python side (and the device feed) only ever copies a
// ready frame.  C++17 + pthreads; interface is plain C for ctypes.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int png_probe(const uint8_t* data, long size,
              int* width, int* height, int* channels, int* bit_depth);
int png_decode(const uint8_t* data, long size, uint8_t* out);
}

namespace {

struct Decoded {
    int status = -100;
    int width = 0, height = 0, channels = 0, bit_depth = 0;
    std::vector<uint8_t> pixels;
};

struct Loader {
    std::vector<std::string> paths;
    size_t capacity;
    std::vector<std::thread> workers;

    std::mutex mu;
    std::condition_variable cv_ready;    // consumer waits for results
    std::condition_variable cv_space;    // workers wait for window space
    std::map<size_t, Decoded> ready;
    size_t next_to_fetch = 0;            // next index a worker should take
    size_t next_to_consume = 0;          // next index the consumer wants
    bool stopping = false;

    Decoded decode_one(const std::string& path) {
        Decoded d;
        std::ifstream f(path, std::ios::binary | std::ios::ate);
        if (!f) { d.status = -20; return d; }
        std::streamsize size = f.tellg();
        f.seekg(0);
        std::vector<uint8_t> data(static_cast<size_t>(size));
        if (!f.read(reinterpret_cast<char*>(data.data()), size)) {
            d.status = -21;
            return d;
        }
        int rc = png_probe(data.data(), size, &d.width, &d.height,
                           &d.channels, &d.bit_depth);
        if (rc != 0) { d.status = rc; return d; }
        d.pixels.resize(static_cast<size_t>(d.width) * d.height *
                        d.channels * (d.bit_depth / 8));
        d.status = png_decode(data.data(), size, d.pixels.data());
        return d;
    }

    void worker() {
        for (;;) {
            size_t idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] {
                    return stopping ||
                           (next_to_fetch < paths.size() &&
                            next_to_fetch < next_to_consume + capacity);
                });
                if (stopping) return;
                idx = next_to_fetch++;
            }
            Decoded d = decode_one(paths[idx]);
            {
                std::lock_guard<std::mutex> lk(mu);
                ready.emplace(idx, std::move(d));
            }
            cv_ready.notify_all();
        }
    }

    Decoded take(size_t idx) {
        std::unique_lock<std::mutex> lk(mu);
        cv_ready.wait(lk, [&] { return ready.count(idx) != 0; });
        Decoded d = std::move(ready[idx]);
        ready.erase(idx);
        next_to_consume = idx + 1;
        cv_space.notify_all();
        return d;
    }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int n_threads,
                    int capacity) {
    auto* L = new Loader();
    L->paths.assign(paths, paths + n_paths);
    L->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 4;
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i)
        L->workers.emplace_back([L] { L->worker(); });
    return L;
}

// Blocks until frame ``index`` is decoded.  Fills shape info; the pixel
// buffer stays owned by the loader until loader_copy is called.
int loader_shape(void* handle, long index,
                 int* width, int* height, int* channels, int* bit_depth) {
    auto* L = static_cast<Loader*>(handle);
    if (index < 0 || static_cast<size_t>(index) >= L->paths.size())
        return -30;
    // consume strictly in order; random access re-decodes
    Decoded d = L->take(static_cast<size_t>(index));
    *width = d.width;
    *height = d.height;
    *channels = d.channels;
    *bit_depth = d.bit_depth;
    int status = d.status;
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->ready.emplace(static_cast<size_t>(index) | (1ull << 62),
                         std::move(d));
    }
    return status;
}

// Copy the frame fetched by the preceding loader_shape call.
int loader_copy(void* handle, long index, uint8_t* out, long out_size) {
    auto* L = static_cast<Loader*>(handle);
    size_t key = static_cast<size_t>(index) | (1ull << 62);
    std::lock_guard<std::mutex> lk(L->mu);
    auto it = L->ready.find(key);
    if (it == L->ready.end()) return -31;
    if (static_cast<long>(it->second.pixels.size()) != out_size) return -32;
    std::memcpy(out, it->second.pixels.data(), out_size);
    L->ready.erase(it);
    return 0;
}

void loader_destroy(void* handle) {
    auto* L = static_cast<Loader*>(handle);
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->stopping = true;
    }
    L->cv_space.notify_all();
    for (auto& t : L->workers) t.join();
    delete L;
}

// One-shot synchronous decode (no pipeline) for single files.
int decode_png_file(const char* path, uint8_t* out, long out_size,
                    int* width, int* height, int* channels, int* bit_depth) {
    std::ifstream f(path, std::ios::binary | std::ios::ate);
    if (!f) return -20;
    std::streamsize size = f.tellg();
    f.seekg(0);
    std::vector<uint8_t> data(static_cast<size_t>(size));
    if (!f.read(reinterpret_cast<char*>(data.data()), size)) return -21;
    int rc = png_probe(data.data(), size, width, height, channels,
                       bit_depth);
    if (rc != 0) return rc;
    long need = static_cast<long>(*width) * *height * *channels *
                (*bit_depth / 8);
    if (out == nullptr) return 0;  // size query: shape fields are filled
    if (need > out_size) return -33;
    return png_decode(data.data(), size, out);
}

}  // extern "C"
