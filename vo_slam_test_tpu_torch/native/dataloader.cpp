// Native RGB-D dataset loader: threaded PNG decode + ordered prefetch.
//
// The reference decodes images synchronously on the tracking thread with
// cv::imread (vo_run.cpp:109-110). For the GPU pipeline the host-side decode
// is the only real CPU work per frame, so it runs here as a C++ worker pool
// that stays ahead of the consumer: gray is converted with the BT.601 luma
// (matching cv::cvtColor BGR2GRAY rounding) and 16-bit depth is scaled to
// meters. Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this
// environment).
//
// Build: native/loader.py compiles it at first use with
// g++ -O3 -shared -fPIC -std=c++17 ... -lpng -lz -lpthread into _build/.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> gray;
  std::vector<float> depth;
  int width = 0;
  int height = 0;
  bool ready = false;
  bool failed = false;
};

struct PngImage {
  std::vector<uint8_t> data;  // row-major, channels interleaved
  int width = 0, height = 0, channels = 0, bit_depth = 0;
};

bool read_png(const char* path, PngImage* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // little-endian u16
  png_read_update_info(png, info);

  out->width = png_get_image_width(png, info);
  out->height = png_get_image_height(png, info);
  out->channels = png_get_channels(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(rowbytes * out->height);
  std::vector<png_bytep> rows(out->height);
  for (int y = 0; y < out->height; ++y)
    rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

struct Loader {
  std::vector<std::string> rgb_paths, depth_paths;
  double depth_scale = 5000.0;
  int width = 0, height = 0;

  std::vector<Frame> slots;   // ring buffer
  int capacity = 0;
  std::atomic<int> next_to_schedule{0};
  int next_to_consume = 0;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      int idx = next_to_schedule.fetch_add(1);
      if (idx >= static_cast<int>(rgb_paths.size())) return;
      // bound the lookahead to the ring capacity
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_ready.wait(lk, [&] {
          return stop.load() || idx < next_to_consume + capacity;
        });
        if (stop.load()) return;
      }
      Frame f;
      decode(idx, &f);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[idx % capacity] = std::move(f);
        slots[idx % capacity].ready = true;
      }
      cv_ready.notify_all();
    }
  }

  void decode(int idx, Frame* f) {
    PngImage rgb, depth;
    if (!read_png(rgb_paths[idx].c_str(), &rgb) ||
        !read_png(depth_paths[idx].c_str(), &depth)) {
      f->failed = true;
      return;
    }
    // the caller allocated width*height output buffers: any other decoded
    // geometry must FAIL the frame, never overflow the copy in vio_next
    if (rgb.width != width || rgb.height != height ||
        depth.width != width || depth.height != height) {
      f->failed = true;
      return;
    }
    f->width = rgb.width;
    f->height = rgb.height;
    f->gray.resize(rgb.width * rgb.height);
    const int pix = rgb.width * rgb.height;
    if (rgb.bit_depth == 16) {
      // 16-bit samples (after png_set_swap): take the high byte
      const uint16_t* p16 = reinterpret_cast<const uint16_t*>(rgb.data.data());
      if (rgb.channels >= 3) {
        for (int i = 0; i < pix; ++i) {
          const int r = p16[i * rgb.channels + 0] >> 8;
          const int g = p16[i * rgb.channels + 1] >> 8;
          const int b = p16[i * rgb.channels + 2] >> 8;
          f->gray[i] = static_cast<uint8_t>(
              (19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
        }
      } else {
        for (int i = 0; i < pix; ++i)
          f->gray[i] = static_cast<uint8_t>(p16[i * rgb.channels] >> 8);
      }
    } else if (rgb.channels >= 3) {
      // BT.601 luma with cv::cvtColor's fixed-point rounding
      const uint8_t* p = rgb.data.data();
      for (int i = 0; i < pix; ++i) {
        const int r = p[i * rgb.channels + 0];
        const int g = p[i * rgb.channels + 1];
        const int b = p[i * rgb.channels + 2];
        f->gray[i] =
            static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      }
    } else if (rgb.channels == 2) {
      // gray + alpha: take the luma plane
      const uint8_t* p = rgb.data.data();
      for (int i = 0; i < pix; ++i) f->gray[i] = p[i * 2];
    } else {
      std::memcpy(f->gray.data(), rgb.data.data(), f->gray.size());
    }
    f->depth.resize(depth.width * depth.height);
    const float inv = 1.0f / static_cast<float>(depth_scale);
    if (depth.bit_depth == 16) {
      const uint16_t* d = reinterpret_cast<const uint16_t*>(depth.data.data());
      for (int i = 0; i < depth.width * depth.height; ++i)
        f->depth[i] = d[i] * inv;
    } else {
      for (int i = 0; i < depth.width * depth.height; ++i)
        f->depth[i] = depth.data[i] * inv;
    }
  }
};

}  // namespace

extern "C" {

void* vio_open(const char** rgb_paths, const char** depth_paths, int n,
               double depth_scale, int prefetch, int n_threads, int width,
               int height) {
  auto* L = new Loader();
  L->rgb_paths.assign(rgb_paths, rgb_paths + n);
  L->depth_paths.assign(depth_paths, depth_paths + n);
  L->depth_scale = depth_scale;
  L->width = width > 0 ? width : 640;
  L->height = height > 0 ? height : 480;
  L->capacity = prefetch > 0 ? prefetch : 8;
  L->slots.resize(L->capacity);
  int workers = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < workers; ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocks until frame `next` is decoded; copies into the out buffers.
// Returns the frame index, or -1 when the stream is exhausted / failed.
int vio_next(void* handle, uint8_t* gray_out, float* depth_out, int* w,
             int* h) {
  auto* L = static_cast<Loader*>(handle);
  const int idx = L->next_to_consume;
  if (idx >= static_cast<int>(L->rgb_paths.size())) return -1;
  Frame* f;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    f = &L->slots[idx % L->capacity];
    L->cv_ready.wait(lk, [&] { return f->ready || L->stop.load(); });
    if (L->stop.load() || f->failed) return -1;
    std::memcpy(gray_out, f->gray.data(), f->gray.size());
    std::memcpy(depth_out, f->depth.data(), f->depth.size() * sizeof(float));
    *w = f->width;
    *h = f->height;
    f->ready = false;
    L->next_to_consume = idx + 1;
  }
  L->cv_ready.notify_all();
  return idx;
}

void vio_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
