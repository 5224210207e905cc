// Native threaded JPEG batch loader of the mrla_tpu_torch input pipeline.
//
// Multi-threaded file read + libjpeg decode + crop / bilinear resize to a
// static [size, size, 3] uint8 tensor, called from Python through ctypes
// (mrla_tpu_torch/data/native/__init__.py).  Train mode draws torchvision's
// RandomResizedCrop geometry (scale 0.08-1.0, ratio 3/4-4/3) from a
// std::mt19937_64 seeded by (seed, index); eval mode resamples the centre
// box that resize-shorter-side(size / 0.875) + centre crop covers.  A file
// that cannot be read or decoded leaves its slot zero-filled.
//
// Build: g++ -O3 -shared -fPIC -o libmrla_loader.so loader.cc -ljpeg -lpthread

#include <csetjmp>
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;  // HWC, RGB
  int h = 0, w = 0;
};

// libjpeg's default error_exit calls exit(): one corrupt/truncated JPEG
// would abort the whole training process.  Install a handler that longjmps
// back into decode_jpeg so it can return false (caller zero-fills the slot,
// honoring the API contract below).
struct JmpErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf setjmp_buffer;
};

void jmp_error_exit(j_common_ptr cinfo) {
  auto* mgr = reinterpret_cast<JmpErrorMgr*>(cinfo->err);
  std::longjmp(mgr->setjmp_buffer, 1);
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JmpErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jmp_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    // Any fatal libjpeg error (bad header mid-stream, truncated data,
    // corrupt entropy coding) lands here instead of exit().
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear-resample the crop box [top, left, ch, cw] of src to dst
// [size, size, 3] (PIL box-resize semantics: sample at box-relative
// fractional coordinates).
void resize_crop(const Image& src, int top, int left, int ch, int cw, int size,
                 uint8_t* dst) {
  const float sy = float(ch) / size;
  const float sx = float(cw) / size;
  for (int y = 0; y < size; ++y) {
    float fy = top + (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, std::min(src.h - 1, int(std::floor(fy))));
    int y1 = std::min(src.h - 1, y0 + 1);
    float wy = std::max(0.0f, std::min(1.0f, fy - y0));
    for (int x = 0; x < size; ++x) {
      float fx = left + (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, std::min(src.w - 1, int(std::floor(fx))));
      int x1 = std::min(src.w - 1, x0 + 1);
      float wx = std::max(0.0f, std::min(1.0f, fx - x0));
      for (int c = 0; c < 3; ++c) {
        float v00 = src.data[(size_t(y0) * src.w + x0) * 3 + c];
        float v01 = src.data[(size_t(y0) * src.w + x1) * 3 + c];
        float v10 = src.data[(size_t(y1) * src.w + x0) * 3 + c];
        float v11 = src.data[(size_t(y1) * src.w + x1) * 3 + c];
        float top_v = v00 * (1 - wx) + v01 * wx;
        float bot_v = v10 * (1 - wx) + v11 * wx;
        dst[(size_t(y) * size + x) * 3 + c] =
            uint8_t(std::lround(top_v * (1 - wy) + bot_v * wy));
      }
    }
  }
}

void random_resized_crop_params(std::mt19937_64* rng, int h, int w, int* top,
                                int* left, int* ch, int* cw) {
  const double area = double(h) * w;
  std::uniform_real_distribution<double> uscale(0.08, 1.0);
  std::uniform_real_distribution<double> uratio(std::log(3.0 / 4.0),
                                                std::log(4.0 / 3.0));
  for (int i = 0; i < 10; ++i) {
    double target = area * uscale(*rng);
    double aspect = std::exp(uratio(*rng));
    int cw_ = int(std::lround(std::sqrt(target * aspect)));
    int ch_ = int(std::lround(std::sqrt(target / aspect)));
    if (cw_ > 0 && cw_ <= w && ch_ > 0 && ch_ <= h) {
      std::uniform_int_distribution<int> utop(0, h - ch_);
      std::uniform_int_distribution<int> uleft(0, w - cw_);
      *top = utop(*rng);
      *left = uleft(*rng);
      *ch = ch_;
      *cw = cw_;
      return;
    }
  }
  double in_ratio = double(w) / h;
  int ch_, cw_;
  if (in_ratio < 3.0 / 4.0) {
    cw_ = w;
    ch_ = int(std::lround(w / (3.0 / 4.0)));
  } else if (in_ratio > 4.0 / 3.0) {
    ch_ = h;
    cw_ = int(std::lround(h * (4.0 / 3.0)));
  } else {
    cw_ = w;
    ch_ = h;
  }
  *top = (h - ch_) / 2;
  *left = (w - cw_) / 2;
  *ch = ch_;
  *cw = cw_;
}

void eval_params(int h, int w, int size, int* top, int* left, int* ch,
                 int* cw) {
  // shorter side -> size/0.875, then center crop of `size`:
  // equivalent crop box in SOURCE coordinates.
  double scale = double(size) / (int(std::lround(size / 0.875)));
  (void)scale;
  int short_side = std::min(h, w);
  double crop_frac = double(size) / std::lround(size / 0.875);
  int box = int(std::lround(short_side * crop_frac));
  box = std::min({box, h, w});
  *top = (h - box) / 2;
  *left = (w - box) / 2;
  *ch = box;
  *cw = box;
}

}  // namespace

extern "C" {

// Decode n JPEGs into out [n, size, size, 3] uint8.  Returns the number of
// successful decodes; failed slots are zero-filled.  train != 0 applies
// RandomResizedCrop seeded by (seed, index); eval applies center crop.
int mrla_decode_batch(const char** paths, int n, int size, int train,
                      uint64_t seed, uint8_t* out, int num_threads) {
  std::atomic<int> ok{0};
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + size_t(i) * size * size * 3;
      Image img;
      if (!decode_jpeg(paths[i], &img) || img.h <= 0 || img.w <= 0) {
        memset(dst, 0, size_t(size) * size * 3);
        continue;
      }
      int top, left, ch, cw;
      if (train) {
        std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + i);
        random_resized_crop_params(&rng, img.h, img.w, &top, &left, &ch, &cw);
      } else {
        eval_params(img.h, img.w, size, &top, &left, &ch, &cw);
      }
      resize_crop(img, top, left, ch, cw, size, dst);
      ok.fetch_add(1);
    }
  };
  int t = std::max(1, num_threads);
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return ok.load();
}

}  // extern "C"
