// ccst_io — native image IO for the host pipeline (the package's own copy of
// ccst_tpu/native/ccst_io.cpp, same functions, same bytes out).
//
// The reference feeds its GPUs from torch DataLoader worker *processes*
// doing PIL decode (reference data/ImageLoader.py:57-67). The offline stages
// are throughput-bound on the host side, so this library provides
// GIL-free decode/resize/encode for the threaded Python loader
// (ccst_tpu_torch/data/loader.py) via ctypes:
//
//   decode_resize(path, size, out)        one image -> float32 RGB [0,1]
//   decode_resize_batch(...)              thread-pooled batch decode
//   encode_png(path, rgb_u8, h, w)        stylized output write-back
//
// Resampling matches PIL's convolution-based BILINEAR (triangle filter with
// support scaled by the downscale ratio), separable H-then-V, so outputs are
// interchangeable with the Python fallback path.
//
// Build: make -C ccst_tpu_torch/native   (g++ -O3 -shared, links libjpeg + libpng)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>

#include <jpeglib.h>
#include <png.h>

namespace {

struct ImageU8 {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(FILE* f, ImageU8* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

bool decode_png(FILE* f, ImageU8* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);            // palette/gray/low-bit -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, ImageU8* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// PIL-style separable triangle-filter resize (BILINEAR with antialias)
// ---------------------------------------------------------------------------

struct FilterTaps {
  std::vector<int> bounds;     // (out_size, 2): start index, count
  std::vector<double> weights; // (out_size, kmax)
  int kmax = 0;
};

FilterTaps build_taps(int in_size, int out_size) {
  FilterTaps t;
  double scale = double(in_size) / out_size;
  double support = std::max(1.0, scale);   // triangle filter support * scale
  t.kmax = int(std::ceil(support * 2)) + 1;
  t.bounds.resize(size_t(out_size) * 2);
  t.weights.assign(size_t(out_size) * t.kmax, 0.0);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, int(center - support + 0.5));
    int hi = std::min(in_size, int(center + support + 0.5));
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double x = (j + 0.5 - center) / std::max(1.0, scale);
      double wgt = 1.0 - std::fabs(x);
      if (wgt < 0) wgt = 0;
      t.weights[size_t(i) * t.kmax + (j - lo)] = wgt;
      total += wgt;
    }
    if (total > 0)
      for (int j = 0; j < hi - lo; ++j) t.weights[size_t(i) * t.kmax + j] /= total;
    t.bounds[size_t(i) * 2] = lo;
    t.bounds[size_t(i) * 2 + 1] = hi - lo;
  }
  return t;
}

// resize HWC uint8 -> float32 [0,1] (size x size x 3)
void resize_to_float(const ImageU8& img, int size, float* out) {
  FilterTaps th = build_taps(img.w, size);
  FilterTaps tv = build_taps(img.h, size);
  // horizontal pass: (h, size, 3) floats
  std::vector<float> tmp(size_t(img.h) * size * 3);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* row = img.data.data() + size_t(y) * img.w * 3;
    for (int x = 0; x < size; ++x) {
      int lo = th.bounds[size_t(x) * 2], cnt = th.bounds[size_t(x) * 2 + 1];
      const double* wv = &th.weights[size_t(x) * th.kmax];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const uint8_t* px = row + size_t(lo + k) * 3;
        acc[0] += wv[k] * px[0];
        acc[1] += wv[k] * px[1];
        acc[2] += wv[k] * px[2];
      }
      float* dst = tmp.data() + (size_t(y) * size + x) * 3;
      dst[0] = float(acc[0]);
      dst[1] = float(acc[1]);
      dst[2] = float(acc[2]);
    }
  }
  // vertical pass -> out
  for (int y = 0; y < size; ++y) {
    int lo = tv.bounds[size_t(y) * 2], cnt = tv.bounds[size_t(y) * 2 + 1];
    const double* wv = &tv.weights[size_t(y) * tv.kmax];
    for (int x = 0; x < size; ++x) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const float* px = tmp.data() + (size_t(lo + k) * size + x) * 3;
        acc[0] += wv[k] * px[0];
        acc[1] += wv[k] * px[1];
        acc[2] += wv[k] * px[2];
      }
      float* dst = out + (size_t(y) * size + x) * 3;
      // PIL rounds to uint8 after resize; match that then scale to [0,1]
      for (int ch = 0; ch < 3; ++ch) {
        double v = acc[ch];
        v = v < 0 ? 0 : (v > 255 ? 255 : v);
        dst[ch] = float(int(v + 0.5)) / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode one image and resize to (size, size, 3) float32 in [0, 1].
// Returns 0 on success.
int ccst_decode_resize(const char* path, int size, float* out) {
  ImageU8 img;
  if (!decode_file(path, &img)) return 1;
  resize_to_float(img, size, out);
  return 0;
}

// Batch decode with an internal thread pool. paths: array of C strings.
// out: (n, size, size, 3) float32. status: per-image 0/1. Returns #failures.
int ccst_decode_resize_batch(const char** paths, int n, int size, float* out,
                             int n_threads, int* status) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  size_t stride = size_t(size) * size * 3;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = ccst_decode_resize(paths[i], size, out + stride * i);
      if (status) status[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Write HWC uint8 RGB as JPEG (quality 0-100). Returns 0 on success.
int ccst_encode_jpeg(const char* path, const uint8_t* rgb, int h, int w,
                     int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(rgb + size_t(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}

// Write HWC uint8 RGB as PNG. Returns 0 on success.
int ccst_encode_png(const char* path, const uint8_t* rgb, int h, int w) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_write_struct(&png, &info);
    fclose(f);
    return 1;
  }
  png_init_io(png, f);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_set_compression_level(png, 1);  // fast: write-back is host-bound
  png_write_info(png, info);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(rgb + size_t(y) * w * 3);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return 0;
}

}  // extern "C"
