// Native host-side image decoder for the input pipeline: the port's copy of
// driving_dirty_tpu/data/native/loader.cpp, byte for byte in its code.
//
// The reference decodes every camera JPEG through PIL inside DataLoader
// worker processes (its src/utils/data_helper.py:63-68,112,124).
// Here the decode runs through libjpeg(-turbo)/libpng directly into
// caller-provided fixed-shape buffers: no intermediate PIL Image object, no
// convert("RGB") copy, no numpy re-copy — one decode pass writes the final
// NHWC bytes (or f32, with the /255 fused into the scanline loop).
//
// Exposed via ctypes (a plain C interface); built on demand with g++ by
// driving_dirty_tpu_torch/data/_native.py. A batch entry point decodes N files on
// an internal std::thread pool for callers that want native-side
// parallelism (e.g. warming the sample cache); the per-image entry points
// are single-threaded because the Python pipeline already fans items out
// across a thread pool (data/pipeline.py) and nesting pools oversubscribes.
//
// Error contract: every function returns 0 on success or a negative errno-
// style code; decode errors never abort the process (libjpeg's default
// error handler calls exit() — replaced with longjmp).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrDecode = -2;
constexpr int kErrShape = -3;

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Decode one JPEG into out (expect_h*expect_w*3, uint8 RGB HWC, or f32 when
// outf != nullptr). Shape must match exactly: the pipeline is fixed-shape.
int decode_jpeg(const char* path, uint8_t* out8, float* outf,
                int64_t expect_h, int64_t expect_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  std::vector<uint8_t> row;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_height != static_cast<JDIMENSION>(expect_h) ||
      cinfo.output_width != static_cast<JDIMENSION>(expect_w) ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return kErrShape;
  }
  const int64_t stride = expect_w * 3;
  if (out8) {
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW rowp = out8 + int64_t(cinfo.output_scanline) * stride;
      jpeg_read_scanlines(&cinfo, &rowp, 1);
    }
  } else {
    row.resize(stride);
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW rowp = row.data();
      int64_t y = cinfo.output_scanline;
      jpeg_read_scanlines(&cinfo, &rowp, 1);
      float* dst = outf + y * stride;
      // true division, not mult-by-reciprocal: bit-identical to numpy's
      // float32 `arr / 255.0` (the PIL path) is the parity contract
      for (int64_t i = 0; i < stride; i++) dst[i] = row[i] / 255.0f;
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Decode one PNG into RGB uint8/f32 HWC. Palette/gray/16-bit/alpha inputs
// are normalized to 8-bit RGB (ego.png in the dataset is RGB already; the
// transforms make the loader robust to re-encoded variants).
int decode_png(const char* path, uint8_t* out8, float* outf,
               int64_t expect_h, int64_t expect_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return kErrDecode;
  }
  std::vector<uint8_t> row;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  if (h != static_cast<png_uint_32>(expect_h) || w != static_cast<png_uint_32>(expect_w)) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return kErrShape;
  }
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != static_cast<size_t>(expect_w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return kErrShape;
  }
  const int64_t stride = expect_w * 3;
  if (out8) {
    for (int64_t y = 0; y < expect_h; y++) png_read_row(png, out8 + y * stride, nullptr);
  } else {
    row.resize(stride);
    for (int64_t y = 0; y < expect_h; y++) {
      png_read_row(png, row.data(), nullptr);
      float* dst = outf + y * stride;
      for (int64_t i = 0; i < stride; i++) dst[i] = row[i] / 255.0f;
    }
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return 0;
}

int decode_one(const char* path, uint8_t* out8, float* outf,
               int64_t h, int64_t w) {
  size_t n = strlen(path);
  bool is_png = n >= 4 && strcmp(path + n - 4, ".png") == 0;
  return is_png ? decode_png(path, out8, outf, h, w)
                : decode_jpeg(path, out8, outf, h, w);
}

}  // namespace

extern "C" {

// uint8 out: [h, w, 3]
int dd_decode_image_u8(const char* path, uint8_t* out, int64_t h, int64_t w) {
  return decode_one(path, out, nullptr, h, w);
}

// f32 out: [h, w, 3], values in [0,1] (the /255 runs inside the scanline loop)
int dd_decode_image_f32(const char* path, float* out, int64_t h, int64_t w) {
  return decode_one(path, nullptr, out, h, w);
}

// Batch decode n files into out[n, h, w, 3] on an internal thread pool.
// status[i] gets the per-file return code. Returns 0 if every file decoded.
int dd_decode_batch(const char** paths, int64_t n, uint8_t* out8, float* outf,
                    int64_t h, int64_t w, int32_t nthreads, int32_t* status) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = static_cast<int32_t>(n);
  const int64_t stride = h * w * 3;
  std::atomic<int64_t> next{0};
  std::atomic<int> bad{0};
  auto work = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_one(paths[i],
                          out8 ? out8 + i * stride : nullptr,
                          outf ? outf + i * stride : nullptr, h, w);
      status[i] = rc;
      if (rc != 0) bad.store(1);
    }
  };
  if (nthreads == 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    for (int32_t t = 0; t < nthreads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return bad.load() ? kErrDecode : 0;
}

}  // extern "C"
