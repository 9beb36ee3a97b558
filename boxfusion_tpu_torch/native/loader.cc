// Native data-loader core: PNG / JPEG decode + bilinear resize.
//
// Capability target: the reference's data loader leans on cv2 (C++ OpenCV)
// for imread/resize in the per-frame hot path (reference
// capture_stream.py:194-206,402-418).  This is the equivalent native core
// for the TPU build: libpng/libjpeg decode (8-bit RGB and 16-bit gray
// depth) and bilinear resize, exposed through a plain C ABI for ctypes.
// All entry points are GIL-free, so the Python-side prefetcher gets real
// thread parallelism.
//
// Build: g++ -O3 -shared -fPIC loader.cc -o libbfloader.so -lpng -ljpeg -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <png.h>

// ---------------------------------------------------------------------------
// bilinear resize (half-pixel centers, clamped edges) -- C++ template kept
// outside the extern "C" block.
// ---------------------------------------------------------------------------

namespace {

template <typename T, int C>
void resize_bilinear(const T* src, int sh, int sw, T* dst, int dh, int dw) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 > sh - 1 ? sh - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = x0 + 1 > sw - 1 ? sw - 1 : x0 + 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < C; ++c) {
        float a = src[(size_t(y0) * sw + x0) * C + c];
        float b = src[(size_t(y0) * sw + x1) * C + c];
        float d = src[(size_t(y1) * sw + x0) * C + c];
        float e = src[(size_t(y1) * sw + x1) * C + c];
        float top = a + (b - a) * wx;
        float bot = d + (e - d) * wx;
        dst[(size_t(y) * dw + x) * C + c] = static_cast<T>(top + (bot - top) * wy);
      }
    }
  }
}

}  // namespace

extern "C" {

void bf_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// PNG decode (memory buffer -> tightly packed pixels)
// ---------------------------------------------------------------------------

struct MemReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  MemReader* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->size) {
    png_error(png, "read past end");
  }
  memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

// Decodes a PNG from memory.
//   out: malloc'd pixel buffer (caller frees with bf_free).
//   w/h/channels/bitdepth: filled in.  16-bit output is native-endian u16.
// Returns 0 on success.
int bf_decode_png(const uint8_t* buf, size_t len, uint8_t** out, int* w,
                  int* h, int* channels, int* bitdepth) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return -1;  // truncated input: no OOB read
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  // volatile: both are written after setjmp and read in the longjmp cleanup
  // path; without it their values there are indeterminate (C11 7.13.2.1).
  uint8_t* volatile pixels = nullptr;
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(pixels);
    free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }

  MemReader reader{buf, len, 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  // transparency is irrelevant to RGB/depth decoding and must never widen
  // the channel count: expanding tRNS to alpha while testing the ORIGINAL
  // color type for stripping would return 4 channels that the 3-channel
  // resize path then misreads -- so drop tRNS and strip real alpha planes.
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (depth == 16) png_set_swap(png);  // little-endian u16 out

  png_read_update_info(png, info);
  int ch = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);

  pixels = static_cast<uint8_t*>(malloc(rowbytes * height));
  rows = static_cast<png_bytep*>(malloc(sizeof(png_bytep) * height));
  if (!pixels || !rows) {
    free(pixels);
    free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }
  for (png_uint_32 y = 0; y < height; ++y) rows[y] = pixels + y * rowbytes;
  png_read_image(png, rows);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);

  *out = pixels;
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  *channels = ch;
  *bitdepth = depth;
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG decode (memory buffer -> RGB8)
// ---------------------------------------------------------------------------

// libjpeg's default error_exit calls exit(); route fatal errors through
// setjmp like the PNG path so a corrupt file returns an error code (and the
// Python side falls back to PIL) instead of killing the process.
struct bf_jpeg_err {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

static void bf_jpeg_error_exit(j_common_ptr cinfo) {
  bf_jpeg_err* err = reinterpret_cast<bf_jpeg_err*>(cinfo->err);
  longjmp(err->jmp, 1);
}

int bf_decode_jpeg(const uint8_t* buf, size_t len, uint8_t** out, int* w,
                   int* h) {
  jpeg_decompress_struct cinfo;
  bf_jpeg_err jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = bf_jpeg_error_exit;
  // volatile: written after setjmp, read by the longjmp cleanup (free) path.
  uint8_t* volatile pixels = nullptr;
  if (setjmp(jerr.jmp)) {
    free(pixels);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int width = cinfo.output_width;
  const int height = cinfo.output_height;
  pixels = static_cast<uint8_t*>(malloc(size_t(width) * height * 3));
  if (!pixels) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels + size_t(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = pixels;
  *w = width;
  *h = height;
  return 0;
}

int bf_resize_rgb_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  resize_bilinear<uint8_t, 3>(src, sh, sw, dst, dh, dw);
  return 0;
}

int bf_resize_f32(const float* src, int sh, int sw, float* dst, int dh,
                  int dw) {
  resize_bilinear<float, 1>(src, sh, sw, dst, dh, dw);
  return 0;
}

}  // extern "C"
