// yogo_host: native host-side input pipeline.
//
// The torch reference delegates image decode to torchvision's C readers and
// label parsing to Python csv (reference: yogo/data/utils.py:16-21,
// yogo/data/yogo_dataset.py:72-110). This library is the native
// equivalent: libpng/libjpeg grayscale decode, PIL-compatible antialiased
// triangle-filter resize, a thread-pooled batch decoder that fills a
// preallocated batch buffer (zero Python-side copies), and a YOLO label-txt
// parser. Exposed via a C ABI consumed with ctypes
// (yogo_tpu_torch/native.py).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC yogo_host.cpp -o libyogo_host.so
//        -lpng -ljpeg -lz -pthread

#include <algorithm>
#include <atomic>
#include <cctype>
#include <locale.h>  // newlocale/strtod_l: locale-independent number parsing
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- decoding

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

// reject absurd declared dimensions before allocating (a crafted header
// could otherwise drive a multi-GB resize -> bad_alloc)
constexpr size_t kMaxPixels = size_t(1) << 27;  // 134M px (772x1032 is 0.8M)

bool decode_png(FILE* f, int want_channels, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  // constructed BEFORE setjmp so the longjmp never skips its constructor
  // and its destructor runs on every return path (no leak, no UB)
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_packing(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY &&
      png_get_bit_depth(png, info) < 8)
    png_set_expand_gray_1_2_4_to_8(png);

  if (want_channels == 1) {
    if (color & PNG_COLOR_MASK_COLOR)
      // ITU-R 601-2 luma, matching PIL convert("L")
      png_set_rgb_to_gray(png, 1 /*error_action silent*/, 0.299, 0.587);
  } else {
    if (!(color & PNG_COLOR_MASK_COLOR)) png_set_gray_to_rgb(png);
  }
  png_read_update_info(png, info);

  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  out->c = png_get_channels(png, info);
  if (out->h <= 0 || out->w <= 0 ||
      size_t(out->h) * out->w > kMaxPixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  // the resizes can throw bad_alloc, which would skip the libpng destroy
  // (leaking read/info structs on every near-OOM decode) - own try block
  try {
    out->data.resize(size_t(out->h) * out->w * out->c);
    rows.resize(out->h);
  } catch (...) {
    png_destroy_read_struct(&png, &info, nullptr);
    throw;  // yogo_decode_image's catch-all maps it to -1
  }
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * out->c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return out->c == want_channels;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, int want_channels, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = want_channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = cinfo.output_components;
  if (out->h <= 0 || out->w <= 0 ||
      size_t(out->h) * out->w > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  try {
    out->data.resize(size_t(out->h) * out->w * out->c);
  } catch (...) {  // bad_alloc must not skip the jpeg pool destroy
    jpeg_destroy_decompress(&cinfo);
    throw;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        out->data.data() + size_t(cinfo.output_scanline) * out->w * out->c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out->c == want_channels;
}

bool decode_file(const char* path, int want_channels, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0x89 && magic[1] == 'P')
    ok = decode_png(f, want_channels, out);
  else if (magic[0] == 0xFF && magic[1] == 0xD8)
    ok = decode_jpeg(f, want_channels, out);
  fclose(f);
  return ok;
}

// --------------------------------------------------------- triangle resize
// Separable triangle (bilinear-with-antialias) filter, matching PIL /
// torchvision Resize(antialias=True) semantics: filter support scales with
// the downscale ratio.

struct FilterBank {
  int ksize = 0;
  std::vector<int> bounds;    // 2 per output pixel: xmin, xcount
  std::vector<double> coeffs; // ksize per output pixel
};

FilterBank build_filter(int in_size, int out_size) {
  FilterBank fb;
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = filterscale;  // triangle filter support = 1.0 * scale
  fb.ksize = int(std::ceil(support)) * 2 + 1;
  fb.bounds.resize(size_t(out_size) * 2);
  fb.coeffs.resize(size_t(out_size) * fb.ksize);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5)) - xmin;
    double* k = &fb.coeffs[size_t(xx) * fb.ksize];
    for (int x = 0; x < xmax; ++x) {
      double arg = (x + xmin - center + 0.5) * ss;
      double wgt = (arg < 0 ? 1.0 + arg : 1.0 - arg);
      if (wgt < 0) wgt = 0;
      k[x] = wgt;
      ww += wgt;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    for (int x = xmax; x < fb.ksize; ++x) k[x] = 0;
    fb.bounds[xx * 2] = xmin;
    fb.bounds[xx * 2 + 1] = xmax;
  }
  return fb;
}

void resize_gray(const uint8_t* in, int in_h, int in_w, uint8_t* out,
                 int out_h, int out_w) {
  if (in_h == out_h && in_w == out_w) {
    std::memcpy(out, in, size_t(in_h) * in_w);
    return;
  }
  FilterBank fh = build_filter(in_w, out_w);
  std::vector<double> tmp(size_t(in_h) * out_w);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = in + size_t(y) * in_w;
    for (int x = 0; x < out_w; ++x) {
      int xmin = fh.bounds[x * 2], xcount = fh.bounds[x * 2 + 1];
      const double* k = &fh.coeffs[size_t(x) * fh.ksize];
      double acc = 0;
      for (int i = 0; i < xcount; ++i) acc += row[xmin + i] * k[i];
      tmp[size_t(y) * out_w + x] = acc;
    }
  }
  FilterBank fv = build_filter(in_h, out_h);
  for (int y = 0; y < out_h; ++y) {
    int ymin = fv.bounds[y * 2], ycount = fv.bounds[y * 2 + 1];
    const double* k = &fv.coeffs[size_t(y) * fv.ksize];
    for (int x = 0; x < out_w; ++x) {
      double acc = 0;
      for (int i = 0; i < ycount; ++i)
        acc += tmp[size_t(ymin + i) * out_w + x] * k[i];
      int v = int(acc + 0.5);
      out[size_t(y) * out_w + x] = uint8_t(std::clamp(v, 0, 255));
    }
  }
}

}  // namespace

extern "C" {

// Decode one image file to `channels`-channel uint8 CHW, resized to
// (out_h, out_w). Returns 0 on success, negative on error. No exception may
// cross the C ABI (ctypes would hit UB), hence the catch-all.
int yogo_decode_image(const char* path, uint8_t* out, int out_h, int out_w,
                      int channels) try {
  // zero/negative target dims would make build_filter divide by zero and
  // cast inf to int (UB); fail cleanly instead
  if (out_h <= 0 || out_w <= 0 || channels <= 0) return -1;
  Image img;
  if (!decode_file(path, channels, &img)) return -1;
  if (channels == 1) {
    resize_gray(img.data.data(), img.h, img.w, out, out_h, out_w);
  } else {
    // planar resize per channel (HWC -> CHW)
    std::vector<uint8_t> plane(size_t(img.h) * img.w);
    for (int ch = 0; ch < channels; ++ch) {
      for (size_t px = 0; px < size_t(img.h) * img.w; ++px)
        plane[px] = img.data[px * channels + ch];
      resize_gray(plane.data(), img.h, img.w,
                  out + size_t(ch) * out_h * out_w, out_h, out_w);
    }
  }
  return 0;
} catch (...) {
  return -1;
}

// Natural (h, w) of an image from the HEADER only (no pixel decode).
// Returns 0/-1.
int yogo_image_size(const char* path, int* h, int* w) try {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return -1;
  }
  rewind(f);
  int rc = -1;
  if (magic[0] == 0x89 && magic[1] == 'P') {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    // setjmp must be the ENTIRE controlling expression (C 7.13.1.1): using
    // it as an operand of && is formally undefined behavior
    if (png && info) {
      if (!setjmp(png_jmpbuf(png))) {
        png_init_io(png, f);
        png_read_info(png, info);
        *h = int(png_get_image_height(png, info));
        *w = int(png_get_image_width(png, info));
        rc = 0;
      }
    }
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
  } else if (magic[0] == 0xFF && magic[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (!setjmp(jerr.jb)) {
      jpeg_create_decompress(&cinfo);
      jpeg_stdio_src(&cinfo, f);
      jpeg_read_header(&cinfo, TRUE);
      *h = int(cinfo.image_height);
      *w = int(cinfo.image_width);
      rc = 0;
    }
    jpeg_destroy_decompress(&cinfo);
  }
  fclose(f);
  return rc;
} catch (...) {
  return -1;
}

// Thread-pooled batch decode into a preallocated (n, channels, out_h, out_w)
// uint8 buffer. ok[i] = 1 on success per image. Returns count of successes.
int yogo_decode_batch(const char** paths, int n, uint8_t* out, int out_h,
                      int out_w, int channels, int n_threads,
                      uint8_t* ok) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> good{0};
  size_t stride = size_t(channels) * out_h * out_w;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = yogo_decode_image(paths[i], out + size_t(i) * stride, out_h,
                                 out_w, channels);
      ok[i] = rc == 0 ? 1 : 0;
      if (rc == 0) good.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = std::min(n_threads, n);
  // thread creation can throw (EAGAIN under resource exhaustion) and this
  // is a C-ABI entry point: no exception may escape, and already-started
  // threads must be joined first (a vector of joinable threads being
  // destroyed is guaranteed std::terminate)
  try {
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  } catch (...) {
    for (auto& t : threads) t.join();
    // the started workers drained some (maybe all) of the queue; report
    // what actually succeeded
    return threads.empty() ? -1 : good.load();
  }
  for (auto& t : threads) t.join();
  return good.load();
}

// Parse a YOLO label txt: rows "cls xc yc w h" (space or comma separated,
// optional single header line). Writes up to max_rows rows of 5 doubles
// (keeping full strtod precision, bit-identical to python float()) but keeps
// COUNTING past capacity, so the return value is the TOTAL row count - the
// caller re-allocates and retries when it exceeds max_rows (silent
// truncation would drop training labels). Returns -1 on IO error and -2 on
// anything malformed (wrong field count, non-numeric coordinates past the
// first line, over-long lines): the caller then falls back to the python
// parser, which raises the reference's error messages. Class tokens that
// aren't numeric get value -1 in column 0 for the caller to resolve.
int yogo_parse_labels(const char* path, double* out, int max_rows) {
  // strtod/strtol honor LC_NUMERIC: an embedding app that setlocale()s to
  // e.g. de_DE would make "0.5" stop parsing at the dot and silently kill
  // the fast path for every file. Parse in a cached C locale instead.
  static locale_t c_locale = newlocale(LC_ALL_MASK, "C", nullptr);
  if (!c_locale) return -2;  // strtod_l with a null locale_t is UB; defer
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[512];
  int rows = 0;
  bool first_content_line = true;
  while (fgets(line, sizeof(line), f)) {
    // a line that filled the buffer without a newline was split by fgets:
    // bail to the (unbounded) python parser rather than mis-parse
    size_t len = strlen(line);
    if (len == sizeof(line) - 1 && line[len - 1] != '\n' && !feof(f)) {
      fclose(f);
      return -2;
    }
    // normalize separators
    for (char* p = line; *p; ++p)
      if (*p == ',' || *p == '\t') *p = ' ';
    char* s = line;
    while (*s && std::isspace(uint8_t(*s))) ++s;
    if (!*s) {
      // a pure newline (LF or CRLF) is skipped by python's csv.reader too,
      // but a whitespace- or separator-only line ("  ", ",,,,") makes the
      // python path's csv.Sniffer fail (-> the reference returns no
      // labels): defer so both paths agree
      bool newline_only = true;
      for (size_t i = 0; i < len; ++i)
        if (line[i] != '\n' && line[i] != '\r') newline_only = false;
      if (!newline_only) {
        fclose(f);
        return -2;
      }
      continue;
    }

    double vals[5];
    int got = 0;
    // strtok keeps process-wide static state and the threaded DataLoader
    // parses labels concurrently (ctypes releases the GIL): strtok_r only
    char* saveptr = nullptr;
    char* tok = strtok_r(s, " \n\r", &saveptr);
    while (tok && got < 5) {
      char* end = nullptr;
      double v;
      if (got == 0) {
        // the class column must be INTEGER-FORMED ("2", not "2.0"): the
        // python path does int(token) and raises otherwise, so numeric
        // non-integer forms defer to it (-2); non-numeric tokens are class
        // names the caller resolves (-1 sentinel)
        long cls = strtol_l(tok, &end, 10, c_locale);
        if (end != tok && *end == '\0') {
          v = double(cls);
        } else {
          double dv = strtod_l(tok, &end, c_locale);
          if (end != tok && *end == '\0') {
            (void)dv;
            got = -2;  // numeric but not an integer class
            break;
          }
          v = -1.0;  // class name token
        }
      } else {
        v = strtod_l(tok, &end, c_locale);
        if (end == tok || *end != '\0') {
          got = -1;  // non-numeric coordinate
          break;
        }
        // strtod accepts C99 hex floats ("0x1p-1") that python's float()
        // rejects: a token that PARSED but contains x/X must defer so
        // both paths raise identically (plain header words like "xc"
        // fail strtod above and take the normal header path)
        for (const char* q = tok; *q; ++q) {
          if (*q == 'x' || *q == 'X') {
            fclose(f);
            return -2;
          }
        }
      }
      vals[got++] = v;
      tok = strtok_r(nullptr, " \n\r", &saveptr);
    }
    if (got == -2) {  // fractional class: python path raises
      fclose(f);
      return -2;
    }
    if (got == -1) {
      // only the first content line may be non-row text (a header with
      // non-numeric column names); malformed coordinates further down
      // must error via the python path
      if (first_content_line) {
        first_content_line = false;
        continue;
      }
      fclose(f);
      return -2;
    }
    if (got != 5 || tok != nullptr) {
      // wrong field count - even on the first line (a short but all-
      // numeric first row is a truncated data row the python parser
      // rejects, NOT a header; real headers hit the got==-1 case above)
      fclose(f);
      return -2;
    }
    first_content_line = false;
    if (rows < max_rows)
      std::memcpy(out + size_t(rows) * 5, vals, sizeof(vals));
    ++rows;
  }
  fclose(f);
  return rows;
}

}  // extern "C"
