// FrameStore native reader with batched JPEG decode, and a JPEG encoder,
// on libjpeg (host threads).
//
// The reference's per-sample hot loop does 16 LMDB gets + 16 cv2.imdecode
// calls from Python (aff2compdataset.py:126-155). This reader mmaps the
// framestore shards (framestore.h), resolves keys through a hash table and
// decodes whole clips or whole videos of JPEGs into a caller-provided uint8
// buffer on a thread pool: one Python call (ctypes releases the GIL) per
// batch.
//
// C interface (ctypes, native/__init__.py), shared with
// framestore_nvjpeg.cpp:
//   void* fs_open(const char* dir);
//   void  fs_close(void* h);
//   long  fs_num_entries(void* h);
//   int   fs_get_raw(void* h, const char* key, const uint8_t** ptr,
//                    long* size);
//   int   fs_decode_batch(void* h, const char** keys, int n, uint8_t* out,
//                         int height, int width, int channels, uint8_t* ok,
//                         int n_threads);
//   long  fs_encode_jpeg(const uint8_t* pixels, int height, int width,
//                        int channels, int quality, uint8_t* out,
//                        long capacity);
//   int   fs_decode_jpeg(const uint8_t* data, long size, uint8_t* out,
//                        int height, int width, int channels);
//   int   fs_jpeg_info(const uint8_t* data, long size, int* height,
//                      int* width, int* layout);
//   int   fs_decode_jpeg_yuv(const uint8_t* data, long size, uint8_t* y,
//                            uint8_t* cb, uint8_t* cr, int height,
//                            int width, int layout, void* stream);
//
// fs_decode_batch decodes keys[i] into out[i*H*W*C]; ok[i]=1 on success, 0
// on an empty or missing key, a decode failure or a size mismatch (the
// caller leaves that frame black: the reference's fallback for a missing
// frame). fs_encode_jpeg writes a baseline JPEG (4:2:0 for colour, as
// cv2.imencode's default) and returns its size, or -1. fs_decode_jpeg
// decodes one JPEG held in memory into out (H*W*C) and returns 1, or 0 on
// a decode failure or a size mismatch. fs_jpeg_info gives a JPEG's size and
// chroma layout (420, 422, 444, 400 grey, or 0 for another sampling);
// fs_decode_jpeg_yuv decodes a 4:2:0 or 4:2:2 one to its stored Y, Cb and
// Cr planes (libjpeg's raw data: no colour conversion, no upsampling) in
// host memory; ``stream`` is for the nvJPEG source's signature and unused.

#include <atomic>
#include <csetjmp>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "framestore.h"

extern "C" {
#include <jpeglib.h>
}

namespace {

// libjpeg error handling: longjmp instead of exit()
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// decode one JPEG into dst (H*W*C, RGB or grayscale). Returns success.
bool decode_jpeg(const uint8_t* data, size_t size, uint8_t* dst, int height,
                 int width, int channels) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != height ||
      static_cast<int>(cinfo.output_width) != width ||
      static_cast<int>(cinfo.output_components) != channels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const int stride = width * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

int layout_of(const jpeg_decompress_struct& c) {
  if (c.num_components == 1) return 400;
  const jpeg_component_info* k = c.comp_info;
  if (c.num_components != 3 || c.jpeg_color_space != JCS_YCbCr ||
      k[1].h_samp_factor != 1 || k[1].v_samp_factor != 1 ||
      k[2].h_samp_factor != 1 || k[2].v_samp_factor != 1)
    return 0;
  if (k[0].h_samp_factor == 2 && k[0].v_samp_factor == 2) return 420;
  if (k[0].h_samp_factor == 2 && k[0].v_samp_factor == 1) return 422;
  if (k[0].h_samp_factor == 1 && k[0].v_samp_factor == 1) return 444;
  return 0;
}

// decode one 4:2:0 or 4:2:2 JPEG to its stored Y, Cb, Cr planes (raw data
// out), or read only its header when y is null. Returns success.
bool decode_yuv(const uint8_t* data, size_t size, uint8_t* y, uint8_t* cb,
                uint8_t* cr, int* height, int* width, int* layout) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  std::vector<uint8_t> scratch;
  std::vector<JSAMPROW> rows;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  const int h = static_cast<int>(cinfo.image_height);
  const int w = static_cast<int>(cinfo.image_width);
  const int got = layout_of(cinfo);
  if (!y) {
    *height = h;
    *width = w;
    *layout = got;
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  if (h != *height || w != *width || got != *layout ||
      (got != 420 && got != 422)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.raw_data_out = TRUE;
  cinfo.out_color_space = JCS_YCbCr;
  jpeg_start_decompress(&cinfo);
  const int max_v = cinfo.max_v_samp_factor;
  uint8_t* out[3] = {y, cb, cr};
  const int out_w[3] = {w, (w + 1) / 2, (w + 1) / 2};
  const int out_h[3] = {h, got == 420 ? (h + 1) / 2 : h,
                        got == 420 ? (h + 1) / 2 : h};
  int buf_rows[3], buf_w[3];
  size_t total = 0;
  for (int c = 0; c < 3; ++c) {
    buf_rows[c] = cinfo.comp_info[c].v_samp_factor * DCTSIZE;
    buf_w[c] = static_cast<int>(cinfo.comp_info[c].width_in_blocks) * DCTSIZE;
    total += static_cast<size_t>(buf_rows[c]) * buf_w[c];
  }
  scratch.resize(total);
  rows.resize(buf_rows[0] + buf_rows[1] + buf_rows[2]);
  JSAMPARRAY planes[3];
  size_t off = 0;
  int r0 = 0;
  for (int c = 0; c < 3; ++c) {
    planes[c] = rows.data() + r0;
    for (int r = 0; r < buf_rows[c]; ++r, off += buf_w[c])
      rows[r0 + r] = scratch.data() + off;
    r0 += buf_rows[c];
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    const int line = static_cast<int>(cinfo.output_scanline);
    jpeg_read_raw_data(&cinfo, planes, DCTSIZE * max_v);
    for (int c = 0; c < 3; ++c) {
      const int first = line / max_v * cinfo.comp_info[c].v_samp_factor;
      for (int r = 0; r < buf_rows[c] && first + r < out_h[c]; ++r)
        memcpy(out[c] + static_cast<size_t>(first + r) * out_w[c],
               planes[c][r], static_cast<size_t>(out_w[c]));
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// libjpeg's in-memory destination buffer, freed on every path
struct MemDest {
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  ~MemDest() { free(buf); }
};

}  // namespace

extern "C" {

void* fs_open(const char* dir) {
  fs::Store* s = new fs::Store();
  if (!fs::open_store(dir, s)) {
    delete s;
    return nullptr;
  }
  return s;
}

void fs_close(void* h) {
  fs::Store* s = static_cast<fs::Store*>(h);
  if (!s) return;
  fs::close_store(s);
  delete s;
}

long fs_num_entries(void* h) {
  return static_cast<fs::Store*>(h)->index.size();
}

int fs_get_raw(void* h, const char* key, const uint8_t** ptr, long* size) {
  size_t n = 0;
  if (!static_cast<fs::Store*>(h)->find(key, ptr, &n)) return 0;
  *size = static_cast<long>(n);
  return 1;
}

int fs_decode_batch(void* h, const char** keys, int n, uint8_t* out,
                    int height, int width, int channels, uint8_t* ok,
                    int n_threads) {
  const fs::Store* s = static_cast<fs::Store*>(h);
  const size_t frame_bytes = static_cast<size_t>(height) * width * channels;
  std::atomic<int> next(0);
  int workers = n_threads < 1 ? 1 : n_threads;
  if (workers > n) workers = n;

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      ok[i] = 0;
      const uint8_t* data;
      size_t size;
      if (!s->find(keys[i], &data, &size)) continue;  // stays black
      if (decode_jpeg(data, size, out + frame_bytes * i, height, width,
                      channels))
        ok[i] = 1;
    }
  };

  if (workers <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(workers);
    for (int w = 0; w < workers; ++w) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  return 1;
}

long fs_encode_jpeg(const uint8_t* pixels, int height, int width,
                    int channels, int quality, uint8_t* out, long capacity) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  MemDest dest;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &dest.buf, &dest.size);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = channels;
  cinfo.in_color_space = (channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);  // YCbCr 4:2:0 for colour input
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const int stride = width * channels;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(pixels) + cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  if (static_cast<long>(dest.size) > capacity) return -1;
  memcpy(out, dest.buf, dest.size);
  return static_cast<long>(dest.size);
}

int fs_decode_jpeg(const uint8_t* data, long size, uint8_t* out, int height,
                   int width, int channels) {
  return decode_jpeg(data, static_cast<size_t>(size), out, height, width,
                     channels)
             ? 1
             : 0;
}

int fs_jpeg_info(const uint8_t* data, long size, int* height, int* width,
                 int* layout) {
  return decode_yuv(data, static_cast<size_t>(size), nullptr, nullptr,
                    nullptr, height, width, layout)
             ? 1
             : 0;
}

int fs_decode_jpeg_yuv(const uint8_t* data, long size, uint8_t* y,
                       uint8_t* cb, uint8_t* cr, int height, int width,
                       int layout, void* /*stream*/) {
  return decode_yuv(data, static_cast<size_t>(size), y, cb, cr, &height,
                    &width, &layout)
             ? 1
             : 0;
}

}  // extern "C"
