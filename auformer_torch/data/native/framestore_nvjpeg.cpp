// FrameStore native reader with batched JPEG decode, and a JPEG encoder,
// on nvJPEG (CUDA toolkit): the same C interface and semantics as
// framestore_reader.cpp, for hosts that have the CUDA toolkit but not
// libjpeg.
//
// Decode: the store is mmap'd on the host (framestore.h); the batch's JPEGs
// whose header gives the requested size go to nvjpegDecodeBatched (Huffman
// on the host, the IDCT and colour conversion on the card) into one device
// buffer, which comes back to the caller's host buffer with one copy. Where
// the batched call refuses the batch (a corrupt stream), each image is
// decoded on its own so that only the bad ones stay black (ok=0). A store
// handle owns its nvJPEG state and stream; a mutex serialises its decodes,
// since the loader calls it from several threads.
//
// Encode: baseline JPEG at the given quality, 4:2:0 for colour (as
// cv2.imencode's default) and luminance only for one channel, with one
// nvJPEG encoder per calling thread. fs_decode_jpeg decodes one JPEG held
// in memory with nvjpegDecode, one decoder per calling thread;
// fs_decode_jpeg_yuv decodes one to its Y, Cb and Cr planes in device
// memory (NVJPEG_OUTPUT_YUV) on the caller's stream, for the colour
// conversion kernel (ops/colour.py), and fs_jpeg_info reads its header.
//
// The library uses the CUDA runtime directly (the current device of the
// calling thread, device 0 unless set); it does not go through torch.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <mutex>

#include "framestore.h"

namespace {

struct NvStore {
  fs::Store store;
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;  // decode output, grown on demand
  size_t dev_bytes = 0;
  int batch = -1;  // batch size / format nvjpegDecodeBatched is set up for
  int format = -1;
  std::mutex mu;
};

bool fits(nvjpegHandle_t handle, const uint8_t* data, size_t size, int height,
          int width) {
  int n_comp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(handle, data, size, &n_comp, &css, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return false;
  return widths[0] == width && heights[0] == height;
}

void release(NvStore* s) {
  if (s->dev) cudaFree(s->dev);
  if (s->state) nvjpegJpegStateDestroy(s->state);
  if (s->handle) nvjpegDestroy(s->handle);
  if (s->stream) cudaStreamDestroy(s->stream);
  fs::close_store(&s->store);
  delete s;
}

// each thread's encoder: created at its first encode, released when the
// thread ends, so threads encode concurrently
struct Encoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  int quality = -1;
  int css = -2;
  bool ok = false;
  ~Encoder() {
    if (dev) cudaFree(dev);
    if (params) nvjpegEncoderParamsDestroy(params);
    if (state) nvjpegEncoderStateDestroy(state);
    if (handle) nvjpegDestroy(handle);
    if (stream) cudaStreamDestroy(stream);
  }
};

thread_local Encoder encoder;

// each thread's single-image decoder, as the encoder above
struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  bool ok = false;
  ~Decoder() {
    if (dev) cudaFree(dev);
    if (state) nvjpegJpegStateDestroy(state);
    if (handle) nvjpegDestroy(handle);
    if (stream) cudaStreamDestroy(stream);
  }
};

thread_local Decoder single_decoder;

bool ready(Decoder& d) {
  if (!d.ok) {
    if (cudaStreamCreateWithFlags(&d.stream, cudaStreamNonBlocking) !=
            cudaSuccess ||
        nvjpegCreateSimple(&d.handle) != NVJPEG_STATUS_SUCCESS ||
        nvjpegJpegStateCreate(d.handle, &d.state) != NVJPEG_STATUS_SUCCESS)
      return false;
    d.ok = true;
  }
  return true;
}

int layout_of(nvjpegChromaSubsampling_t css, int n_comp) {
  if (n_comp == 1) return 400;
  switch (css) {
    case NVJPEG_CSS_444: return 444;
    case NVJPEG_CSS_422: return 422;
    case NVJPEG_CSS_420: return 420;
    default: return 0;
  }
}

}  // namespace

extern "C" {

void* fs_open(const char* dir) {
  NvStore* s = new NvStore();
  if (!fs::open_store(dir, &s->store) ||
      cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking) !=
          cudaSuccess ||
      nvjpegCreateSimple(&s->handle) != NVJPEG_STATUS_SUCCESS ||
      nvjpegJpegStateCreate(s->handle, &s->state) != NVJPEG_STATUS_SUCCESS) {
    release(s);
    return nullptr;
  }
  return s;
}

void fs_close(void* h) {
  if (h) release(static_cast<NvStore*>(h));
}

long fs_num_entries(void* h) {
  return static_cast<NvStore*>(h)->store.index.size();
}

int fs_get_raw(void* h, const char* key, const uint8_t** ptr, long* size) {
  size_t n = 0;
  if (!static_cast<NvStore*>(h)->store.find(key, ptr, &n)) return 0;
  *size = static_cast<long>(n);
  return 1;
}

// Returns 1, or 0 when the card failed (a CUDA error: the caller raises).
int fs_decode_batch(void* h, const char** keys, int n, uint8_t* out,
                    int height, int width, int channels, uint8_t* ok,
                    int n_threads) {
  NvStore* s = static_cast<NvStore*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  const size_t frame_bytes = static_cast<size_t>(height) * width * channels;
  std::vector<int> rows;
  std::vector<const unsigned char*> data;
  std::vector<size_t> lengths;
  for (int i = 0; i < n; ++i) {
    ok[i] = 0;
    const uint8_t* p;
    size_t size;
    if (!s->store.find(keys[i], &p, &size)) continue;  // stays black
    if (!fits(s->handle, p, size, height, width)) continue;
    rows.push_back(i);
    data.push_back(p);
    lengths.push_back(size);
  }
  const int m = static_cast<int>(rows.size());
  if (m == 0) return 1;
  if (s->dev_bytes < m * frame_bytes) {
    if (s->dev) cudaFree(s->dev);
    s->dev = nullptr;
    s->dev_bytes = 0;
    if (cudaMalloc(&s->dev, m * frame_bytes) != cudaSuccess) return 0;
    s->dev_bytes = m * frame_bytes;
  }
  const nvjpegOutputFormat_t fmt =
      channels == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI;
  std::vector<nvjpegImage_t> dst(m);
  for (int j = 0; j < m; ++j) {
    memset(&dst[j], 0, sizeof(nvjpegImage_t));
    dst[j].channel[0] = s->dev + j * frame_bytes;
    dst[j].pitch[0] = static_cast<size_t>(width) * channels;
  }
  std::vector<uint8_t> good(m, 0);
  bool batched = false;
  if (s->batch != m || s->format != fmt) {
    s->batch = -1;
    if (nvjpegDecodeBatchedInitialize(s->handle, s->state, m, n_threads,
                                      fmt) == NVJPEG_STATUS_SUCCESS) {
      s->batch = m;
      s->format = fmt;
    }
  }
  if (s->batch == m &&
      nvjpegDecodeBatched(s->handle, s->state, data.data(), lengths.data(),
                          dst.data(), s->stream) == NVJPEG_STATUS_SUCCESS) {
    batched = true;
    for (int j = 0; j < m; ++j) good[j] = 1;
  }
  if (!batched) {
    // find the images the batch could not take: decode each on its own
    s->batch = -1;
    for (int j = 0; j < m; ++j)
      good[j] = nvjpegDecode(s->handle, s->state, data[j], lengths[j], fmt,
                             &dst[j], s->stream) == NVJPEG_STATUS_SUCCESS;
  }
  std::vector<uint8_t> host(m * frame_bytes);
  if (cudaMemcpyAsync(host.data(), s->dev, m * frame_bytes,
                      cudaMemcpyDeviceToHost, s->stream) != cudaSuccess ||
      cudaStreamSynchronize(s->stream) != cudaSuccess)
    return 0;
  for (int j = 0; j < m; ++j) {
    if (!good[j]) continue;
    memcpy(out + rows[j] * frame_bytes, host.data() + j * frame_bytes,
           frame_bytes);
    ok[rows[j]] = 1;
  }
  return 1;
}

long fs_encode_jpeg(const uint8_t* pixels, int height, int width,
                    int channels, int quality, uint8_t* out, long capacity) {
  Encoder& e = encoder;
  if (!e.ok) {
    if (cudaStreamCreateWithFlags(&e.stream, cudaStreamNonBlocking) !=
            cudaSuccess ||
        nvjpegCreateSimple(&e.handle) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderStateCreate(e.handle, &e.state, e.stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsCreate(e.handle, &e.params, e.stream) !=
            NVJPEG_STATUS_SUCCESS)
      return -1;
    e.ok = true;
  }
  const nvjpegChromaSubsampling_t css =
      channels == 1 ? NVJPEG_CSS_GRAY : NVJPEG_CSS_420;
  if (e.quality != quality) {
    if (nvjpegEncoderParamsSetQuality(e.params, quality, e.stream) !=
        NVJPEG_STATUS_SUCCESS)
      return -1;
    e.quality = quality;
  }
  if (e.css != css) {
    if (nvjpegEncoderParamsSetSamplingFactors(e.params, css, e.stream) !=
        NVJPEG_STATUS_SUCCESS)
      return -1;
    e.css = css;
  }
  const size_t bytes = static_cast<size_t>(height) * width * channels;
  if (e.dev_bytes < bytes) {
    if (e.dev) cudaFree(e.dev);
    e.dev = nullptr;
    e.dev_bytes = 0;
    if (cudaMalloc(&e.dev, bytes) != cudaSuccess) return -1;
    e.dev_bytes = bytes;
  }
  if (cudaMemcpyAsync(e.dev, pixels, bytes, cudaMemcpyHostToDevice,
                      e.stream) != cudaSuccess)
    return -1;
  nvjpegImage_t src;
  memset(&src, 0, sizeof(src));
  src.channel[0] = e.dev;
  src.pitch[0] = static_cast<size_t>(width) * channels;
  nvjpegStatus_t st =
      channels == 1
          ? nvjpegEncodeYUV(e.handle, e.state, e.params, &src, css, width,
                            height, e.stream)
          : nvjpegEncodeImage(e.handle, e.state, e.params, &src,
                              NVJPEG_INPUT_RGBI, width, height, e.stream);
  if (st != NVJPEG_STATUS_SUCCESS) return -1;
  size_t length = 0;
  if (nvjpegEncodeRetrieveBitstream(e.handle, e.state, nullptr, &length,
                                    e.stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(e.stream) != cudaSuccess ||
      static_cast<long>(length) > capacity ||
      nvjpegEncodeRetrieveBitstream(e.handle, e.state, out, &length,
                                    e.stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(e.stream) != cudaSuccess)
    return -1;
  return static_cast<long>(length);
}

// Returns 1, or 0 on a decode failure, a size mismatch or a CUDA error.
int fs_decode_jpeg(const uint8_t* data, long size, uint8_t* out, int height,
                   int width, int channels) {
  Decoder& d = single_decoder;
  if (!ready(d)) return 0;
  if (!fits(d.handle, data, static_cast<size_t>(size), height, width))
    return 0;
  const size_t bytes = static_cast<size_t>(height) * width * channels;
  if (d.dev_bytes < bytes) {
    if (d.dev) cudaFree(d.dev);
    d.dev = nullptr;
    d.dev_bytes = 0;
    if (cudaMalloc(&d.dev, bytes) != cudaSuccess) return 0;
    d.dev_bytes = bytes;
  }
  nvjpegImage_t dst;
  memset(&dst, 0, sizeof(dst));
  dst.channel[0] = d.dev;
  dst.pitch[0] = static_cast<size_t>(width) * channels;
  if (nvjpegDecode(d.handle, d.state, data, static_cast<size_t>(size),
                   channels == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &dst,
                   d.stream) != NVJPEG_STATUS_SUCCESS ||
      cudaMemcpyAsync(out, d.dev, bytes, cudaMemcpyDeviceToHost, d.stream) !=
          cudaSuccess ||
      cudaStreamSynchronize(d.stream) != cudaSuccess)
    return 0;
  return 1;
}

// The size and chroma layout of a JPEG (420, 422, 444, 400 grey, or 0 for
// another sampling). 1, or 0 when its header does not read.
int fs_jpeg_info(const uint8_t* data, long size, int* height, int* width,
                 int* layout) {
  Decoder& d = single_decoder;
  int n_comp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (!ready(d) ||
      nvjpegGetImageInfo(d.handle, data, static_cast<size_t>(size), &n_comp,
                         &css, widths, heights) != NVJPEG_STATUS_SUCCESS)
    return 0;
  *height = heights[0];
  *width = widths[0];
  *layout = layout_of(css, n_comp);
  return 1;
}

// Decode a 4:2:0 or 4:2:2 JPEG to its stored planes, on the card: Y (H x W)
// into y, Cb and Cr (ceil(H / 2) or H rows of ceil(W / 2)) into cb and cr,
// each contiguous device memory, on ``stream``; no colour conversion and
// no upsampling. 1, or 0 on a decode failure or another size or layout.
int fs_decode_jpeg_yuv(const uint8_t* data, long size, uint8_t* y,
                       uint8_t* cb, uint8_t* cr, int height, int width,
                       int layout, void* stream) {
  Decoder& d = single_decoder;
  int h = 0, w = 0, got = 0;
  if ((layout != 420 && layout != 422) ||
      !fs_jpeg_info(data, size, &h, &w, &got) || got != layout ||
      h != height || w != width)
    return 0;
  nvjpegImage_t dst;
  memset(&dst, 0, sizeof(dst));
  dst.channel[0] = y;
  dst.channel[1] = cb;
  dst.channel[2] = cr;
  dst.pitch[0] = static_cast<size_t>(width);
  dst.pitch[1] = dst.pitch[2] = static_cast<size_t>((width + 1) / 2);
  return nvjpegDecode(d.handle, d.state, data, static_cast<size_t>(size),
                      NVJPEG_OUTPUT_YUV, &dst,
                      static_cast<cudaStream_t>(stream)) ==
                 NVJPEG_STATUS_SUCCESS
             ? 1
             : 0;
}

}  // extern "C"
