// YUV 4:2:0 / 4:2:2 / 4:4:4 -> RGB colour conversion of a decoded video
// frame, full range (an MJPEG frame) or limited range (an MPEG-4 part 2 or
// H.264 frame, with the stream's colour matrix), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes videos through cv2, whose
// FFMPEG capture converts each decoded frame to BGR24 with swscale on the
// host and then swaps to RGB. For a 4:2:0 or 4:2:2 frame of even height
// swscale takes its unscaled yuv2rgb converter, whose x86 SIMD path is
// 16-bit fixed point with nearest chroma. For a 4:4:4 frame, whose chroma
// is not subsampled, swscale interpolates chroma in full
// (SWS_FULL_CHR_H_INT) and converts through its scaler at scale 1 and
// yuv2rgb_write_full, 30-bit fixed point. The port decodes an MJPEG video's
// frames into Y, U and V planes in device memory with nvJPEG, and an MPEG-4
// or H.264 video's on the host with its own decoders (data/mpeg4.py,
// data/h264.py), copied to the card; this kernel turns them into the (H,
// W, 3) uint8 RGB frame that cv2 gives, bit for bit on the same planes.
// ops/colour.py's plain version repeats the arithmetic and matched cv2 on
// swept (Y, U, V) inputs (tests/test_torch_video_decode.py,
// tests/test_torch_video_h264_chroma.py):
//
//   4:2:0 and 4:2:2, h_shift 1, the chroma sample at (row >> v_shift,
//   col >> 1); full range (yuvj420p, yuvj422p: a JPEG's planes), yt = Y:
//     R = yt + (((8 V - 1024) * 11485) >> 16)      pmulhw: floor
//     G = yt + (((8 U - 1024) * -2819) >> 16) + (((8 V - 1024) * -5850) >> 16)
//     B = yt + (((8 U - 1024) * 14516) >> 16)
//   limited range (yuv420p: a video decoder's planes), the luma offset 16:
//     yt = ((8 Y - 128) * 9539) >> 16, then BT.601's 13075, -3209, -6660,
//     16525, or the row of swscale's ff_yuv2rgb_coeffs that an H.264
//     stream's VUI matrix_coefficients selects (BT.709: 14686, -1747,
//     -4366, 17305; FCC, SMPTE 240M, BT.2020), which the caller passes
//   each clamped to [0, 255] (ff_yuv2rgb_c_init_tables).
//
//   4:4:4, h_shift 0 (and v_shift 0), the chroma sample at (row, col):
//     Y' = (512 Y - oy) * cy + (1 << 21), with (cy, oy) (9539, 8192)
//     limited and (8192, 0) full range; U' = 512 (U - 128), V' likewise
//     R = Y' + V' crv, G = Y' + V' cgv + U' cgu, B = Y' + U' cbu, each sum
//     taken as its 32 bits hold it (swscale adds unsigned; a sum past
//     2^31 wraps negative and clips to 0), then clamp(x >> 22, 0, 255).
//
// Bound on this card: bytes. At 4:2:0 it reads 1.5 B and writes 3 B a
// pixel and does a dozen integer operations on them: 4.15 MB at 1280x720,
// 1.24 us at 3.35 TB/s; at 4:4:4, 3 B and 3 B: 5.53 MB, 1.65 us. Design:
// the simple one. One thread per 2x2 luma block reads the planes in place,
// each pixel's chroma sample through the chroma pitch, and writes two rows
// of 6 bytes.
//
// Samples deeper than 8 bits (9-14, int16 planes of an H.264 High 10, High
// 4:2:2 or High 4:4:4 stream: yuv_rgb_deep) go through swscale's scaler at
// scale 1 in every layout (ops/colour.py, deep_rgb, holds the arithmetic
// to cv2 bit for bit): every sample to 15 bits (S << (15 - depth)); 4:4:4
// then the write_full formula above on S << (17 - depth); 4:2:0 and 4:2:2
// a bicubic chroma filter whose integer taps the host computes once per
// frame size (swscale's initFilter) and passes in filt: across, a quarter
// chroma sample from cv2's left siting to the centre, (sum tap * C) >>
// (depth - 1) clipped to 32767; down, 4:2:0's interpolation to every row
// (4 taps), 4:2:2's one. Rows above the last two take the x86 packed
// output: 4 + sum of (c15 * tap) >> 16 (one tap: c15 >> 4), luma 4 +
// (y15 >> 4), then the 8-bit route's pmulhw arithmetic above; the last two
// rows take swscale's C output: 8-bit values ((y15 + 64) >> 7, chroma
// (2^18 + sum c15 * tap) >> 19) through ff_yuv2rgb_c_init_tables' 24-bit
// lookup tables, computed here rather than looked up:
// clip((i cy + base) >> 16, 0, 255) at the table index i. Nothing carries
// along a row or down the frame, so each thread is independent: one thread
// per pair of columns (their shared chroma) of one row, 4:4:4 one thread
// per pixel. Bound: bytes, 3 B read (two bytes a luma sample, 1 B of
// chroma a pixel at 4:2:0) and 3 B written a pixel at 4:2:0, 5.53 MB at
// 1280x720 (1.65 us); 4:2:2 6.45 MB (1.93 us); 4:4:4 8.29 MB (2.48 us). A
// thread reads its 4 x 4 chroma window of each plane from the caches, not
// from device memory alone.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Coefficients {
  int limited, crv, cgu, cgv, cbu;
};

// yuv2rgb_write_full's channel: the 32-bit sum, wrapped, >> 22, clipped
__device__ __forceinline__ uint8_t full_channel(unsigned sum) {
  return clamp255((int)sum >> 22);
}

__global__ void yuv_rgb_kernel(const uint8_t *__restrict__ y, int y_pitch,
                               const uint8_t *__restrict__ u,
                               const uint8_t *__restrict__ v, int c_pitch,
                               int v_shift, int h_shift, int height,
                               int width, Coefficients k,
                               uint8_t *__restrict__ dst) {
  const int x0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int y0 = 2 * (blockIdx.y * blockDim.y + threadIdx.y);
  if (x0 >= width || y0 >= height) return;
  for (int dy = 0; dy < 2 && y0 + dy < height; ++dy) {
    const int row = y0 + dy;
    const size_t c_row = (size_t)(row >> v_shift) * c_pitch;
    uint8_t *out = dst + ((size_t)row * width + x0) * 3;
    for (int dx = 0; dx < 2 && x0 + dx < width; ++dx) {
      const int col = x0 + dx;
      const size_t c = c_row + (col >> h_shift);
      const int luma = y[(size_t)row * y_pitch + col];
      if (!h_shift) {
        const int yt = (512 * luma - (k.limited ? 8192 : 0)) *
                           (k.limited ? 9539 : 8192) +
                       (1 << 21);
        const int cu = 512 * (u[c] - 128), cv = 512 * (v[c] - 128);
        out[3 * dx + 0] = full_channel((unsigned)yt + (unsigned)(cv * k.crv));
        out[3 * dx + 1] = full_channel((unsigned)yt + (unsigned)(cv * k.cgv) +
                                       (unsigned)(cu * k.cgu));
        out[3 * dx + 2] = full_channel((unsigned)yt + (unsigned)(cu * k.cbu));
        continue;
      }
      const int cu = 8 * u[c] - 1024;
      const int cv = 8 * v[c] - 1024;
      int yt = luma;
      if (k.limited) yt = ((8 * yt - 128) * 9539) >> 16;
      out[3 * dx + 0] = clamp255(yt + ((cv * k.crv) >> 16));
      out[3 * dx + 1] =
          clamp255(yt + ((cu * k.cgu) >> 16) + ((cv * k.cgv) >> 16));
      out[3 * dx + 2] = clamp255(yt + ((cu * k.cbu) >> 16));
    }
  }
}

// the high-depth route's arguments (ops/colour.py: _DEEP_FIELDS, in order)
struct Deep {
  int height, width, c_height, c_width, y_pitch, c_pitch;  // pitches in samples
  int depth, v_shift, h_shift, limited;
  int crv, cgu, cgv, cbu;                                   // 13-bit coefficients
  int lut_crv, lut_cbu, lut_cgu, lut_cgv, lut_cy, lut_oy, lut_yoffs;
  int taps_h, taps_v;
};

__device__ __forceinline__ int pmulhw(int a, int b) { return (a * b) >> 16; }

// the 24-bit table's entry i (ff_yuv2rgb_c_init_tables)
__device__ __forceinline__ uint8_t table(const Deep &k, int i) {
  return clamp255((i * k.lut_cy - (384 << 16) - 512 * k.lut_cy - k.lut_oy +
                   0x8000) >>
                  16);
}

// filt: the horizontal taps (c_width x taps_h), their first samples
// (c_width), the vertical taps (height x taps_v), their first rows (height)
__global__ void yuv_rgb_deep_kernel(const int16_t *__restrict__ y,
                                    const int16_t *__restrict__ u,
                                    const int16_t *__restrict__ v,
                                    const int *__restrict__ filt, Deep k,
                                    uint8_t *__restrict__ dst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= k.height) return;
  uint8_t *out = dst + (size_t)row * k.width * 3;
  const int16_t *yrow = y + (size_t)row * k.y_pitch;
  if (!k.h_shift) {  // 4:4:4: yuv2rgb_write_full, one pixel
    if (i >= k.width) return;
    const int s = 17 - k.depth;
    const size_t c = (size_t)row * k.c_pitch + i;
    const int yt = ((yrow[i] << s) - (k.limited ? 8192 : 0)) *
                       (k.limited ? 9539 : 8192) +
                   (1 << 21);
    const int cu = (u[c] << s) - (128 << 9), cv = (v[c] << s) - (128 << 9);
    out[3 * i + 0] = full_channel((unsigned)yt + (unsigned)(cv * k.crv));
    out[3 * i + 1] = full_channel((unsigned)yt + (unsigned)(cv * k.cgv) +
                                  (unsigned)(cu * k.cgu));
    out[3 * i + 2] = full_channel((unsigned)yt + (unsigned)(cu * k.cbu));
    return;
  }
  if (2 * i >= k.width) return;
  const int *th = filt + (size_t)i * k.taps_h;
  const int ph = filt[(size_t)k.c_width * k.taps_h + i];
  const int *vt = filt + (size_t)k.c_width * (k.taps_h + 1);
  const int *tv = vt + (size_t)row * k.taps_v;
  const int pv = vt[(size_t)k.height * k.taps_v + row];
  // the chroma sample of the pair at chroma row r, filtered across
  auto across = [&](const int16_t *plane, int r) {
    const int16_t *p = plane + (size_t)min(r, k.c_height - 1) * k.c_pitch;
    int acc = 0;
    for (int j = 0; j < k.taps_h; ++j) acc += th[j] * p[min(ph + j, k.c_width - 1)];
    return min(acc >> (k.depth - 1), 32767);
  };
  const bool c_rows = row >= k.height - 2;  // swscale's C output
  int cu, cv;
  if (k.taps_v == 1) {
    const int a = across(u, pv), b = across(v, pv);
    cu = c_rows ? (a + 64) >> 7 : a >> 4;
    cv = c_rows ? (b + 64) >> 7 : b >> 4;
  } else if (c_rows) {
    int su = 1 << 18, sv = 1 << 18;
    for (int j = 0; j < k.taps_v; ++j) {
      su += across(u, pv + j) * tv[j];
      sv += across(v, pv + j) * tv[j];
    }
    cu = su >> 19;
    cv = sv >> 19;
  } else {
    cu = cv = 4;
    for (int j = 0; j < k.taps_v; ++j) {
      cu += pmulhw(across(u, pv + j), tv[j]);
      cv += pmulhw(across(v, pv + j), tv[j]);
    }
  }
  for (int dx = 0; dx < 2 && 2 * i + dx < k.width; ++dx) {
    const int col = 2 * i + dx;
    const int y15 = yrow[col] << (15 - k.depth);
    uint8_t *o = out + 3 * col;
    if (c_rows) {
      const int y8 = (y15 + 64) >> 7;
      const int u8 = min(max(cu, 0), 255), v8 = min(max(cv, 0), 255);
      o[0] = table(k, k.lut_yoffs - (k.lut_crv >> 9) + ((v8 * k.lut_crv) >> 16) + y8);
      o[1] = table(k, k.lut_yoffs - (k.lut_cgu >> 9) + ((u8 * k.lut_cgu) >> 16) -
                          (k.lut_cgv >> 9) + ((v8 * k.lut_cgv) >> 16) + y8);
      o[2] = table(k, k.lut_yoffs - (k.lut_cbu >> 9) + ((u8 * k.lut_cbu) >> 16) + y8);
      continue;
    }
    const int yv = k.taps_v == 1 ? y15 >> 4 : 4 + (y15 >> 4);
    const int yt = pmulhw(yv - (k.limited ? 128 : 0), k.limited ? 9539 : 8192);
    const int uc = cu - 1024, vc = cv - 1024;
    o[0] = clamp255(yt + pmulhw(vc, k.crv));
    o[1] = clamp255(yt + pmulhw(uc, k.cgu) + pmulhw(vc, k.cgv));
    o[2] = clamp255(yt + pmulhw(uc, k.cbu));
  }
}

}  // namespace

// crv, cgu, cgv, cbu: the 13-bit chroma coefficients of the frame's colour
// matrix and range (ops/colour.py: coefficients); v_shift and h_shift the
// chroma's subsampling, h_shift 0 selecting the 4:4:4 route
extern "C" int yuv_rgb(const void *y, int y_pitch, const void *u,
                       const void *v, int c_pitch, int v_shift, int h_shift,
                       int height, int width, int limited, int crv, int cgu,
                       int cgv, int cbu, void *dst, void *stream) {
  const Coefficients k{limited, crv, cgu, cgv, cbu};
  const dim3 block(32, 8);
  const dim3 grid((width + 63) / 64, (height + 15) / 16);
  yuv_rgb_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)y, y_pitch, (const uint8_t *)u, (const uint8_t *)v,
      c_pitch, v_shift, h_shift, height, width, k, (uint8_t *)dst);
  return (int)cudaGetLastError();
}

// planes of 9-14 bits (int16): args, the Deep fields in order (host
// memory); filt, the chroma filter tables in device memory (ignored for
// 4:4:4)
extern "C" int yuv_rgb_deep(const void *y, const void *u, const void *v,
                            const int *args, const void *filt, void *dst,
                            void *stream) {
  Deep k;
  static_assert(sizeof(Deep) == 23 * sizeof(int), "Deep: 23 ints");
  memcpy(&k, args, sizeof(Deep));
  const dim3 block(64, 4);
  const int across = k.h_shift ? (k.width + 1) / 2 : k.width;
  const dim3 grid((across + 63) / 64, (k.height + 3) / 4);
  yuv_rgb_deep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int16_t *)y, (const int16_t *)u, (const int16_t *)v,
      (const int *)filt, k, (uint8_t *)dst);
  return (int)cudaGetLastError();
}
