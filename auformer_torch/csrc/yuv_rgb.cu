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

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
