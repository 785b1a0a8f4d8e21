// YUV 4:2:0 / 4:2:2 -> RGB colour conversion of a decoded video frame, full
// range (an MJPEG frame) or limited range (an MPEG-4 part 2 or H.264 frame,
// with the stream's colour matrix), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes videos through cv2, whose
// FFMPEG capture converts each decoded frame to BGR24 with swscale on the
// host and then swaps to RGB. For a 4:2:0 or 4:2:2 frame of even height
// swscale takes its unscaled yuv2rgb converter, whose x86 SIMD path is
// 16-bit fixed point with nearest chroma. The port decodes an MJPEG video's
// frames into Y, U and V planes in device memory with nvJPEG, and an MPEG-4
// video's on the host with its own decoder (data/mpeg4.py), copied to the
// card; this kernel turns them into the (H, W, 3) uint8 RGB frame that cv2
// gives, bit for bit on the same planes. ops/colour.py's plain version
// repeats the arithmetic and matched cv2 on swept (U, V) pairs under random
// Y values (tests/test_torch_video_decode.py):
//
//   full range (yuvj420p, yuvj422p: a JPEG's planes), yt = Y:
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
// Bound on this card: bytes. At 4:2:0 it reads 1.5 B and writes 3 B a
// pixel and does a dozen integer operations on them: 4.15 MB at 1280x720,
// 1.24 us at 3.35 TB/s. Design: the simple one. One thread per 2x2 luma
// block reads the planes in place, each pixel's chroma sample at (row >>
// v_shift, col >> 1) through the chroma pitch, and writes two rows of 6
// bytes.

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

__global__ void yuv_rgb_kernel(const uint8_t *__restrict__ y, int y_pitch,
                               const uint8_t *__restrict__ u,
                               const uint8_t *__restrict__ v, int c_pitch,
                               int v_shift, int height, int width,
                               Coefficients k, uint8_t *__restrict__ dst) {
  const int x0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int y0 = 2 * (blockIdx.y * blockDim.y + threadIdx.y);
  if (x0 >= width || y0 >= height) return;
  for (int dy = 0; dy < 2 && y0 + dy < height; ++dy) {
    const int row = y0 + dy;
    const size_t c_row = (size_t)(row >> v_shift) * c_pitch;
    uint8_t *out = dst + ((size_t)row * width + x0) * 3;
    for (int dx = 0; dx < 2 && x0 + dx < width; ++dx) {
      const int col = x0 + dx;
      const size_t c = c_row + (col >> 1);
      const int cu = 8 * u[c] - 1024;
      const int cv = 8 * v[c] - 1024;
      int yt = y[(size_t)row * y_pitch + col];
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
// matrix and range (ops/colour.py: coefficients, CRV...)
extern "C" int yuv_rgb(const void *y, int y_pitch, const void *u,
                       const void *v, int c_pitch, int v_shift, int height,
                       int width, int limited, int crv, int cgu, int cgv,
                       int cbu, void *dst, void *stream) {
  const Coefficients k{limited, crv, cgu, cgv, cbu};
  const dim3 block(32, 8);
  const dim3 grid((width + 63) / 64, (height + 15) / 16);
  yuv_rgb_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)y, y_pitch, (const uint8_t *)u, (const uint8_t *)v,
      c_pitch, v_shift, height, width, k, (uint8_t *)dst);
  return (int)cudaGetLastError();
}
