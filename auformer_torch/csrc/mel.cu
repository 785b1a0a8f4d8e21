// Fused log-mel frontend for the fixed 10 s buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel auformer/ops/audio_pallas.py::
// mel_frontend_pallas (body _mel_kernel, edge frames _edge_power):
// (B, 441000) f32 audio -> (B, 64, 1001) normalized log-mel, i.e.
//   torch.stft(center=True, reflect) framing, hop 441, window 882 (periodic
//   hann zero-padded to n_fft 1024), windowed DFT with bf16 operands and f32
//   accumulation, power, the 513x64 HTK mel matmul, zeroing of the left-pad
//   frames by feature_len, 10*log10(max(x, 1e-10)), the per-sample
//   (max - 80 dB) floor and (x + 14.8) / 19.895.
//
// Design. Thread blocks run in no order, so the TPU kernel's carry of the
// previous hop row across a sequential grid axis has no counterpart: each
// block of 32 frames assembles its frames itself from the signal, with the
// reflect padding of frames 0 and 1000 done by index arithmetic (no read
// leaves the buffer). Frames are rounded to bf16 once and kept in shared
// memory (56 KB); the windowed DFT basis (882 x 576 bins, bins 513..575 zero,
// re/im interleaved, bf16) streams through shared memory in 42-row tiles.
// Each thread accumulates 8 frames x 2 bins (re and im) in f32 registers.
// A product of two bf16 values is exact in f32, so this matches a bf16 x bf16
// contraction with f32 accumulation up to the order of summation. Each chunk
// of 64 bins is squared into power and folded into the 64 mel sums at once,
// so the spectrum never reaches device memory. The per-sample dB maximum
// needs every block of the sample: blocks write dB and an atomic max (on an
// order-preserving int encoding of the float); a second, elementwise launch
// applies the floor and the normalization in place.
//
// Bound on this card: operations. 2*1001*882*1026 = 1.81 GFLOP of DFT per
// sample against 1.76 MB read and 0.26 MB written. This first kernel runs the
// DFT on CUDA cores in f32; moving it to bf16 tensor cores (mma/wgmma) is the
// work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLen = 441000;
constexpr int kHop = 441;
constexpr int kWin = 882;
constexpr int kFrames = 1001;
constexpr int kMels = 64;
constexpr int kTileFrames = 32;
constexpr int kChunkBins = 64;
constexpr int kChunks = 9;                           // 576 >= 513 bins
constexpr int kPadBins = kChunks * kChunkBins;
constexpr int kKTile = 42;                           // 882 = 21 * 42
constexpr int kThreads = 128;
constexpr float kAmin = 1e-10f;
constexpr float kTopDb = 80.f;
constexpr float kMean = -14.8f;
constexpr float kStd = 19.895f;

constexpr int kFrameBytes = kWin * kTileFrames * 2;             // bf16
constexpr int kBasisBytes = kKTile * 2 * kChunkBins * 4;        // f32
constexpr int kPowerFloats = kTileFrames * (kChunkBins + 1);    // 2080
constexpr int kDbFloats = kMels * (kTileFrames + 1);            // 2112
constexpr int kScratchBytes =
    4 * (kPowerFloats > kDbFloats ? kPowerFloats : kDbFloats);
constexpr int kSmemBytes = kFrameBytes + kBasisBytes + kScratchBytes;

static_assert(kWin % kKTile == 0, "basis tiles must cover the window");
static_assert(kPadBins >= 513, "bins must cover n_fft / 2 + 1");
static_assert(kFrameBytes % 16 == 0 && kBasisBytes % 16 == 0,
              "shared-memory regions must stay 16-byte aligned");

__device__ __forceinline__ int ordered_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

__device__ __forceinline__ void unpack_bf16x8(const uint4 w, float* x) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(words[i] << 16);
    x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// grid (ceil(1001 / 32), B): 32 frames of one sample per block.
// basis: (882, 576, 2) bf16, [n][bin][re, im]; melfb: (576, 64) f32.
__global__ void __launch_bounds__(kThreads)
mel_db_kernel(const float* __restrict__ audio,
              const __nv_bfloat16* __restrict__ basis,
              const float* __restrict__ melfb, const int* __restrict__ flen,
              float* __restrict__ out, int* __restrict__ max_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* frames = reinterpret_cast<__nv_bfloat16*>(smem);  // [n][f]
  float* tile = reinterpret_cast<float*>(smem + kFrameBytes);       // [r][128]
  float* scratch = reinterpret_cast<float*>(smem + kFrameBytes + kBasisBytes);
  __shared__ float warp_max[kThreads / 32];

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kTileFrames;
  const int tid = threadIdx.x;
  const float* x = audio + static_cast<size_t>(b) * kLen;

  // Frame k covers signal samples (k - 1) * hop + n, n in [0, win), with
  // reflect padding at both ends (torch.stft center=True).
  for (int e = tid; e < kWin * kTileFrames; e += kThreads) {
    const int f = e / kWin;
    const int n = e - f * kWin;
    const int k = k0 + f;
    float val = 0.f;
    if (k < kFrames) {
      int i = (k - 1) * kHop + n;
      if (i < 0) i = -i;
      if (i >= kLen) i = 2 * (kLen - 1) - i;
      val = x[i];
    }
    frames[n * kTileFrames + f] = __float2bfloat16(val);
  }

  const int fg = tid >> 5;   // DFT: frames 8*fg .. 8*fg+7
  const int bg = tid & 31;   //      bins 2*bg, 2*bg+1 of the chunk
  const int mm = tid & 63;   // mel: mel band mm
  const int fh = tid >> 6;   //      frames 16*fh .. 16*fh+15
  float mel[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) mel[j] = 0.f;

  for (int ch = 0; ch < kChunks; ++ch) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

    for (int kt = 0; kt < kWin; kt += kKTile) {
      __syncthreads();  // frames written / previous tile consumed
      for (int e = tid; e < kKTile * kChunkBins; e += kThreads) {
        const int r = e / kChunkBins;
        const int c2 = e - r * kChunkBins;
        const __nv_bfloat162 pair = reinterpret_cast<const __nv_bfloat162*>(
            basis + static_cast<size_t>(kt + r) * (2 * kPadBins) +
            ch * 2 * kChunkBins)[c2];
        reinterpret_cast<float2*>(tile + r * 2 * kChunkBins)[c2] =
            __bfloat1622float2(pair);
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kKTile; ++r) {
        const float4 w =
            reinterpret_cast<const float4*>(tile + r * 2 * kChunkBins)[bg];
        float xf[8];
        unpack_bf16x8(*reinterpret_cast<const uint4*>(
                          frames + (kt + r) * kTileFrames + fg * 8),
                      xf);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] = fmaf(xf[j], w.x, acc[j][0]);
          acc[j][1] = fmaf(xf[j], w.y, acc[j][1]);
          acc[j][2] = fmaf(xf[j], w.z, acc[j][2]);
          acc[j][3] = fmaf(xf[j], w.w, acc[j][3]);
        }
      }
    }

    // power of this chunk -> scratch [frame][65]; the last reads of scratch
    // (previous chunk's mel sums) are behind the syncs of the tile loop
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* row = scratch + (fg * 8 + j) * (kChunkBins + 1);
      row[2 * bg] = acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
      row[2 * bg + 1] = acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
    }
    __syncthreads();
    const float* fb = melfb + static_cast<size_t>(ch) * kChunkBins * kMels;
    for (int f = 0; f < kChunkBins; ++f) {
      const float w = __ldg(fb + f * kMels + mm);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mel[j] = fmaf(scratch[(fh * 16 + j) * (kChunkBins + 1) + f], w,
                      mel[j]);
    }
  }
  __syncthreads();  // every thread is done reading the power scratch

  // mask left-pad frames, dB, per-block max; transpose through scratch
  float* db_t = scratch;  // [mel][33]
  const int valid_from = kFrames - flen[b];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int f = fh * 16 + j;
    const int k = k0 + f;
    const float p = k >= valid_from ? mel[j] : 0.f;
    const float db = 10.f * log10f(fmaxf(p, kAmin));
    db_t[mm * (kTileFrames + 1) + f] = db;
    if (k < kFrames) m = fmaxf(m, db);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float bm = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) bm = fmaxf(bm, warp_max[w]);
    atomicMax(max_key + b, ordered_key(bm));
  }
  for (int e = tid; e < kMels * kTileFrames; e += kThreads) {
    const int mel_i = e / kTileFrames;
    const int f = e - mel_i * kTileFrames;
    const int k = k0 + f;
    if (k < kFrames)
      out[(static_cast<size_t>(b) * kMels + mel_i) * kFrames + k] =
          db_t[mel_i * (kTileFrames + 1) + f];
  }
}

// In place: dB -> max(dB, sample max - 80) -> (x - mean) / std.
__global__ void mel_floor_kernel(float* __restrict__ out,
                                 const int* __restrict__ max_key, int total) {
  const int per_sample = kMels * kFrames;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const float floor_db = key_value(max_key[i / per_sample]) - kTopDb;
    out[i] = (fmaxf(out[i], floor_db) - kMean) / kStd;
  }
}

}  // namespace

extern "C" {

int mel_padded_bins() { return kPadBins; }

// audio (B, 441000) f32; basis (882, 576, 2) bf16; melfb (576, 64) f32;
// flen (B,) int32 valid frames; out (B, 64, 1001) f32; max_key (B,) int32
// scratch. Returns the first nonzero cudaError_t, else 0.
int mel_frontend_forward(const float* audio, const void* basis,
                         const float* melfb, const int* flen, float* out,
                         int* max_key, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      mel_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 0x80808080 decodes below any dB value, so the first atomicMax wins
  err = cudaMemsetAsync(max_key, 0x80, sizeof(int) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((kFrames + kTileFrames - 1) / kTileFrames, batch);
  mel_db_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      audio, static_cast<const __nv_bfloat16*>(basis), melfb, flen, out,
      max_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = batch * kMels * kFrames;
  mel_floor_kernel<<<(total + 255) / 256, 256, 0, s>>>(out, max_key, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
