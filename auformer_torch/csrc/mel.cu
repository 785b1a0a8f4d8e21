// Fused log-mel frontend for the fixed 10 s buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel auformer/ops/audio_pallas.py::
// mel_frontend_pallas (body _mel_kernel, edge frames _edge_power):
// (B, 441000) f32 audio -> (B, 64, 1001) normalized log-mel, i.e.
//   torch.stft(center=True, reflect) framing, hop 441, window 882 (periodic
//   hann zero-padded to n_fft 1024), windowed DFT with bf16 operands and f32
//   accumulation, power, the 513x64 HTK mel matmul in f32, zeroing of the
//   left-pad frames by feature_len, 10*log10(max(x, 1e-10)), the per-sample
//   (max - 80 dB) floor and (x + 14.8) / 19.895.
//
// Bound on this card: operations. 2*1001*882*1026 = 1.81 GFLOP of DFT per
// sample against 1.76 MB read and 0.26 MB written; at the bf16 tensor rate
// the DFT of a B=8 batch is ~15 us. Next comes the L2: every frame tile
// streams the whole 1.9 MB basis through shared memory.
//
// Design. One launch, grid (8 frame tiles x 2, B), clusters of 2 CTAs, 256
// threads a CTA.
//  * Frames. Blocks run in no order, so the TPU kernel's carry of the
//    previous hop row has no counterpart: a CTA assembles its 128 frames
//    from the signal once, rounded to bf16, into shared memory. Frame k is
//    hop rows k-1 and k (hop = win / 2), so the CTA keeps 129 hop rows, each
//    padded 441 -> 456 with zeros, and frame f is the 912 contiguous values
//    from row f: the A operand of every MMA of the CTA, in half the space of
//    whole frames. The basis rows follow the same padded index (zero rows at
//    the pads). The reflect padding of frames 0 and 1000 is index
//    arithmetic; no read leaves the buffer.
//  * DFT on bf16 tensor cores: mma.sync.m16n8k16, f32 accumulators, fed by
//    ldmatrix. The basis is (1024 columns, 912) bf16, re and im of a bin in
//    adjacent columns, so a thread's accumulator pair (c0, c1) is one bin's
//    (re, im) and power is formed in registers. The two CTAs of a cluster
//    take the same 128 frames and 256 bins each, so every CTA streams half
//    the basis: the L2 traffic of a 128-frame tile with the grid of a
//    64-frame one (128 CTAs at B=8). A CTA's bins go in 4 chunks of 64 (128
//    columns); the 8 warps split a chunk 2 x 4 into 64 frames x 32 columns.
//    Basis tiles of 48 k-rows x 128 columns stream through a 4-stage
//    cp.async ring, bf16 in shared memory (no widening).
//  * Bin 512 (Nyquist) is left out: its mel weight is 3e-15 (the top band's
//    edge sits on it), so dropping it moves band 63 by ~1e-13 relative,
//    below f32 rounding; the wrapper checks the weight. 512 bins then fill
//    the tensor-core tiles with no padded bins.
//  * Each chunk's power goes to shared memory and is folded into the mel
//    sums at once, so the spectrum never reaches device memory. The HTK
//    filters are triangles: each band sums only its own bin range (996
//    (bin, band) pairs of 32768), ascending, in f32 on CUDA cores. The two
//    CTAs then swap their partial sums through distributed shared memory;
//    each finishes 32 bands as (rank 0's part + rank 1's part), the same
//    order in both, so the result does not depend on timing.
//  * A tile whose frames are all left padding (feature_len) skips the DFT.
//  * Per-sample floor in the same launch: each CTA writes dB, folds its max
//    into an atomic max (order-preserving int encoding) and bumps the
//    sample's arrival counter; the sample's last CTA applies the floor and
//    the normalization to all 64 x 1001 values and resets both counters for
//    the next call. The wrapper keeps that scratch per device and stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLen = 441000;
constexpr int kHop = 441;
constexpr int kFrames = 1001;
constexpr int kMels = 64;
constexpr int kBins = 512;               // bins 0..511; see the note on 512
constexpr int kCols = 2 * kBins;         // [re, im] per bin
constexpr int kCluster = 2;              // CTAs per frame tile, bins split
constexpr int kCtaBins = kBins / kCluster;                          // 256
constexpr int kTileFrames = 128;
constexpr int kTiles = (kFrames + kTileFrames - 1) / kTileFrames;   // 8
constexpr int kHopStride = 456;          // hop row 441 + 15 zeros (bf16)
constexpr int kHopRows = kTileFrames + 1;
constexpr int kK = 2 * kHopStride;       // 912: a frame's padded extent
constexpr int kChunkBins = 64;
constexpr int kChunkCols = 2 * kChunkBins;
constexpr int kChunks = kCtaBins / kChunkBins;                      // 4
constexpr int kKTile = 48;
constexpr int kKTiles = kK / kKTile;                                // 19
constexpr int kSteps = kChunks * kKTiles;                           // 76
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kBatch = 16;               // sample pairs in flight a thread

// shared-memory row strides (elements): 16-byte units odd for ldmatrix
constexpr int kBasisStride = kKTile + 8;       // bf16, 7 units
constexpr int kPowerStride = kChunkBins + 5;   // f32, odd

constexpr int kFrameBytes = kHopRows * kHopStride * 2;            // 117648
constexpr int kStageBytes = kChunkCols * kBasisStride * 2;        // 14336
constexpr int kPowerBytes = kTileFrames * kPowerStride * 4;       // 35328
constexpr int kSmemBytes = kFrameBytes + kStages * kStageBytes + kPowerBytes;
constexpr int kStageCopies = kChunkCols * kKTile / 8;             // 16 bytes

constexpr float kAmin = 1e-10f;
constexpr float kTopDb = 80.f;
constexpr float kMean = -14.8f;
constexpr float kStd = 19.895f;

static_assert(kHopStride >= kHop && kHopStride % 8 == 0 &&
              (kHopStride / 8) % 2 == 1, "hop rows: 16-byte units, odd");
static_assert(kK % kKTile == 0 && kKTile % 16 == 0, "k tiling");
static_assert(kFrameBytes % 16 == 0 && kStageBytes % 16 == 0,
              "shared-memory regions must stay 16-byte aligned");
static_assert(kSmemBytes <= 227 * 1024, "a CTA's shared memory on sm_90");
static_assert(kStageCopies % kThreads == 0, "whole copies per thread");
static_assert(kMels * kTileFrames * 4 <= kPowerBytes,
              "the partial mel sums fit the power scratch");

#ifdef MEL_PHASE_TIMES
// Built only for scripts/mel_phase_times.py (ops/build.py with this define):
// each CTA's thread 0 stamps the global timer (ns) as it reaches each phase.
constexpr int kPhases = 6;  // start, frames, DFT + mel, swap, arrival, floor
constexpr int kMaxCtas = kTiles * kCluster * 64;
__device__ unsigned long long mel_phase_ns[kMaxCtas][kPhases];
#define MEL_PHASE(i)                                                      \
  if (threadIdx.x == 0 && blockIdx.y < 64) {                              \
    unsigned long long ns_;                                               \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));               \
    mel_phase_ns[blockIdx.y * kTiles * kCluster + blockIdx.x][i] = ns_;   \
  }
#else
#define MEL_PHASE(i)
#endif

__device__ __forceinline__ int ordered_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// Basis step `step` (chunk step / 19, k tile step % 19) of the CTA's
// columns col0.. into a ring slot.
__device__ __forceinline__ void load_basis(const __nv_bfloat16* basis,
                                           __nv_bfloat16* slot, int col0,
                                           int step, int tid) {
  const int chunk = step / kKTiles;
  const int kt = step - chunk * kKTiles;
  const __nv_bfloat16* src =
      basis + static_cast<size_t>(col0 + chunk * kChunkCols) * kK + kt * kKTile;
#pragma unroll
  for (int i = 0; i < kStageCopies / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int col = e / (kKTile / 8);
    const int part = (e - col * (kKTile / 8)) * 8;
    hk::cp_async16(slot + col * kBasisStride + part, src + col * kK + part);
  }
}

// grid (16, B), clusters (2, 1): CTA pair (2t, 2t+1) takes frames
// 128t .. 128t + 127 of sample blockIdx.y, bins 256 * rank ...
// basis (1024, 912) bf16; melfb (64, 512) f32, band-major; ranges (64,)
// [first, end) nonzero bins per band; flen (B,) valid frames; out (B, 64,
// 1001) f32; max_key, count (B,) int32 scratch, INT_MIN and 0 between calls.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
mel_kernel(const float* __restrict__ audio,
           const __nv_bfloat16* __restrict__ basis,
           const float* __restrict__ melfb, const int2* __restrict__ ranges,
           const int* __restrict__ flen, float* __restrict__ out,
           int* __restrict__ max_key, int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* frames = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + kFrameBytes);
  float* power =
      reinterpret_cast<float*>(smem + kFrameBytes + kStages * kStageBytes);
  __shared__ int2 band[kMels];
  __shared__ float warp_max[kThreads / 32];
  __shared__ int last_block;
  __shared__ float floor_db;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  MEL_PHASE(0)
  const int b = blockIdx.y;
  const int k0 = (blockIdx.x / kCluster) * kTileFrames;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int valid_from = kFrames - flen[b];
  if (tid < kMels) band[tid] = ranges[tid];

  const int f = tid & (kTileFrames - 1);  // mel stage: frame f of the tile,
  const int q = tid / kTileFrames;        // bands q, q + 2, ..., q + 62
  float mel[kMels / 2];
#pragma unroll
  for (int j = 0; j < kMels / 2; ++j) mel[j] = 0.f;

  if (k0 + kTileFrames > valid_from) {  // else every frame is left padding
    const int col0 = rank * 2 * kCtaBins;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      load_basis(basis, ring + st * (kStageBytes / 2), col0, st, tid);
      hk::cp_async_commit();
    }
    // Hop row r holds signal samples (k0 - 1 + r) * hop + j, j < 441, with
    // reflect padding at both ends (torch.stft center=True); rows past hop
    // index 1000 (frames past the last) are zero. Pairs of samples, kBatch
    // pairs a thread with their loads in flight together.
    const float* x = audio + static_cast<size_t>(b) * kLen;
    constexpr int kPairs = kHopRows * (kHopStride / 2);
    for (int e0 = tid; e0 < kPairs; e0 += kThreads * kBatch) {
      float v[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / (kHopStride / 2);
        const int j = (e - r * (kHopStride / 2)) * 2;
        const int h = k0 - 1 + r;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          v[u][w] = 0.f;
          if (e < kPairs && h < kFrames && j + w < kHop) {
            int i = h * kHop + j + w;
            if (i < 0) i = -i;
            if (i >= kLen) i = 2 * (kLen - 1) - i;
            v[u][w] = x[i];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < kPairs) {
          const int r = e / (kHopStride / 2);
          const int j = (e - r * (kHopStride / 2)) * 2;
          *reinterpret_cast<uint32_t*>(frames + r * kHopStride + j) =
              hk::pack_bf16(v[u][0], v[u][1]);
        }
      }
    }

    MEL_PHASE(1)
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wm = warp >> 2;  // frames 64 wm .. 64 wm + 63
    const int wn = warp & 3;   // chunk columns 32 wn .. 32 wn + 31
    float acc[4][4][4];
    for (int step = 0; step < kSteps; ++step) {
      hk::cp_async_wait<kStages - 2>();
      __syncthreads();  // step's tile landed; step - 1's slot is free
      if (step + kStages - 1 < kSteps)
        load_basis(basis,
                   ring + ((step + kStages - 1) % kStages) * (kStageBytes / 2),
                   col0, step + kStages - 1, tid);
      hk::cp_async_commit();

      const int chunk = step / kKTiles;
      const int kt = step - chunk * kKTiles;
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
      }
      const __nv_bfloat16* slot = ring + (step % kStages) * (kStageBytes / 2);
#pragma unroll
      for (int ks = 0; ks < kKTile / 16; ++ks) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hk::ldmatrix_x4(a[i], frames +
                                    (wm * 64 + i * 16 + (lane & 15)) *
                                        kHopStride +
                                    kt * kKTile + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bq[4];
          hk::ldmatrix_x4(
              bq, slot +
                      (wn * 32 + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                          kBasisStride +
                      ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hk::mma_bf16(acc[i][2 * jj], a[i], bq[0], bq[1]);
            hk::mma_bf16(acc[i][2 * jj + 1], a[i], bq[2], bq[3]);
          }
        }
      }

      if (kt == kKTiles - 1) {
        // power of this chunk: (c0, c1) = (re, im) of bin 4j + t of the
        // warp's 16 bins, frame g; (c2, c3) the same for frame g + 8. The
        // last reads of `power` (the previous chunk's mel sums) are 19
        // __syncthreads back.
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* p = power + (wm * 64 + i * 16 + g) * kPowerStride +
                       wn * 16 + j * 4 + t;
            p[0] = acc[i][j][0] * acc[i][j][0] + acc[i][j][1] * acc[i][j][1];
            p[8 * kPowerStride] =
                acc[i][j][2] * acc[i][j][2] + acc[i][j][3] * acc[i][j][3];
          }
        __syncthreads();
        const int bin0 = rank * kCtaBins + chunk * kChunkBins;
        const float* prow = power + f * kPowerStride - bin0;
#pragma unroll
        for (int j = 0; j < kMels / 2; ++j) {
          const int m = q + 2 * j;
          const int lo = max(band[m].x, bin0);
          const int hi = min(band[m].y, bin0 + kChunkBins);
          const float* w = melfb + m * kBins;
          for (int bin = lo; bin < hi; ++bin)
            mel[j] = fmaf(prow[bin], __ldg(w + bin), mel[j]);
        }
      }
    }
  }

  MEL_PHASE(2)
  // Swap partial sums: each CTA publishes its [band][frame] partials and
  // finishes bands 32 rank .. 32 rank + 31 as part(rank 0) + part(rank 1).
  __syncthreads();  // the last chunk's reads of `power` are done
  float* part = power;
#pragma unroll
  for (int j = 0; j < kMels / 2; ++j)
    part[(q + 2 * j) * kTileFrames + f] = mel[j];
  cluster.sync();
  const float* part0 = cluster.map_shared_rank(part, 0);
  const float* part1 = cluster.map_shared_rank(part, 1);
  float total[kMels / 4];
#pragma unroll
  for (int j = 0; j < kMels / 4; ++j) {
    const int m = rank * (kMels / 2) + q + 2 * j;
    total[j] = part0[m * kTileFrames + f] + part1[m * kTileFrames + f];
  }
  cluster.sync();  // the peer has read this CTA's partials
  MEL_PHASE(3)

  // mask left-pad frames, dB, store (32 consecutive frames per warp and
  // band: coalesced), block max
  const int k = k0 + f;
  float* out_b = out + static_cast<size_t>(b) * kMels * kFrames;
  float m = -INFINITY;
  if (k < kFrames) {
#pragma unroll
    for (int j = 0; j < kMels / 4; ++j) {
      const float p = k >= valid_from ? total[j] : 0.f;
      const float db = 10.f * log10f(fmaxf(p, kAmin));
      out_b[(rank * (kMels / 2) + q + 2 * j) * kFrames + k] = db;
      m = fmaxf(m, db);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) warp_max[warp] = m;
  __threadfence();  // this CTA's dB stores before its arrival
  __syncthreads();
  if (tid == 0) {
    float bm = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) bm = fmaxf(bm, warp_max[w]);
    atomicMax(max_key + b, ordered_key(bm));
    __threadfence();
    last_block = atomicAdd(count + b, 1) == kTiles * kCluster - 1;
    if (last_block) {
      __threadfence();
      floor_db = key_value(atomicAdd(max_key + b, 0)) - kTopDb;
    }
  }
  __syncthreads();
  MEL_PHASE(4)
  if (!last_block) return;
  // the sample's last CTA: every tile's dB is in memory (in L2); 16-byte
  // accesses, kBatch loads in flight a thread
  const float fl = floor_db;
  float4* out4 = reinterpret_cast<float4*>(out_b);
  constexpr int kVecs = kMels * kFrames / 4;
  static_assert(kMels * kFrames % 4 == 0, "a sample's output is float4s");
  for (int e0 = tid; e0 < kVecs; e0 += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e0 + u * kThreads < kVecs) v[u] = __ldcg(out4 + e0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (e0 + u * kThreads < kVecs) {
        v[u].x = (fmaxf(v[u].x, fl) - kMean) / kStd;
        v[u].y = (fmaxf(v[u].y, fl) - kMean) / kStd;
        v[u].z = (fmaxf(v[u].z, fl) - kMean) / kStd;
        v[u].w = (fmaxf(v[u].w, fl) - kMean) / kStd;
        out4[e0 + u * kThreads] = v[u];
      }
    }
  }
  if (tid == 0) {
    max_key[b] = INT_MIN;
    count[b] = 0;
  }
  MEL_PHASE(5)
}

}  // namespace

extern "C" {

int mel_basis_columns() { return kCols; }
#ifdef MEL_PHASE_TIMES
int mel_phase_times(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, mel_phase_ns, sizeof(mel_phase_ns)));
}
#endif
int mel_hop_stride() { return kHopStride; }

// audio (B, 441000) f32; basis (1024, 912) bf16; melfb (64, 512) f32;
// ranges (64, 2) int32; flen (B,) int32 valid frames; out (B, 64, 1001) f32;
// max_key, count (B,) int32 scratch holding INT_MIN and 0, left so.
// Returns the first nonzero cudaError_t, else 0.
int mel_frontend_forward(const float* audio, const void* basis,
                         const float* melfb, const void* ranges,
                         const int* flen, float* out, int* max_key,
                         int* count, int batch, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kTiles * kCluster, batch);
  mel_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      audio, static_cast<const __nv_bfloat16*>(basis), melfb,
      static_cast<const int2*>(ranges), flen, out, max_key, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
