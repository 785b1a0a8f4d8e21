// Whole-row softmax attention for short token sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel auformer/ops/attention.py::pallas_attention
// (body _attn_kernel). For each (batch*head) row: O = softmax(Q K^T * scale) V
// with f32 scores, f32 softmax and an f32 P in P V (the Pallas kernel's
// numerics), the output rounded to the input type. q, k, v and o are strided
// (B, H, N, D) tensors, float32 or bfloat16: the last dimension has stride 1
// and every token row starts on 16 bytes, which is what the permuted views of
// a fused (B, N, 3, H, D) projection give, so the caller copies nothing.
//
// Bound on this card: device-memory bytes. A row reads Q, K, V and writes O
// once, 4*N*D elements for 4*N*N*D flops: ~N/4 flops per f32 byte, under the
// H100's ~20 f32 (~300 bf16) flops per byte. What a call costs beyond that is
// latency: each row is a few KB, so the design keeps every row's work inside
// one warp and puts as many rows in flight as the card holds.
//
// Design.
//  * A CTA takes R rows and gives each row one warp per 16 query tokens
//    (MT = ceil(N / 16) warps a row). The CTA's threads copy the R rows' Q,
//    K, V into shared memory with 16-byte cp.async, wait at one barrier, and
//    each warp then computes its 16 query rows against every key of its row
//    in registers: the scores never leave them. R = min(8 / MT,
//    ceil(rows / 132)), at least 1, as far as shared memory allows: the 1024
//    spatial rows (MT = 4) are 512 CTAs of 8 warps, the 64 temporal rows 64
//    CTAs of 2 warps, the 64 AU-token rows 64 one-warp CTAs.
//  * Token counts are padded to the MMA tile by clamping row addresses to
//    token N-1 (finite data, no zero fill): padded key columns are set to
//    -inf before the row max, padded query rows are never stored.
//  * bf16: Q K^T and P V on tensor cores, mma.sync.m16n8k16 fed by ldmatrix
//    (V through ldmatrix.trans). The S accumulator fragments are the
//    softmax's registers (row max and sum by quad shuffles), and the same
//    registers, split into bf16 hi + lo parts, are the A operand of two P V
//    MMAs: P keeps ~16 mantissa bits, as close to the Pallas kernel's f32
//    P V as the bf16 datapath goes (one bf16 P would follow _xla_attention
//    instead).
//  * float32: 3xTF32 on tensor cores (mma.sync.m16n8k8, each operand split
//    into tf32 big + small parts, three MMAs per product, ~2^-21 relative).
//    Chosen over CUDA-core register tiles because it shares the bf16 path's
//    fragment layout and softmax, and keeps full f32 accuracy (rtol 1e-4)
//    at a third of the TF32 tensor rate, still ~2.5x the CUDA-core f32 rate.
//    The tf32 A fragment holds columns t and t+4, not 2t and 2t+1 as the S
//    accumulator does; permuting the contraction index (k = t <-> 2t,
//    k = t + 4 <-> 2t + 1) on both operands makes the S registers the P
//    operand as they are, and turns Q and K loads into 8-byte pairs.
//  * Row strides in shared memory are padded so that ldmatrix and the fp32
//    fragment loads are free of bank conflicts.
//  * Template buckets bound the register arrays: N <= 16, 32, 64 or 144
//    (the JAX package serves 12, 17, 49 and 129 tokens, one bucket each) and
//    head dims up to 32 or 64. Every tile of a bucket is computed, without
//    branches, so the MMAs are straight-line code that ptxas interleaves;
//    other N take the next bucket up, and a head dim below the bucket's is
//    zero-padded in shared memory. N <= 144, D <= 64, D % 8 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// Passed by value to the kernels; mirrored by ops/attention.py::_Params.
struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_stride[3];  // elements: batch, head, token
  long long k_stride[3];
  long long v_stride[3];
  long long o_stride[3];
  int rows;  // batch * heads
  int heads;
  int n;
  int d;
  float scale;
};

namespace {

constexpr int kMaxWarps = 9;  // 144 tokens: 9 query tiles of one row
constexpr int kMaxTokens = 144;
constexpr int kMaxDim = 64;
constexpr int kSmemLimit = 232448;  // 227 KB, a CTA's most on sm_90
constexpr int kSms = 132;

// Shared-memory row strides, in elements, of a row's Q, K, V copies.
template <int DT16>
struct Bf16Layout {
  static constexpr int kDp = DT16 * 16;
  static constexpr int kStride = kDp + 8;  // 16-byte units odd
  static int row_bytes(int n) { return 3 * n * kStride * 2; }
};

template <int DT8>
struct F32Layout {
  static constexpr int kDp = DT8 * 8;
  static constexpr int kQk = kDp + (kDp % 16 == 0 ? 8 : 0);  // = 8, 24 mod 32
  static constexpr int kV = kDp + 4;                         // = 4 mod 8
  static int row_bytes(int n) { return 4 * n * (2 * kQk + kV); }
};

template <typename T>
__device__ __forceinline__ const T* row_base(const void* p,
                                             const long long* s, int b,
                                             int h) {
  return static_cast<const T*>(p) + b * s[0] + h * s[1];
}

// The CTA copies rows row0 .. row0 + nrows - 1 into shared memory, 16
// bytes per thread and copy, each row's Q and K at stride `qk_stride` and V
// at `v_stride`, and zeroes the head-dim pad d .. dp.
template <typename T>
__device__ __forceinline__ void load_rows(const AttnParams& p, int row0,
                                          int nrows, unsigned char* smem,
                                          int row_elems, int qk_stride,
                                          int v_stride, int dp) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_tok = dp / kPer;
  const int n = p.n;
  for (int r = 0; r < nrows; ++r) {
    const int b = (row0 + r) / p.heads;
    const int h = row0 + r - b * p.heads;
    const T* qg = row_base<T>(p.q, p.q_stride, b, h);
    const T* kg = row_base<T>(p.k, p.k_stride, b, h);
    const T* vg = row_base<T>(p.v, p.v_stride, b, h);
    T* qs = reinterpret_cast<T*>(smem) + r * row_elems;
    T* ks = qs + n * qk_stride;
    T* vs = ks + n * qk_stride;
    for (int e = threadIdx.x; e < n * per_tok; e += blockDim.x) {
      const int tok = e / per_tok;
      const int c = (e - tok * per_tok) * kPer;
      if (c < p.d) {
        hk::cp_async16(qs + tok * qk_stride + c, qg + tok * p.q_stride[2] + c);
        hk::cp_async16(ks + tok * qk_stride + c, kg + tok * p.k_stride[2] + c);
        hk::cp_async16(vs + tok * v_stride + c, vg + tok * p.v_stride[2] + c);
      } else {
        const uint4 zero = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(qs + tok * qk_stride + c) = zero;
        *reinterpret_cast<uint4*>(ks + tok * qk_stride + c) = zero;
        *reinterpret_cast<uint4*>(vs + tok * v_stride + c) = zero;
      }
    }
  }
  hk::cp_async_commit();
}

// Scale, mask the columns >= n to -inf, softmax each accumulator row in
// place. s[j][c]: row g (c < 2) or g + 8, column j * 8 + 2t + (c & 1); the
// four lanes of a quad hold one row between them.
template <int J>
__device__ __forceinline__ void softmax_rows(float (&s)[J][4], int n,
                                             float scale, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = j * 8 + 2 * t + (c & 1);
      s[j][c] = col < n ? s[j][c] * scale : -INFINITY;
      mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[j][c] = expf(s[j][c] - mx[c >> 1]);
      sum[c >> 1] += s[j][c];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = s[j][c] / sum[c >> 1];
  }
}

// The CTA's rows and this warp's (row, query tile); false for a warp past
// the last row. Call after the barrier that follows load_rows.
struct WarpTask {
  int r, m, b, h;
};

__device__ __forceinline__ bool warp_task(const AttnParams& p, int row0,
                                          int nrows, int mt, WarpTask& w) {
  const int warp = threadIdx.x >> 5;
  w.r = warp / mt;
  w.m = warp - w.r * mt;
  if (w.r >= nrows) return false;
  w.b = (row0 + w.r) / p.heads;
  w.h = row0 + w.r - w.b * p.heads;
  return true;
}

// KT16: key tiles of 16 (N <= 16 * KT16); DT16: head-dim tiles of 16.
template <int KT16, int DT16>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_bf16_kernel(const AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Bf16Layout<DT16>;
  constexpr int S = L::kStride;
  const int n = p.n;
  const int mt = (n + 15) >> 4;
  const int per_cta = (blockDim.x >> 5) / mt;
  const int row0 = blockIdx.x * per_cta;
  const int nrows = min(per_cta, p.rows - row0);
  load_rows<__nv_bfloat16>(p, row0, nrows, smem, 3 * n * S, S, S, L::kDp);
  hk::cp_async_wait<0>();
  __syncthreads();
  WarpTask w;
  if (!warp_task(p, row0, nrows, mt, w)) return;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* qs =
      reinterpret_cast<const __nv_bfloat16*>(smem) + w.r * 3 * n * S;
  const __nv_bfloat16* ks = qs + n * S;
  const __nv_bfloat16* vs = ks + n * S;

  uint32_t qa[DT16][4];
  {
    const int r = min(w.m * 16 + (lane & 15), n - 1);
#pragma unroll
    for (int kk = 0; kk < DT16; ++kk)
      hk::ldmatrix_x4(qa[kk], qs + r * S + kk * 16 + (lane >> 4) * 8);
  }
  float s[2 * KT16][4];
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int j = 0; j < KT16; ++j) {
    const int key = min(j * 16 + (lane & 7) + ((lane >> 4) << 3), n - 1);
#pragma unroll
    for (int kk = 0; kk < DT16; ++kk) {
      uint32_t kb[4];
      hk::ldmatrix_x4(kb, ks + key * S + kk * 16 + ((lane >> 3) & 1) * 8);
      hk::mma_bf16(s[2 * j], qa[kk], kb[0], kb[1]);
      hk::mma_bf16(s[2 * j + 1], qa[kk], kb[2], kb[3]);
    }
  }
  softmax_rows(s, n, p.scale, t);

  float o[2 * DT16][4];
#pragma unroll
  for (int j = 0; j < 2 * DT16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
#pragma unroll
  for (int j = 0; j < KT16; ++j) {
    uint32_t hi[4], lo[4];
    hk::split_bf16(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
    hk::split_bf16(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
    hk::split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
    hk::split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
    const int key = min(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, n - 1);
#pragma unroll
    for (int nn = 0; nn < DT16; ++nn) {
      uint32_t vb[4];
      hk::ldmatrix_x4_trans(vb, vs + key * S + nn * 16 + (lane >> 4) * 8);
      hk::mma_bf16(o[2 * nn], lo, vb[0], vb[1]);
      hk::mma_bf16(o[2 * nn], hi, vb[0], vb[1]);
      hk::mma_bf16(o[2 * nn + 1], lo, vb[2], vb[3]);
      hk::mma_bf16(o[2 * nn + 1], hi, vb[2], vb[3]);
    }
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      w.b * p.o_stride[0] + w.h * p.o_stride[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tok = w.m * 16 + g + 8 * r;
    if (tok < n) {
      __nv_bfloat16* orow = og + tok * p.o_stride[2] + 2 * t;
#pragma unroll
      for (int j = 0; j < 2 * DT16; ++j)
        if (j * 8 < p.d)
          *reinterpret_cast<uint32_t*>(orow + j * 8) =
              hk::pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
    }
  }
}

// The tf32 big and small parts of four A values.
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) hk::split_tf32(a[i], big[i], small[i]);
}

// d += a * b in ~f32 precision from three tf32 MMAs (small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  hk::split_tf32(b0, bb0, bs0);
  hk::split_tf32(b1, bb1, bs1);
  hk::mma_tf32(d, as, bb0, bb1);
  hk::mma_tf32(d, ab, bs0, bs1);
  hk::mma_tf32(d, ab, bb0, bb1);
}

// KT8: key tiles of 8 (N <= 8 * KT8); DT8: head-dim tiles of 8.
template <int KT8, int DT8>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_f32_kernel(const AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = F32Layout<DT8>;
  constexpr int SQ = L::kQk;
  constexpr int SV = L::kV;
  const int n = p.n;
  const int mt = (n + 15) >> 4;
  const int per_cta = (blockDim.x >> 5) / mt;
  const int row0 = blockIdx.x * per_cta;
  const int nrows = min(per_cta, p.rows - row0);
  load_rows<float>(p, row0, nrows, smem, n * (2 * SQ + SV), SQ, SV, L::kDp);
  hk::cp_async_wait<0>();
  __syncthreads();
  WarpTask w;
  if (!warp_task(p, row0, nrows, mt, w)) return;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* qs = reinterpret_cast<const float*>(smem) +
                    w.r * n * (2 * SQ + SV);
  const float* ks = qs + n * SQ;
  const float* vs = ks + n * SQ;
  const float* q0 = qs + min(w.m * 16 + g, n - 1) * SQ + 2 * t;
  const float* q1 = qs + min(w.m * 16 + g + 8, n - 1) * SQ + 2 * t;

  float s[KT8][4];
#pragma unroll
  for (int j = 0; j < KT8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DT8; ++kk) {
    // contraction index k = t <-> dim 2t, k = t + 4 <-> dim 2t + 1
    const float2 x0 = *reinterpret_cast<const float2*>(q0 + kk * 8);
    const float2 x1 = *reinterpret_cast<const float2*>(q1 + kk * 8);
    const float a[4] = {x0.x, x1.x, x0.y, x1.y};
    uint32_t ab[4], as[4];
    split_a(a, ab, as);
#pragma unroll
    for (int j = 0; j < KT8; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(
          ks + min(j * 8 + g, n - 1) * SQ + kk * 8 + 2 * t);
      mma_3xtf32(s[j], ab, as, kb.x, kb.y);
    }
  }
  softmax_rows(s, n, p.scale, t);

  float o[DT8][4];
#pragma unroll
  for (int j = 0; j < DT8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
#pragma unroll
  for (int j = 0; j < KT8; ++j) {
    // contraction index k = t <-> key 2t, k = t + 4 <-> key 2t + 1: the S
    // fragment is the A operand as it stands
    const float a[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
    uint32_t ab[4], as[4];
    split_a(a, ab, as);
    const float* v0 = vs + min(j * 8 + 2 * t, n - 1) * SV + g;
    const float* v1 = vs + min(j * 8 + 2 * t + 1, n - 1) * SV + g;
#pragma unroll
    for (int nd = 0; nd < DT8; ++nd)
      mma_3xtf32(o[nd], ab, as, v0[nd * 8], v1[nd * 8]);
  }
  float* og = static_cast<float*>(p.o) + w.b * p.o_stride[0] +
              w.h * p.o_stride[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tok = w.m * 16 + g + 8 * r;
    if (tok < n) {
      float* orow = og + tok * p.o_stride[2] + 2 * t;
#pragma unroll
      for (int j = 0; j < DT8; ++j)
        if (j * 8 < p.d)
          *reinterpret_cast<float2*>(orow + j * 8) =
              make_float2(o[j][2 * r], o[j][2 * r + 1]);
    }
  }
}

using KernelFn = void (*)(AttnParams);

// Above 48 KB of dynamic shared memory a kernel must opt in, once per device.
cudaError_t opt_in(KernelFn kernel) {
  constexpr int kSlots = 64;
  static KernelFn done_fn[kSlots];
  static int done_dev[kSlots];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_done; ++i)
    if (done_fn[i] == kernel && done_dev[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && n_done < kSlots) {
    done_fn[n_done] = kernel;
    done_dev[n_done++] = dev;
  }
  return err;
}

// The template of a shape: the smallest key bucket that holds n, head-dim
// tiles for D <= 32 or D <= 64.
KernelFn pick_kernel(int n, int d, int dtype) {
  const int wide = d > 32;
  const int kb = n <= 16 ? 0 : n <= 32 ? 1 : n <= 64 ? 2 : 3;
  static const KernelFn bf16[4][2] = {
      {attention_bf16_kernel<1, 2>, attention_bf16_kernel<1, 4>},
      {attention_bf16_kernel<2, 2>, attention_bf16_kernel<2, 4>},
      {attention_bf16_kernel<4, 2>, attention_bf16_kernel<4, 4>},
      {attention_bf16_kernel<9, 2>, attention_bf16_kernel<9, 4>}};
  static const KernelFn f32[4][2] = {
      {attention_f32_kernel<2, 4>, attention_f32_kernel<2, 8>},
      {attention_f32_kernel<4, 4>, attention_f32_kernel<4, 8>},
      {attention_f32_kernel<8, 4>, attention_f32_kernel<8, 8>},
      {attention_f32_kernel<18, 4>, attention_f32_kernel<18, 8>}};
  return dtype == 1 ? bf16[kb][wide] : f32[kb][wide];
}

int row_bytes(int n, int d, int dtype) {
  if (dtype == 1)
    return d <= 32 ? Bf16Layout<2>::row_bytes(n) : Bf16Layout<4>::row_bytes(n);
  return d <= 32 ? F32Layout<4>::row_bytes(n) : F32Layout<8>::row_bytes(n);
}

}  // namespace

extern "C" {

// Checks the shape and gives the launch: rows per CTA, warps per CTA and
// one CTA's dynamic shared memory. Returns 0, or -1 for a shape the kernel
// does not take.
int attention_launch_shape(int rows, int n, int d, int dtype,
                           int* rows_per_cta, int* warps, int* smem) {
  if (n < 1 || n > kMaxTokens || d < 8 || d > kMaxDim || d % 8 != 0 ||
      (dtype != 0 && dtype != 1) || rows < 1)
    return -1;
  const int mt = (n + 15) / 16;
  const int per_row = row_bytes(n, d, dtype);
  int r = (rows + kSms - 1) / kSms;
  const int most = 8 / mt > 1 ? 8 / mt : 1;
  r = r < 1 ? 1 : r > most ? most : r;
  while (r > 1 && r * per_row > kSmemLimit) --r;
  if (per_row > kSmemLimit) return -1;
  *rows_per_cta = r;
  *warps = r * mt;
  *smem = r * per_row;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch,
// or cudaErrorInvalidValue for a shape the kernel does not take.
int attention_forward(const AttnParams* params, int dtype, void* stream) {
  const AttnParams& p = *params;
  int per_cta, warps, smem;
  if (attention_launch_shape(p.rows, p.n, p.d, dtype, &per_cta, &warps,
                             &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn kernel = pick_kernel(p.n, p.d, dtype);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in(kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ctas = (p.rows + per_cta - 1) / per_cta;
  kernel<<<ctas, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
