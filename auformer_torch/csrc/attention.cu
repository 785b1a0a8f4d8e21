// Whole-row softmax attention for short token sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel auformer/ops/attention.py::pallas_attention
// (body _attn_kernel). For each (batch*head) row: O = softmax(Q K^T * scale) V,
// all arithmetic in f32 (P V included), the output cast to the input type.
// Inputs are contiguous (rows, n, d) tensors, float32 or bfloat16.
//
// Design. avformer's attention calls are tiny: n = 49 / 17 / 12 tokens,
// d = 32 / 64. One CTA takes one row and keeps Q, K, V (as f32) and the whole
// n x n score tile in shared memory (28.6 KB at n=49, d=32), so nothing
// between Q K^T, the softmax and P V goes to device memory. K rows are padded
// to d+1 floats so the column reads of Q K^T are free of bank conflicts.
//
// Bound on this card: device-memory bytes. Each row reads Q, K, V and writes
// O once: 4*n*d elements for 4*n*n*d flops, i.e. ~n/4 flops per f32 byte,
// far below the H100's ~20 f32 flops per byte of bandwidth. This first kernel
// uses CUDA cores only; tensor cores (mma/wgmma) and several rows per CTA are
// work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n, int d,
                 float scale) {
  extern __shared__ float smem[];
  const int kd = d + 1;
  float* qs = smem;          // n x d
  float* ks = qs + n * d;    // n x (d + 1)
  float* vs = ks + n * kd;   // n x d
  float* ps = vs + n * d;    // n x n scores, then probabilities
  const int nd = n * d;
  const size_t base = static_cast<size_t>(blockIdx.x) * nd;

  for (int e = threadIdx.x; e < nd; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    qs[e] = to_f32(q[base + e]);
    ks[r * kd + c] = to_f32(k[base + e]);
    vs[e] = to_f32(v[base + e]);
  }
  __syncthreads();

  const int nn = n * n;
  for (int e = threadIdx.x; e < nn; e += kThreads) {
    const int i = e / n;
    const int j = e - i * n;
    const float* qi = qs + i * d;
    const float* kj = ks + j * kd;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
    ps[e] = acc * scale;
  }
  __syncthreads();

  // row softmax, one warp per row: p = exp(s - max) / sum
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kThreads / 32) {
    float* row = ps + i * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      s += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    for (int j = lane; j < n; j += 32) row[j] = row[j] / s;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nd; e += kThreads) {
    const int i = e / d;
    const int c = e - i * d;
    const float* pi = ps + i * n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pi[j], vs[j * d + c], acc);
    o[base + e] = from_f32<T>(acc);
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for an (n, d) row; the wrapper refuses shapes
// above the 48 KB a launch gets without opting in.
int attention_smem_bytes(int n, int d) {
  return static_cast<int>(sizeof(float)) * (2 * n * d + n * (d + 1) + n * n);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int attention_forward(const void* q, const void* k, const void* v, void* o,
                      int rows, int n, int d, float scale, int dtype,
                      void* stream) {
  const size_t smem = static_cast<size_t>(attention_smem_bytes(n, d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attention_kernel<float><<<rows, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), n, d, scale);
  } else if (dtype == 1) {
    attention_kernel<__nv_bfloat16><<<rows, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        n, d, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
