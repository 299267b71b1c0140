// Fused cross-attention for Hopper (sm_90a), exposed through a plain C entry
// point and called from cotr_tpu_torch/ops/attention.py over ctypes.
//
// Replaces: cotr_tpu/ops/pallas_attention.py, flash_cross_attention and its
// Pallas body _attn_kernel. Per (batch, head) it computes
//     out = softmax((q * 1/sqrt(hd)) k^T) v
// over all S keys, with fp32 logits, an fp32 softmax, probabilities rounded
// to the value dtype before the PV product (as the Pallas body does) and
// fp32 accumulation. q (B, Lq, H, hd); k, v (B, S, H, hd); out (B, Lq, H, hd).
//
// What bounds it on this card: hd = 32 and S = 512 on the COTR path, so the
// work per query is 2 * S * hd multiply-adds against hd loads and stores:
// roughly 30 operations per byte, below the H100's fp32 ridge at batch
// shapes with many queries (encoder Lq = 512, dense decode Lq = 8,192) and
// far below it at the refinement decode (Lq = 1), which is bound by reading
// K and V once.
//
// What the design does about it:
//   * one thread owns one query row: q and the output accumulator live in
//     registers, so logits and probabilities never reach device memory (the
//     point of the TPU kernel, which kept them in VMEM);
//   * the block's 128 query rows share K/V tiles of 64 keys staged in shared
//     memory; every thread of a warp reads the same key row, which the
//     hardware broadcasts;
//   * two passes over the keys (max and sum, then normalised probabilities
//     times V) instead of an online rescaled accumulator: the TPU kernel
//     rounds the NORMALISED probabilities to bf16 before the PV product, and
//     only a second pass reproduces that rounding exactly;
//   * no padding of Lq: the ragged query tile is masked, so the Lq = 1
//     refinement decode costs one row, not 512 as the TPU kernel's padding
//     did;
//   * q, k, v and out are read through their strides in the (B, L, H, hd)
//     layout, so no transposes are needed around the call.
// Products run on the fp32 pipes, not the tensor cores: exact fp32 is what
// the JAX reference computes at float32 (Precision.HIGHEST). A tensor-core
// (wgmma) bf16 path is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueryTile = 128;  // threads per block = query rows per block
constexpr int kKeyTile = 64;     // keys staged in shared memory per step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// probabilities take the value dtype before the PV product
__device__ __forceinline__ float round_prob(float p, float) { return p; }
__device__ __forceinline__ float round_prob(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t s_stride,
                                          int s0, int n) {
  for (int idx = threadIdx.x; idx < kKeyTile * HD; idx += blockDim.x) {
    const int j = idx / HD;
    const int d = idx % HD;
    dst[idx] = j < n ? to_float(src[(int64_t)(s0 + j) * s_stride + d]) : 0.0f;
  }
}

template <int HD>
__device__ __forceinline__ float dot_row(const float* qr, const float* krow) {
  const float4* k4 = reinterpret_cast<const float4*>(krow);
  float acc = 0.0f;
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 kv = k4[d4];
    acc = fmaf(qr[4 * d4 + 0], kv.x, acc);
    acc = fmaf(qr[4 * d4 + 1], kv.y, acc);
    acc = fmaf(qr[4 * d4 + 2], kv.z, acc);
    acc = fmaf(qr[4 * d4 + 3], kv.w, acc);
  }
  return acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kQueryTile)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int lq, int s,
                 int64_t qb, int64_t ql, int64_t qh, int64_t kb, int64_t ks,
                 int64_t kh, int64_t vb, int64_t vs, int64_t vh, int64_t ob,
                 int64_t ol, int64_t oh, float scale) {
  __shared__ __align__(16) float k_tile[kKeyTile * HD];
  __shared__ __align__(16) float v_tile[kKeyTile * HD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kQueryTile + threadIdx.x;
  const bool valid = row < lq;

  const T* kbase = k + b * kb + h * kh;
  const T* vbase = v + b * vb + h * vh;

  float qr[HD];
  if (valid) {
    const T* qrow = q + b * qb + (int64_t)row * ql + h * qh;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_float(qrow[d]) * scale;
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.0f;
  }

  // pass 1: row max and softmax denominator
  float m = -INFINITY;
  float l = 0.0f;
  for (int s0 = 0; s0 < s; s0 += kKeyTile) {
    const int n = min(kKeyTile, s - s0);
    __syncthreads();
    load_tile<T, HD>(k_tile, kbase, ks, s0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float logit = dot_row<HD>(qr, k_tile + j * HD);
      if (logit > m) {
        l *= expf(m - logit);
        m = logit;
      }
      l += expf(logit - m);
    }
  }

  // pass 2: normalised probabilities times V
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  const T tag{};
  for (int s0 = 0; s0 < s; s0 += kKeyTile) {
    const int n = min(kKeyTile, s - s0);
    __syncthreads();
    load_tile<T, HD>(k_tile, kbase, ks, s0, n);
    load_tile<T, HD>(v_tile, vbase, vs, s0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float logit = dot_row<HD>(qr, k_tile + j * HD);
      const float p = round_prob(expf(logit - m) / l, tag);
      const float4* v4 = reinterpret_cast<const float4*>(v_tile + j * HD);
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 vv = v4[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (valid) {
    T* orow = out + b * ob + (int64_t)row * ol + h * oh;
#pragma unroll
    for (int d = 0; d < HD; ++d) store(orow + d, acc[d]);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, int b,
            int lq, int s, int h, const int64_t* st, float scale,
            cudaStream_t stream) {
  const dim3 grid((lq + kQueryTile - 1) / kQueryTile, h, b);
  attention_kernel<T, HD><<<grid, kQueryTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lq, s, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (in elements) are the batch,
// length and head strides of q, k, v and out, in that order; the last
// dimension must be contiguous. scale is 1/sqrt(hd), rounded to float by the
// caller exactly as the reference rounds it. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape this kernel does not take.
int cotr_flash_attention(const void* q, const void* k, const void* v,
                         void* out, int b, int lq, int s, int h, int hd,
                         int dtype, const int64_t* strides, float scale,
                         void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || lq < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 32) {
    launch<float, 32>(q, k, v, out, b, lq, s, h, strides, scale, st);
  } else if (dtype == 1 && hd == 32) {
    launch<__nv_bfloat16, 32>(q, k, v, out, b, lq, s, h, strides, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
