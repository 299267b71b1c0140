// Fused cross-attention for Hopper (sm_90a), exposed through a plain C entry
// point and called from cotr_tpu_torch/ops/attention.py over ctypes.
//
// Replaces: cotr_tpu/ops/pallas_attention.py, flash_cross_attention and its
// Pallas body _attn_kernel. Per (batch, head) it computes
//     out = softmax((q * 1/sqrt(hd)) k^T) v
// over all S keys, with fp32 logits, an fp32 softmax, the NORMALISED
// probabilities rounded to the value dtype before the PV product (as the
// Pallas body does) and fp32 accumulation. q (B, Lq, H, hd); k, v
// (B, S, H, hd); out (B, Lq, H, hd); all read through their strides.
//
// Two kernels, chosen by the wrapper from Lq.
//
// attention_kernel_tile (many query rows: encoder Lq = 512, dense decode
// Lq = 8,192). What bounds it: operations, and among them not only the
// products. At hd = 32 a logit costs 128 tensor-core operations (64 for
// q k^T, 64 for p v) and one exp. An SM does about 4,096 dense bf16
// operations a clock but only 16 exp, so in bfloat16 the softmax, not the
// two products, sets the pace by about 2x. mma.sync tiles are therefore
// enough there: wgmma and TMA would speed up the part that is not the limit.
// In float32 the three TF32 products of the split cost six times the
// tensor-core time of the bf16 product, and there the products set the pace.
// What the design does:
//   * a warp owns 16 query rows, 4 or 8 warps a block share the K and V
//     tiles (64 keys) that stream through shared memory, fetched into
//     registers one tile ahead;
//   * both products run on the tensor cores (mma.sync), and the logits and
//     probabilities never leave the registers: the accumulator tiles of
//     q k^T are, after the exp, the A operand of p v (WarpTile);
//   * two passes over the keys instead of an online rescaled sum. The TPU
//     kernel rounds the NORMALISED probabilities to bf16 before p v, so the
//     row's maximum and sum must be known before the first probability is
//     formed: pass 1 finds them, pass 2 recomputes the logits (cheap on the
//     tensor cores) and multiplies with V. In float32 there is no rounding
//     to reproduce, so pass 1 only places the maximum, from one TF32 product,
//     and pass 2 sums as it goes and divides at the end;
//   * float32 keeps seven digits on TF32 tensor cores by splitting every
//     operand into hi = tf32(x) and lo = tf32(x - hi) and summing the three
//     products lo*hi, hi*lo, hi*hi, small terms first. One TF32 product alone
//     errs by 1e-3. The tensor cores add into their accumulator with
//     truncation, so long sums are cut into key tiles whose partial sums are
//     added on the fp32 pipes;
//   * bfloat16 scales the fp32 logits after the product and not q before it:
//     q / sqrt(32) is not a bf16 number;
//   * keys past S are zero-filled and get probability 0; rows past Lq are
//     computed on zeros and never stored; any S is taken.
//
// attention_kernel_row (Lq of a few rows: the refinement decode, Lq = 1 at a
// batch of up to 256). What bounds it: bytes, reading K and V once. No
// tensor cores. One block per (batch, head, query row); its threads split
// the S keys, each reading whole key rows in 16-byte loads with q in
// registers; block-wide maximum and sum by warp shuffles; then the threads
// re-map to (key group, 16-byte column) for p v, so V is read coalesced, and
// the partial outputs are reduced through shared memory. fp32 FMAs
// throughout; only the order of the sums differs from the plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kHeadDim = 32;
constexpr int kRowThreads = 128;
constexpr int kRowMaxKeys = 8192;  // row kernel: logits + scratch under 48 KB

struct Strides {  // in elements: batch, length, head of q, k, v, out
  int64_t qb, ql, qh, kb, ks, kh, vb, vs, vh, ob, ol, oh;
};

// 16 bytes of T
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
// probabilities take the value dtype before the PV product
__device__ __forceinline__ float round_prob(float p, float) { return p; }
__device__ __forceinline__ float round_prob(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

// ------------------------------------------------------------ tile kernel

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t to_tf32(float x) {  // to nearest
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}
// x = hi + lo to 21 bits, both TF32 numbers
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ float exp2_approx(float x) {  // 2 ulp; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c (16 x 8, fp32) += a (16 x 8, TF32) b (8 x 8, TF32). With g = lane / 4 and
// t = lane % 4 a thread holds a[0] = A(g, t), a[1] = A(g + 8, t),
// a[2] = A(g, t + 4), a[3] = A(g + 8, t + 4); b0 = B(t, g), b1 = B(t + 4, g);
// c[0], c[1] = C(g, 2t), C(g, 2t + 1); c[2], c[3] the same of row g + 8.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16), two values a
// register: a[0] = A(g, 2t..), a[1] = A(g + 8, 2t..), a[2] = A(g, 2t + 8..),
// a[3] = A(g + 8, 2t + 8..); b0 = B(2t.., g), b1 = B(2t + 8.., g); c as above.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What one warp does with its 16 query rows, per dtype: q as A fragments in
// registers, the logits of 16 keys as two accumulator tiles, and those
// tiles, turned into probabilities, times V into the output tiles. K and V
// tiles lie in shared memory as `copies` arrays of key_tile rows, ldk or ldv
// elements apart.
template <typename T> struct WarpTile;

// float32: TF32 tiles, every operand split into hi + lo (K and V when they
// are staged, q and the probabilities in registers), three products
// lo*hi, hi*lo, hi*hi summed small terms first. The tensor cores add into
// their accumulator with truncation, a bias that grows with the length of
// the chain; so p v is summed there over one key tile only and the tiles'
// sums are added on the fp32 pipes, which round to nearest.
template <> struct WarpTile<float> {
  static constexpr int copies = 2;   // hi, lo
  static constexpr int key_tile = 64;
  static constexpr int ldk = 36;     // row strides that keep the 16-byte
  static constexpr int ldv = 36;     // fragment loads free of bank conflicts
  static constexpr bool kScaleQ = true;  // q scaled in fp32, as the plain version
  uint32_t qhi[4][4], qlo[4][4];

  __device__ __forceinline__ void load_q(const float* q, int64_t stride,
                                         int valid, float scale, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the sum over the head dimension does not care about its order:
        // slots t and t + 4 of step ks take dimensions 8t + 2ks and + 1, so
        // that a thread's share of a key row is 8 neighbours, two 16-byte loads
        const int r = g + (i & 1) * 8;
        const int c = 8 * t + 2 * ks + (i >> 1);
        const float x = r < valid ? q[(int64_t)r * stride + c] * scale : 0.0f;
        split_tf32(x, qhi[ks][i], qlo[ks][i]);
      }
  }
  // a thread's 8 dimensions of one key row: b[2 * ks], b[2 * ks + 1] are the
  // B fragment of step ks
  static __device__ __forceinline__ void key_row(uint32_t (&b)[8],
                                                 const uint32_t* at) {
    const uint4 lo = *reinterpret_cast<const uint4*>(at);
    const uint4 hi = *reinterpret_cast<const uint4*>(at + 4);
    b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
    b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
  }
  // logits of keys [k0, k0 + 16) of the staged tile, hi*hi only: good to
  // three digits, enough to place the maximum
  __device__ __forceinline__ void scores_coarse(float (&sc)[2][4], const float* ks_,
                                                int k0, int g, int t) const {
    const uint32_t* kh = reinterpret_cast<const uint32_t*>(ks_);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.0f;
      uint32_t bh[8];
      key_row(bh, kh + (k0 + 8 * j + g) * ldk + 8 * t);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_tf32(sc[j], qhi[ks], bh[2 * ks], bh[2 * ks + 1]);
    }
  }
  __device__ __forceinline__ void scores(float (&sc)[2][4], const float* ks_,
                                         int k0, int g, int t) const {
    const uint32_t* kh = reinterpret_cast<const uint32_t*>(ks_);
    const uint32_t* kl = kh + key_tile * ldk;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.0f;
      const int off = (k0 + 8 * j + g) * ldk + 8 * t;
      uint32_t bh[8], bl[8];
      key_row(bh, kh + off);
      key_row(bl, kl + off);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        mma_tf32(sc[j], qlo[ks], bh[2 * ks], bh[2 * ks + 1]);
        mma_tf32(sc[j], qhi[ks], bl[2 * ks], bl[2 * ks + 1]);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_tf32(sc[j], qhi[ks], bh[2 * ks], bh[2 * ks + 1]);
    }
  }
  // acc (16 x 32 as four tiles) += p v over keys [k0, k0 + 16). An
  // accumulator tile holds columns 2t, 2t + 1 where the A operand wants t,
  // t + 4; the sum over keys does not care, so key 2t rides in slot t and
  // key 2t + 1 in slot t + 4, for p and for v alike. Nor does the output
  // care which of its columns a tile holds: column g of tile d is dimension
  // 4g + d, so that a thread reads 4 neighbours of a V row in one load and
  // ends up with dimensions 8t .. 8t + 7 of its rows (store_out).
  __device__ __forceinline__ void pv(float (&acc)[4][4], const float (&p)[2][4],
                                     const float* vs_, int k0, int g, int t) const {
    const uint32_t* vh = reinterpret_cast<const uint32_t*>(vs_);
    const uint32_t* vl = vh + key_tile * ldv;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t phi[4], plo[4];
      split_tf32(p[j][0], phi[0], plo[0]);
      split_tf32(p[j][2], phi[1], plo[1]);
      split_tf32(p[j][1], phi[2], plo[2]);
      split_tf32(p[j][3], phi[3], plo[3]);
      const int off = (k0 + 8 * j + 2 * t) * ldv + 4 * g;
      const uint4 h0 = *reinterpret_cast<const uint4*>(vh + off);
      const uint4 h1 = *reinterpret_cast<const uint4*>(vh + off + ldv);
      const uint4 l0 = *reinterpret_cast<const uint4*>(vl + off);
      const uint4 l1 = *reinterpret_cast<const uint4*>(vl + off + ldv);
      const uint32_t bh0[4] = {h0.x, h0.y, h0.z, h0.w};
      const uint32_t bh1[4] = {h1.x, h1.y, h1.z, h1.w};
      const uint32_t bl0[4] = {l0.x, l0.y, l0.z, l0.w};
      const uint32_t bl1[4] = {l1.x, l1.y, l1.z, l1.w};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        mma_tf32(acc[d], plo, bh0[d], bh1[d]);
        mma_tf32(acc[d], phi, bl0[d], bl1[d]);
        mma_tf32(acc[d], phi, bh0[d], bh1[d]);
      }
    }
  }
  // row (g or g + 8, picked by r) of the output tiles, scaled
  static __device__ __forceinline__ void store_out(float* orow, const float (&acc)[4][4],
                                                   int r, float norm, int t) {
    float4* at = reinterpret_cast<float4*>(orow + 8 * t);
    at[0] = make_float4(acc[0][2 * r] * norm, acc[1][2 * r] * norm,
                        acc[2][2 * r] * norm, acc[3][2 * r] * norm);
    at[1] = make_float4(acc[0][2 * r + 1] * norm, acc[1][2 * r + 1] * norm,
                        acc[2][2 * r + 1] * norm, acc[3][2 * r + 1] * norm);
  }
};

// bfloat16: one product each, the fp32 logits scaled after the product
// (q / sqrt(32) is not a bf16 number). Two logits tiles side by side are
// already laid out as the A operand of the 16-key p v step; V's fragments
// come transposed out of shared memory through ldmatrix.
template <> struct WarpTile<__nv_bfloat16> {
  static constexpr int copies = 1;
  static constexpr int key_tile = 64;
  static constexpr int ldk = 32;  // 16-byte loads of K rows: no padding wanted
  static constexpr int ldv = 40;  // ldmatrix: rows 80 bytes apart
  static constexpr bool kScaleQ = false;
  uint32_t qf[2][4];

  __device__ __forceinline__ void load_q(const __nv_bfloat16* q, int64_t stride,
                                         int valid, float, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // as in float32, the head dimension is re-ordered: a thread's
        // share of a key row is dimensions 8t .. 8t + 7, one 16-byte load
        const int r = g + (i & 1) * 8;
        const int c = 8 * t + 4 * ks + 2 * (i >> 1);
        qf[ks][i] = r < valid ? *reinterpret_cast<const uint32_t*>(
                                    q + (int64_t)r * stride + c)
                              : 0u;
      }
  }
  __device__ __forceinline__ void scores(float (&sc)[2][4],
                                         const __nv_bfloat16* ks_, int k0,
                                         int g, int t) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.0f;
      const uint4 b = *reinterpret_cast<const uint4*>(
          ks_ + (k0 + 8 * j + g) * ldk + 8 * t);
      mma_bf16(sc[j], qf[0], b.x, b.y);
      mma_bf16(sc[j], qf[1], b.z, b.w);
    }
  }
  __device__ __forceinline__ void scores_coarse(float (&sc)[2][4],
                                                const __nv_bfloat16* ks_,
                                                int k0, int g, int t) const {
    scores(sc, ks_, k0, g, t);
  }
  __device__ __forceinline__ void pv(float (&acc)[4][4], const float (&p)[2][4],
                                     const __nv_bfloat16* vs_, int k0, int,
                                     int) const {
    uint32_t a[4];
    a[0] = pack_bf16(p[0][0], p[0][1]);
    a[1] = pack_bf16(p[0][2], p[0][3]);
    a[2] = pack_bf16(p[1][0], p[1][1]);
    a[3] = pack_bf16(p[1][2], p[1][3]);
    // four 8 x 8 blocks of V a call: keys k0.. and k0 + 8.. of two output
    // tiles; lanes 0-7, 8-15, 16-23, 24-31 name the rows of one block each
    const int lane = threadIdx.x % 32;
    const __nv_bfloat16* row =
        vs_ + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldv + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t b[4];
      const uint32_t addr =
          (uint32_t)__cvta_generic_to_shared(row + dp * 16);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(addr));
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
  static __device__ __forceinline__ void store_out(__nv_bfloat16* orow,
                                                   const float (&acc)[4][4],
                                                   int r, float norm, int t) {
#pragma unroll
    for (int d = 0; d < 4; ++d)
      *reinterpret_cast<uint32_t*>(orow + 8 * d + 2 * t) =
          pack_bf16(acc[d][2 * r] * norm, acc[d][2 * r + 1] * norm);
  }
};

// one key tile on its way from device memory to shared memory, held in
// registers so that the loads of the next tile are in flight while the
// warps work on this one; float32 values are split into hi and lo on the
// way in, once a block and not once a warp
template <typename T, int kThreads>
struct TileFetch {
  static constexpr int n = Vec<T>::n;
  static constexpr int lanes = kHeadDim / n;
  static constexpr int kKeyTile = WarpTile<T>::key_tile;
  static constexpr int kTotal = kKeyTile * lanes;
  static constexpr int kPer = (kTotal + kThreads - 1) / kThreads;
  uint4 raw[kPer];

  __device__ __forceinline__ void fetch(const T* src, int64_t stride, int valid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / lanes;
      const int c = (idx % lanes) * n;
      raw[i] = make_uint4(0u, 0u, 0u, 0u);  // keys past S are zeros
      if (idx < kTotal && r < valid)
        raw[i] = *reinterpret_cast<const uint4*>(src + (int64_t)r * stride + c);
    }
  }
  __device__ __forceinline__ void commit(T* dst, int ld) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx >= kTotal) continue;
      T* at = dst + (idx / lanes) * ld + (idx % lanes) * n;
      if constexpr (std::is_same<T, float>::value) {
        uint4 hi, lo;
        split_tf32(__uint_as_float(raw[i].x), hi.x, lo.x);
        split_tf32(__uint_as_float(raw[i].y), hi.y, lo.y);
        split_tf32(__uint_as_float(raw[i].z), hi.z, lo.z);
        split_tf32(__uint_as_float(raw[i].w), hi.w, lo.w);
        *reinterpret_cast<uint4*>(at) = hi;
        *reinterpret_cast<uint4*>(at + kKeyTile * ld) = lo;
      } else {
        *reinterpret_cast<uint4*>(at) = raw[i];
      }
    }
  }
};

// kWarps warps a block, 16 query rows each. Two passes over the keys:
// the first finds each row's maximum (and in bfloat16 its sum), the second
// forms the probabilities in registers and multiplies them with V.
template <typename T, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel_tile(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int lq,
                      int s, int h, int row_tiles, Strides st, float scale) {
  using W = WarpTile<T>;
  constexpr int kThreads = kWarps * 32;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kKeyTile = W::key_tile;
  __shared__ uint4 kraw[W::copies * kKeyTile * W::ldk * (int)sizeof(T) / 16];
  __shared__ uint4 vraw[W::copies * kKeyTile * W::ldv * (int)sizeof(T) / 16];
  T* ksm = reinterpret_cast<T*>(kraw);
  T* vsm = reinterpret_cast<T*>(vraw);

  const int tile = blockIdx.x % row_tiles;
  const int bh = blockIdx.x / row_tiles;
  const int hh = bh % h;
  const int b = bh / h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = tile * (kWarps * 16) + warp * 16;  // of this warp
  const bool live = row0 < lq;  // a warp past Lq only helps to stage

  const T* kbase = k + b * st.kb + hh * st.kh;
  const T* vbase = v + b * st.vb + hh * st.vh;

  TileFetch<T, kThreads> knext, vnext;
  knext.fetch(kbase, st.ks, min(kKeyTile, s));

  W w;
  w.load_q(q + b * st.qb + (int64_t)row0 * st.ql + hh * st.qh, st.ql,
           lq - row0, scale, g, t);
  // logits go through exp2: x = c * logit, with the scale folded in where
  // q was not scaled
  const float c = W::kScaleQ ? kLog2e : scale * kLog2e;

  // pass 1: per thread and row (g and g + 8), the maximum over the thread's
  // own columns and, in bfloat16, the sum of exp2 against that maximum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  for (int k0 = 0; k0 < s; k0 += kKeyTile) {
    __syncthreads();
    knext.commit(ksm, W::ldk);
    __syncthreads();
    const int k1 = k0 + kKeyTile < s ? k0 + kKeyTile : 0;  // then pass 2's first
    knext.fetch(kbase + (int64_t)k1 * st.ks, st.ks, min(kKeyTile, s - k1));
    if (k1 == 0) vnext.fetch(vbase, st.vs, min(kKeyTile, s));
    if (!live) continue;
    float sc[kKeyTile / 16][2][4];
#pragma unroll
    for (int step = 0; step < kKeyTile / 16; ++step) {
      w.scores_coarse(sc[step], ksm, step * 16, g, t);
      if (k0 + kKeyTile > s) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + step * 16 + j * 8 + 2 * t + (i & 1) >= s)
              sc[step][j][i] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int step = 0; step < kKeyTile / 16; ++step)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mx = fmaxf(mx, fmaxf(sc[step][j][2 * r], sc[step][j][2 * r + 1]));
      if constexpr (!kF32) {
        // all columns so far may be past S: then the maximum is still -inf
        const float mc = mx == -INFINITY ? 0.0f : mx * c;
        float sum = l[r] * exp2_approx(m[r] * c - mc);
#pragma unroll
        for (int step = 0; step < kKeyTile / 16; ++step)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            sum += exp2_approx(fmaf(sc[step][j][2 * r], c, -mc)) +
                   exp2_approx(fmaf(sc[step][j][2 * r + 1], c, -mc));
        l[r] = sum;
      }
      m[r] = mx;
    }
  }
  // the four threads of a row agree on its maximum and add up their sums
  float mc[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mc[r] = mx * c;  // finite: column 0 is a key
    float sum = l[r] * exp2_approx(m[r] * c - mc[r]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.0f / sum;
    l[r] = 0.0f;
  }

  // pass 2: probabilities in registers, times V. bfloat16 rounds the
  // normalised probabilities, as the Pallas body does; float32 has no
  // rounding to reproduce, so it sums exp2 as it goes and divides at the end
  float acc[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.0f;
  for (int k0 = 0; k0 < s; k0 += kKeyTile) {
    __syncthreads();
    knext.commit(ksm, W::ldk);
    vnext.commit(vsm, W::ldv);
    __syncthreads();
    const int k1 = k0 + kKeyTile;
    if (k1 < s) {
      knext.fetch(kbase + (int64_t)k1 * st.ks, st.ks, min(kKeyTile, s - k1));
      vnext.fetch(vbase + (int64_t)k1 * st.vs, st.vs, min(kKeyTile, s - k1));
    }
    if (!live) continue;
    float part[4][4];  // this key tile's p v (float32 only)
    if constexpr (kF32) {
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[d][i] = 0.0f;
    }
#pragma unroll
    for (int step = 0; step < kKeyTile / 16; ++step) {
      float p[2][4];
      w.scores(p, ksm, step * 16, g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float e = exp2_approx(fmaf(p[j][i], c, -mc[i >> 1]));
          if (k0 + kKeyTile > s &&
              k0 + step * 16 + j * 8 + 2 * t + (i & 1) >= s)
            e = 0.0f;
          if constexpr (kF32) {
            l[i >> 1] += e;
            p[j][i] = e;
          } else {
            p[j][i] = e * inv[i >> 1];
          }
        }
      if constexpr (kF32)
        w.pv(part, p, vsm, step * 16, g, t);
      else
        w.pv(acc, p, vsm, step * 16, g, t);
    }
    if constexpr (kF32) {
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[d][i] += part[d][i];
    }
  }
  if (!live) return;

  float norm[2] = {1.0f, 1.0f};
  if constexpr (kF32) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      norm[r] = 1.0f / sum;
    }
  }
  T* obase = out + b * st.ob + (int64_t)row0 * st.ol + hh * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + g + 8 * r >= lq) continue;
    W::store_out(obase + (int64_t)(g + 8 * r) * st.ol, acc, r, norm[r], t);
  }
}

template <typename T, int kWarps>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* out,
                        int b, int lq, int s, int h, const Strides& st,
                        float scale, cudaStream_t stream) {
  const int rows = kWarps * 16;
  const int row_tiles = (lq + rows - 1) / rows;
  const int64_t blocks = (int64_t)b * h * row_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  attention_kernel_tile<T, kWarps><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lq, s, h, row_tiles, st,
      scale);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------- row kernel

template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
  x = kMax ? warp_max(x) : warp_sum(x);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kRowThreads / 32; ++w)
    r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch is free again
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
attention_kernel_row(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int lq,
                     int s, int h, Strides st, float scale) {
  constexpr int n = Vec<T>::n;
  constexpr int lanes = kHeadDim / n;           // threads across one row
  constexpr int groups = kRowThreads / lanes;   // key groups in p v
  extern __shared__ __align__(16) float shared[];
  float* probs = shared;                        // s logits, then probabilities
  float* partial = shared + (s + 3) / 4 * 4;    // groups x kHeadDim
  float* scratch = partial + groups * kHeadDim;  // one float a warp

  const int row = blockIdx.x % lq;
  const int bh = blockIdx.x / lq;
  const int hh = bh % h;
  const int b = bh / h;
  const T* qrow = q + b * st.qb + (int64_t)row * st.ql + hh * st.qh;
  const T* kbase = k + b * st.kb + hh * st.kh;
  const T* vbase = v + b * st.vb + hh * st.vh;

  float qr[kHeadDim];
#pragma unroll
  for (int c = 0; c < kHeadDim; c += n) {
    float x[n];
    load16(qrow + c, x);
#pragma unroll
    for (int i = 0; i < n; ++i) qr[c + i] = x[i] * scale;
  }

  // logits: a thread to a key, the whole key row in 16-byte loads
  float m = -INFINITY;
  for (int j = threadIdx.x; j < s; j += kRowThreads) {
    const T* krow = kbase + (int64_t)j * st.ks;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kHeadDim; c += n) {
      float x[n];
      load16(krow + c, x);
#pragma unroll
      for (int i = 0; i < n; ++i) acc = fmaf(qr[c + i], x[i], acc);
    }
    probs[j] = acc;
    m = fmaxf(m, acc);
  }
  m = block_reduce<true>(m, scratch);
  float l = 0.0f;
  for (int j = threadIdx.x; j < s; j += kRowThreads) {
    const float e = expf(probs[j] - m);
    probs[j] = e;
    l += e;
  }
  l = block_reduce<false>(l, scratch);
  const T tag{};
  for (int j = threadIdx.x; j < s; j += kRowThreads)
    probs[j] = round_prob(probs[j] / l, tag);
  __syncthreads();

  // p v: `lanes` threads across a value row, `groups` keys at a time
  const int c = (threadIdx.x % lanes) * n;
  const int g = threadIdx.x / lanes;
  float acc[n];
#pragma unroll
  for (int i = 0; i < n; ++i) acc[i] = 0.0f;
  for (int j = g; j < s; j += groups) {
    const float p = probs[j];
    float x[n];
    load16(vbase + (int64_t)j * st.vs + c, x);
#pragma unroll
    for (int i = 0; i < n; ++i) acc[i] = fmaf(p, x[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) partial[g * kHeadDim + c + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < lanes) {
    float x[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float sum = 0.0f;
      for (int gg = 0; gg < groups; ++gg) sum += partial[gg * kHeadDim + c + i];
      x[i] = sum;
    }
    store16(out + b * st.ob + (int64_t)row * st.ol + hh * st.oh + c, x);
  }
}

template <typename T>
cudaError_t launch_row(const void* q, const void* k, const void* v, void* out,
                       int b, int lq, int s, int h, const Strides& st,
                       float scale, cudaStream_t stream) {
  if (s > kRowMaxKeys) return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)b * h * lq;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  constexpr int groups = kRowThreads / (kHeadDim / Vec<T>::n);
  const int bytes = ((s + 3) / 4 * 4 + groups * kHeadDim + 32) * (int)sizeof(float);
  attention_kernel_row<T><<<(unsigned)blocks, kRowThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lq, s, h, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int lq, int s, int h, const Strides& st, float scale,
                   int tile_rows, cudaStream_t stream) {
  if (tile_rows == 0)
    return launch_row<T>(q, k, v, out, b, lq, s, h, st, scale, stream);
  if (tile_rows == 64)
    return launch_tile<T, 4>(q, k, v, out, b, lq, s, h, st, scale, stream);
  if (tile_rows == 128)
    return launch_tile<T, 8>(q, k, v, out, b, lq, s, h, st, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (in elements) are the batch,
// length and head strides of q, k, v and out, in that order; the last
// dimension must be contiguous, and every pointer and stride must allow
// 16-byte loads. scale is 1/sqrt(hd), rounded to float by the caller exactly
// as the reference rounds it. tile_rows: 0 launches the row kernel, 64 or 128
// the tile kernel with that many query rows a block. Returns the CUDA error of the launch,
// or cudaErrorInvalidValue for a shape these kernels do not take.
int cotr_flash_attention(const void* q, const void* k, const void* v,
                         void* out, int b, int lq, int s, int h, int hd,
                         int dtype, const int64_t* strides, float scale,
                         int tile_rows, void* stream) {
  if (b < 1 || h < 1 || lq < 1 || s < 1 || hd != kHeadDim)
    return (int)cudaErrorInvalidValue;
  Strides st;
  st.qb = strides[0]; st.ql = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.ol = strides[10]; st.oh = strides[11];
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, b, lq, s, h, st, scale, tile_rows,
                              cs);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, b, lq, s, h, st, scale,
                                      tile_rows, cs);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
