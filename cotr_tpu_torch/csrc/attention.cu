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
// Three kernels, chosen by the wrapper from Lq and the dtype.
//
// attention_kernel_tile_bf16 (bfloat16, Lq above 3: the encoders, Lq = 512,
// the dense decode, Lq = 8,192 a chunk, the squad decodes). What bounds it
// on this card is the largest of three floors: the bytes (q, k, v read
// once, out written once: 0.080 ms at (B, Lq) = (256, 512)); the two
// products (128 tensor-core operations a logit at hd = 32: 0.035 ms at
// (8, 8192)); and the exponentials: an SM evaluates 16 a clock, so one exp
// a logit costs 0.064 ms at (8, 8192) on 132 SMs at 1.98 GHz, more than the
// products, and two a logit would double that. What the design does:
//   * one exp a logit for S up to 512, the S of every main path: a block of
//     two warpgroups holds a head's K and V (up to 512 keys, 64 KB) in
//     shared memory, and each warpgroup computes the fp32 logits of 64 query
//     rows against its 256 of the keys and keeps them in registers, 128 a
//     thread. It takes them as two halves of 128 keys (wgmma m64n128k16, q
//     and K read from shared memory) and exponentiates the first half
//     against that half's own maximum while the tensor cores compute the
//     second. The four halves' maxima and sums meet in one exchange through
//     shared memory, which gives the row's maximum m and sum l before the
//     first probability is formed, and each half's factor 2^(m_h - m) / l.
//     The normalised probabilities e * factor are rounded to bf16, as the
//     Pallas body rounds them, straight into the A fragments of p v (wgmma
//     m64n32k16, A from registers, V from shared memory as a transposed B);
//     the first half's p v runs while the second half's probabilities are
//     packed, and the two warpgroups' partial outputs are added in fp32
//     through shared memory;
//   * K, V and q are staged with cp.async, 16 bytes a thread, into the
//     64-byte swizzled layout that the wgmma descriptors read. A block walks
//     an even share of the (b, h, row tile) sequence, one block an SM, and
//     stages the next step's q (and, at a new head, its K and V into the
//     other buffer) while it computes this one;
//   * the logits are scaled after the product: q / sqrt(32) is not a bf16
//     number. Keys past S are zero-filled and get probability 0; rows past
//     Lq are computed on zeros and never stored;
//   * S above 512 (no main path): the same kernel walks the keys in chunks
//     of 512 twice, for each row's maximum and sum (rescaled chunk by
//     chunk), then for the probabilities: two exps a logit there.
// What sets its pace as built (profile_attention.py, SM clocks of a 64-row
// tile on the H100, about 6,000 at (8, 8192)): its phases follow each other
// behind two barriers, since a tile's fp32 logits fill the registers and no
// second tile can be in flight. The maxima and exps take about 2,800 (the
// exps' floor at 16 a clock: 2,048), the factors and the packing to bf16
// about 1,550, the first half's q k^T about 400, the partial outputs' sum
// and store about 500, and the step's staging and wait about 420.
// tile_rows (64 or 128) is the query rows a block takes a step: one or two
// wgmma tiles of 64 rows against the staged keys.
//
// attention_kernel_tile (float32, Lq above 3). What bounds it: the
// products. float32 keeps seven digits on TF32 tensor cores by splitting
// every operand, and its three TF32 products cost six times the
// tensor-core time of one bf16 product. What the design does:
//   * a warp owns 16 query rows, 4 or 8 warps a block share the K and V
//     tiles (64 keys) that stream through shared memory, fetched into
//     registers one tile ahead;
//   * both products run on the tensor cores (mma.sync), and the logits and
//     probabilities never leave the registers: the accumulator tiles of
//     q k^T are, after the exp, the A operand of p v (WarpTile);
//   * two passes over the keys instead of an online rescaled sum: pass 1
//     places each row's maximum from one TF32 product, pass 2 recomputes
//     the logits, sums exp2 as it goes, multiplies with V and divides at
//     the end (float32 has no rounding of the probabilities to reproduce);
//   * the split: every operand becomes hi = tf32(x) and lo = tf32(x - hi),
//     and the three products lo*hi, hi*lo, hi*hi are summed small terms
//     first. One TF32 product alone errs by 1e-3. The tensor cores add into
//     their accumulator with truncation, so long sums are cut into key tiles
//     whose partial sums are added on the fp32 pipes;
//   * keys past S are zero-filled and get probability 0; rows past Lq are
//     computed on zeros and never stored; any S is taken.
// Its template keeps the branches of the bfloat16 mma.sync kernel that
// attention_kernel_tile_bf16 replaced; only float32 instantiates it.
// Deleting them (float32's machine code stays as it is) is the first step
// of the float32 redesign.
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

// ------------------------------------------- bfloat16 tile kernel (wgmma)

constexpr int kWgThreads = 128;                  // a warpgroup
constexpr int kWgs = 2;                          // warpgroups a block
constexpr int kWgKeys = 256;                     // keys a warpgroup holds
constexpr int kOnChipKeys = kWgs * kWgKeys;      // keys a block holds: 512
constexpr int kLogits = kWgKeys / 2;             // logits a thread holds
constexpr int kHalf = kLogits / 2;               // of them, a half's: 64
constexpr int kPvSteps = kWgKeys / 16;           // k16 steps of p v
constexpr int kWgmmaRows = 64;                   // query rows of one wgmma tile
constexpr int kRowBytes = kHeadDim * 2;          // one bf16 row of q, k or v
constexpr int kKeyBytes = kOnChipKeys * kRowBytes;  // K (or V) of 512 keys
constexpr int kPartLd = 40;  // floats a row of a partial output: float2
                             // stores of 8 rows free of bank conflicts

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// byte offset of 16-byte chunk c (0..3) of row r in a tile of 64-byte rows
// under the 64-byte swizzle (chunk bits 4-5 XOR address bits 7-8) that the
// descriptors below name; a tile starts 512-byte aligned
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return r * kRowBytes + ((c ^ ((r >> 1) & 3)) << 4);
}
// 16 bytes from global to shared memory, or 16 zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// this thread's copies but the last kPending groups landed and made visible
// to wgmma (the async proxy), then every thread's
template <int kPending>
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// wgmma shared-memory descriptor of a tile of 64-byte rows, 64-byte swizzle:
// start address >> 4 (bits 0-13), leading byte offset 16 (unused: one
// swizzle atom spans the whole k16 or n32 extent), stride byte offset 512
// (eight rows, from one core-matrix group to the next), layout 2 = B64
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most kPending committed groups of products are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending)
               : "memory");
}
// keep registers that an issued wgmma reads or writes where they are until
// it has completed: the compiler sees the asm statement, not the hardware
template <int n>
__device__ __forceinline__ void pin(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int n>
__device__ __forceinline__ void pin(uint32_t (&r)[n][4]) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (64 x 128, fp32) (+)= a (64 x 16) b (16 x 128), a and b bf16 in shared
// memory, both K-major (the head dimension contiguous). Thread x of the
// warpgroup holds rows 16 (x / 32) + (x % 32) / 4 and that + 8: d[4i],
// d[4i + 1] are columns 8i + 2 (x % 4) and + 1 of the first row, d[4i + 2],
// d[4i + 3] the same columns of the second.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 32, fp32) (+)= a (64 x 16, bf16 from registers) b (16 x 32, bf16 in
// shared memory, MN-major: the head dimension contiguous, so transposed).
// a's fragment is that of the m16n8k16 mma: a[0] = A(g, 2t..), a[1] =
// A(g + 8, 2t..), a[2] = A(g, 2t + 8..), a[3] = A(g + 8, 2t + 8..) of the
// warp's 16 rows; d is laid out as in wgmma_qk.
__device__ __forceinline__ void wgmma_pv(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ float quad_max(float x) {  // over a row's 4 threads
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
// the maximum of a row's first n entries
__device__ __forceinline__ float first_max(const float* at, int n) {
  float m = at[0];
  for (int w = 1; w < n; ++w) m = fmaxf(m, at[w]);
  return m;
}

// rows [0, rows) of one (batch, head) slice of q, k or v into a swizzled
// tile in shared memory, 16 bytes a copy; rows at or past `valid` are zeros
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int rows,
                                           int valid) {
  for (int i = threadIdx.x; i < rows * 4; i += kWgs * kWgThreads) {
    const int r = i >> 2;
    const int c = i & 3;
    const bool ok = r < valid;
    cp_async16(dst + sw64(r, c), ok ? src + r * stride + c * 8 : src, ok);
  }
}

// The block's shared memory, as byte offsets from its base, which is
// rounded up to 1,024 bytes (the swizzle reads address bits 7 and 8)
template <int kRows>
struct Bf16Layout {
  static constexpr int kv = 0;                            // 2 x (K, V)
  static constexpr int q = kv + 2 * 2 * kKeyBytes;        // 2 x q rows
  static constexpr int part = q + 2 * kRows * kRowBytes;  // partial outputs
  static constexpr int rmax = part + kWgs * kWgmmaRows * kPartLd * 4;
  static constexpr int rsum = rmax + kWgmmaRows * 2 * kWgs * 4;
  static constexpr int bytes = rsum + kWgmmaRows * 2 * kWgs * 4 + 1024;
};

// What a thread is within its block
struct Bf16Thread {
  int wg;     // warpgroup: it holds keys [256 wg, 256 wg + 256) of a chunk
  int r0;     // its rows of a 64-row tile: r0 and r0 + 8
  int t;      // lane % 4: its columns 8i + 2t and + 1 of each row
  float c;    // scale * log2(e): logits go through exp2
  float* part;
  float* rmax;  // 64 rows x 2 kWgs: the halves' row maxima
  float* rsum;  // and row sums
};

// A half of a thread's logits: sc[64 h .. 64 h + 63], the keys
// [128 h, 128 h + 128) of its warpgroup's, laid out as one accumulator of
// 64 x 128 (and the two halves side by side as one of 64 x 256)
template <int h>
__device__ __forceinline__ float (&half_of(float (&sc)[kLogits]))[kHalf] {
  return *reinterpret_cast<float(*)[kHalf]>(sc + h * kHalf);
}
// Issue (not wait for) the logits of a 64-row tile (q at qa) against one
// half of this warpgroup's keys of the staged chunk (K at ka), as a group of
// products of its own.
template <int h>
__device__ __forceinline__ void bf16_qk(float (&sc)[kLogits], uint32_t qa,
                                        uint32_t ka, const Bf16Thread& th) {
  const uint32_t kw = ka + (th.wg * kWgKeys + h * kWgKeys / 2) * kRowBytes;
  wgmma_fence();
  wgmma_qk(half_of<h>(sc), desc_sw64(qa), desc_sw64(kw), 0);  // dims 0-15
  wgmma_qk(half_of<h>(sc), desc_sw64(qa + 32), desc_sw64(kw + 32), 1);
  wgmma_commit();
}
// Issue o (+)= p v over one half of this warpgroup's keys (the first half
// overwrites o unless accumulate), V's rows at va. An accumulator tile's
// columns 2t, 2t + 1 of rows g and g + 8, two tiles side by side, are the A
// fragment of a k16 step, so p comes straight from the logits' registers.
template <int h>
__device__ __forceinline__ void bf16_pv(float (&o)[16],
                                        uint32_t (&p)[kPvSteps][4],
                                        uint32_t va, bool accumulate,
                                        const Bf16Thread& th) {
  const uint32_t vw = va + th.wg * kWgKeys * kRowBytes;
  wgmma_fence();
#pragma unroll
  for (int j = h * kPvSteps / 2; j < (h + 1) * kPvSteps / 2; ++j)
    wgmma_pv(o, p[j], desc_sw64(vw + j * 16 * kRowBytes), accumulate || j);
  wgmma_commit();
}
// keys at or past `keys` (of the chunk) get the logit -inf, in half h
template <int h>
__device__ __forceinline__ void bf16_mask(float (&sc)[kLogits], int keys,
                                          const Bf16Thread& th) {
  const int key0 = th.wg * kWgKeys + h * kWgKeys / 2;
  if (key0 + kWgKeys / 2 <= keys) return;
#pragma unroll
  for (int i = h * kHalf; i < (h + 1) * kHalf; ++i)
    if (th.wg * kWgKeys + 8 * (i / 4) + 2 * th.t + (i & 1) >= keys)
      sc[i] = -INFINITY;
}
// the two rows' maxima over half h, from m0 and m1 on
template <int h>
__device__ __forceinline__ void bf16_max(const float (&sc)[kLogits],
                                         float& m0, float& m1) {
#pragma unroll
  for (int i = h * kHalf / 4; i < (h + 1) * kHalf / 4; ++i) {
    m0 = fmaxf(m0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    m1 = fmaxf(m1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}
// e = 2^(logit c - mc) of each row in half h in place: the one
// exponential a logit; the rows' sums of e over the half
template <int h>
__device__ __forceinline__ void bf16_exp(float (&sc)[kLogits], float c,
                                         float mc0, float mc1, float& l0,
                                         float& l1) {
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int i = h * kHalf / 4; i < (h + 1) * kHalf / 4; ++i) {
    sc[4 * i] = exp2_approx(fmaf(sc[4 * i], c, -mc0));
    sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], c, -mc0));
    sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], c, -mc1));
    sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], c, -mc1));
    a += sc[4 * i] + sc[4 * i + 1];
    b += sc[4 * i + 2] + sc[4 * i + 3];
  }
  l0 = quad_sum(a);
  l1 = quad_sum(b);
}
// the probabilities e * f of each row in half h, rounded to bf16, as the A
// fragments of p v
template <int h>
__device__ __forceinline__ void bf16_pack(uint32_t (&p)[kPvSteps][4],
                                          const float (&e)[kLogits],
                                          float f0, float f1) {
#pragma unroll
  for (int j = h * kPvSteps / 2; j < (h + 1) * kPvSteps / 2; ++j) {
    p[j][0] = pack_bf16(e[8 * j] * f0, e[8 * j + 1] * f0);
    p[j][1] = pack_bf16(e[8 * j + 2] * f1, e[8 * j + 3] * f1);
    p[j][2] = pack_bf16(e[8 * j + 4] * f0, e[8 * j + 5] * f0);
    p[j][3] = pack_bf16(e[8 * j + 6] * f1, e[8 * j + 7] * f1);
  }
}
// m c, or 0 where m is -inf (a half whose keys are all past S), so that the
// half's exponentials come out 2^-inf = 0 and not NaN
__device__ __forceinline__ float max_c(float m, float c) {
  return m == -INFINITY ? 0.0f : m * c;
}

// this warpgroup's o into its partial tile
__device__ __forceinline__ void bf16_part(const float (&o)[16],
                                          const Bf16Thread& th) {
  float* at = th.part + (th.wg * kWgmmaRows + th.r0) * kPartLd + 2 * th.t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float2*>(at + 8 * i) = make_float2(o[4 * i], o[4 * i + 1]);
    *reinterpret_cast<float2*>(at + 8 * kPartLd + 8 * i) =
        make_float2(o[4 * i + 2], o[4 * i + 3]);
  }
}

// the first n warpgroups' partial tiles added in fp32 (after a barrier),
// rows below `rows` rounded to bf16 and stored, 8 values (16 bytes) a thread
__device__ __forceinline__ void bf16_store(__nv_bfloat16* out, int64_t ol,
                                           int rows, int n,
                                           const Bf16Thread& th) {
  static_assert(kWgmmaRows * kHeadDim == 8 * kWgs * kWgThreads,
                "a thread stores 8 values");
  const int r = threadIdx.x / 4;
  const int c = threadIdx.x % 4 * 8;
  if (r >= rows) return;
  const float* at = th.part + r * kPartLd + c;
  float4 lo = *reinterpret_cast<const float4*>(at);
  float4 hi = *reinterpret_cast<const float4*>(at + 4);
  for (int w = 1; w < n; ++w) {
    const float* x = at + w * kWgmmaRows * kPartLd;
    const float4 xl = *reinterpret_cast<const float4*>(x);
    const float4 xh = *reinterpret_cast<const float4*>(x + 4);
    lo.x += xl.x; lo.y += xl.y; lo.z += xl.z; lo.w += xl.w;
    hi.x += xh.x; hi.y += xh.y; hi.z += xh.z; hi.w += xh.w;
  }
  *reinterpret_cast<uint4*>(out + r * ol + c) =
      make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                 pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
}

// Phase clocks: profile_attention.py builds this file with
// COTR_PROFILE_PHASES defined and its own definitions of these, which read
// clock64() at the phase boundaries of bf16_tile_staged and of the bfloat16
// kernel's step loop. In every other build they are empty.
#ifndef COTR_PROFILE_PHASES
#define PHASE_CLOCK_START()
#define PHASE_CLOCK(i)
#define PHASE_CLOCKS_CLEAR()
#define PHASE_CLOCKS_WRITE()
#endif

// One 64-row tile whose keys, at most 512, are all staged: each logit is
// exponentiated once. A warpgroup's keys go in two halves of 128, each with
// its own maximum, so that the second half's q k^T runs on the tensor cores
// while the first half's exps are taken; the four halves' maxima and sums
// meet in one exchange, which gives each half's factor 2^(its max - the
// row's max) / the row's sum. The first half's p v runs while the second
// half's probabilities are packed. Two barriers: the halves' maxima and
// sums, the partial outputs.
__device__ __forceinline__ void bf16_tile_staged(uint32_t qa, uint32_t ka,
                                                 uint32_t va, int keys,
                                                 __nv_bfloat16* out,
                                                 int64_t ol, int rows,
                                                 const Bf16Thread& th) {
  constexpr int kHalves = 2 * kWgs;  // a row's
  static_assert(kHalves == 4, "a row's halves are read as a float4");
  const int n = (keys + kWgKeys - 1) / kWgKeys;  // warpgroups holding keys
  const bool live = th.wg < n;
  float sc[kLogits];
  PHASE_CLOCK_START();
  if (live) {
    bf16_qk<0>(sc, qa, ka, th);
    bf16_qk<1>(sc, qa, ka, th);
    float m[2][2], l[2][2];  // [half][row]
    wgmma_wait<1>();
    pin(half_of<0>(sc));
    PHASE_CLOCK(0);
    bf16_mask<0>(sc, keys, th);
    m[0][0] = m[0][1] = -INFINITY;
    bf16_max<0>(sc, m[0][0], m[0][1]);
    bf16_exp<0>(sc, th.c, max_c(m[0][0], th.c), max_c(m[0][1], th.c),
                l[0][0], l[0][1]);
    PHASE_CLOCK(1);
    wgmma_wait<0>();
    pin(half_of<1>(sc));
    PHASE_CLOCK(2);
    bf16_mask<1>(sc, keys, th);
    m[1][0] = m[1][1] = -INFINITY;
    bf16_max<1>(sc, m[1][0], m[1][1]);
    bf16_exp<1>(sc, th.c, max_c(m[1][0], th.c), max_c(m[1][1], th.c),
                l[1][0], l[1][1]);
    if (th.t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          th.rmax[(th.r0 + 8 * r) * kHalves + 2 * th.wg + hh] = m[hh][r];
          th.rsum[(th.r0 + 8 * r) * kHalves + 2 * th.wg + hh] = l[hh][r];
        }
    }
  }
  PHASE_CLOCK(3);
  __syncthreads();
  PHASE_CLOCK(4);
  if (live) {
    // each row's maximum over the halves held (finite: key 0 is a key of
    // every row), its sum, and this warpgroup's halves' factors
    float f[2][2];  // [half][row]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (th.r0 + 8 * r) * kHalves;
      const float4 mh = *reinterpret_cast<const float4*>(th.rmax + at);
      const float4 lh = *reinterpret_cast<const float4*>(th.rsum + at);
      // a warpgroup past S wrote nothing: its halves count as -inf and 0
      const bool two = n > 1;
      const float m = fmaxf(fmaxf(mh.x, mh.y),
                            two ? fmaxf(mh.z, mh.w) : -INFINITY);
      const float g0 = exp2_approx((mh.x - m) * th.c);
      const float g1 = exp2_approx((mh.y - m) * th.c);
      const float g2 = two ? exp2_approx((mh.z - m) * th.c) : 0.0f;
      const float g3 = two ? exp2_approx((mh.w - m) * th.c) : 0.0f;
      const float inv = 1.0f / ((lh.x * g0 + lh.y * g1) +
                                (two ? lh.z * g2 + lh.w * g3 : 0.0f));
      f[0][r] = (th.wg == 0 ? g0 : g2) * inv;
      f[1][r] = (th.wg == 0 ? g1 : g3) * inv;
    }
    PHASE_CLOCK(5);
    uint32_t p[kPvSteps][4];
    float o[16];
    bf16_pack<0>(p, sc, f[0][0], f[0][1]);
    bf16_pv<0>(o, p, va, false, th);
    bf16_pack<1>(p, sc, f[1][0], f[1][1]);
    bf16_pv<1>(o, p, va, true, th);
    PHASE_CLOCK(6);
    wgmma_wait<0>();
    pin(o);
    pin(p);
    PHASE_CLOCK(7);
    bf16_part(o, th);
    PHASE_CLOCK(8);
  }
  __syncthreads();
  PHASE_CLOCK(9);
  bf16_store(out, ol, rows, n, th);
  PHASE_CLOCK(10);
}

// One 64-row tile against more keys than a block holds: pass 1 walks the
// chunks of 512 keys for each row's maximum and sum over each warpgroup's
// keys, rescaling the sum as the maximum grows; pass 2 walks them again for
// the probabilities and p v (two exponentials a logit). The chunks go
// through buffer 0 (K at ka, V at va).
__device__ __forceinline__ void bf16_tile_streamed(
    uint32_t qa, uint32_t ka, uint32_t va, const __nv_bfloat16* kbase,
    int64_t ks, const __nv_bfloat16* vbase, int64_t vs, int s,
    __nv_bfloat16* out, int64_t ol, int rows, const Bf16Thread& th) {
  const int key0 = th.wg * kWgKeys;
  float* mrow = th.rmax + th.r0 * 2 * kWgs;
  float* lrow = th.rsum + th.r0 * 2 * kWgs;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float sc[kLogits];
  for (int k0 = 0; k0 < s; k0 += kOnChipKeys) {
    const int keys = min(kOnChipKeys, s - k0);
    const int staged = (keys + kWgKeys - 1) / kWgKeys * kWgKeys;
    __syncthreads();  // the chunk before is read
    stage_rows(ka, kbase + k0 * ks, ks, staged, keys);
    cp_async_commit();
    copies_landed<0>();
    if (key0 >= keys) continue;
    bf16_qk<0>(sc, qa, ka, th);
    bf16_qk<1>(sc, qa, ka, th);
    wgmma_wait<0>();
    pin(sc);
    bf16_mask<0>(sc, keys, th);
    bf16_mask<1>(sc, keys, th);
    float x0 = m0, x1 = m1;
    bf16_max<0>(sc, x0, x1);  // finite: key0 is a key
    bf16_max<1>(sc, x0, x1);
    float a0, a1, b0, b1;
    bf16_exp<0>(sc, th.c, x0 * th.c, x1 * th.c, a0, a1);
    bf16_exp<1>(sc, th.c, x0 * th.c, x1 * th.c, b0, b1);
    l0 = l0 * exp2_approx((m0 - x0) * th.c) + (a0 + b0);  // 0 at the first
    l1 = l1 * exp2_approx((m1 - x1) * th.c) + (a1 + b1);
    m0 = x0;
    m1 = x1;
  }
  if (th.t == 0) {
    mrow[th.wg] = m0;
    mrow[16 * kWgs + th.wg] = m1;
    lrow[th.wg] = l0;
    lrow[16 * kWgs + th.wg] = l1;
  }
  __syncthreads();
  // every warpgroup holds keys of the first chunk, which is whole
  const float mx0 = first_max(mrow, kWgs);
  const float mx1 = first_max(mrow + 16 * kWgs, kWgs);
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int w = 0; w < kWgs; ++w) {
    sum0 += lrow[w] * exp2_approx((mrow[w] - mx0) * th.c);
    sum1 += lrow[16 * kWgs + w] *
            exp2_approx((mrow[16 * kWgs + w] - mx1) * th.c);
  }
  const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
  float o[16];  // the first chunk's product overwrites it
  uint32_t p[kPvSteps][4];
  for (int k0 = 0; k0 < s; k0 += kOnChipKeys) {
    const int keys = min(kOnChipKeys, s - k0);
    const int staged = (keys + kWgKeys - 1) / kWgKeys * kWgKeys;
    __syncthreads();
    stage_rows(ka, kbase + k0 * ks, ks, staged, keys);
    stage_rows(va, vbase + k0 * vs, vs, staged, keys);
    cp_async_commit();
    copies_landed<0>();
    if (key0 >= keys) continue;
    bf16_qk<0>(sc, qa, ka, th);
    bf16_qk<1>(sc, qa, ka, th);
    wgmma_wait<0>();
    pin(sc);
    bf16_mask<0>(sc, keys, th);
    bf16_mask<1>(sc, keys, th);
    float a0, a1;
    bf16_exp<0>(sc, th.c, mx0 * th.c, mx1 * th.c, a0, a1);
    bf16_exp<1>(sc, th.c, mx0 * th.c, mx1 * th.c, a0, a1);
    bf16_pack<0>(p, sc, inv0, inv1);
    bf16_pack<1>(p, sc, inv0, inv1);
    bf16_pv<0>(o, p, va, k0 > 0, th);
    bf16_pv<1>(o, p, va, true, th);
    wgmma_wait<0>();
    pin(o);
    pin(p);
  }
  bf16_part(o, th);
  __syncthreads();
  bf16_store(out, ol, rows, kWgs, th);
}

// Two warpgroups a block, one block an SM. The block walks the tiles
// [first, last) of the sequence (batch, head, row tile of kRows rows), each
// kRows / 64 wgmma tiles of 64 rows.
template <int kRows>
__global__ void __launch_bounds__(kWgs * kWgThreads, 1)
attention_kernel_tile_bf16(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int lq, int s,
                           int h, int row_tiles, int tiles, Strides st,
                           float scale) {
  using L = Bf16Layout<kRows>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  Bf16Thread th;
  th.wg = threadIdx.x / kWgThreads;
  th.r0 = threadIdx.x % kWgThreads / 32 * 16 + threadIdx.x % 32 / 4;
  th.t = threadIdx.x % 4;
  th.c = scale * kLog2e;
  th.part = reinterpret_cast<float*>(base + L::part);
  th.rmax = reinterpret_cast<float*>(base + L::rmax);
  th.rsum = reinterpret_cast<float*>(base + L::rsum);
  PHASE_CLOCKS_CLEAR();

  const int share = tiles / gridDim.x, extra = tiles % gridDim.x;
  const int first = blockIdx.x * share + min((int)blockIdx.x, extra);
  const int last = first + share + ((int)blockIdx.x < extra);
  if (first >= last) return;
  // tile j: its first row and pointers
  struct Tile {
    int row0;
    const __nv_bfloat16 *q, *k, *v;
    __nv_bfloat16* out;
  };
  auto tile_at = [&](int j) {
    Tile x;
    const int bh = j / row_tiles;
    x.row0 = j % row_tiles * kRows;
    const int64_t b = bh / h, hh = bh % h;
    x.q = q + b * st.qb + x.row0 * st.ql + hh * st.qh;
    x.k = k + b * st.kb + hh * st.kh;
    x.v = v + b * st.vb + hh * st.vh;
    x.out = out + b * st.ob + x.row0 * st.ol + hh * st.oh;
    return x;
  };
  // q buffer i at q_buf(i); K of buffer i at k_buf(i), its V kKeyBytes on
  auto q_buf = [&](int i) { return sb + L::q + i * kRows * kRowBytes; };
  auto k_buf = [&](int i) { return sb + L::kv + i * 2 * kKeyBytes; };

  if (s > kOnChipKeys) {
    for (int j = first; j < last; ++j) {
      const Tile x = tile_at(j);
      // the tile before read its q before its final barrier; the first
      // chunk's wait covers it
      stage_rows(q_buf(0), x.q, st.ql, kRows, lq - x.row0);
      for (int sub = 0; sub * kWgmmaRows < min(kRows, lq - x.row0); ++sub)
        bf16_tile_streamed(q_buf(0) + sub * kWgmmaRows * kRowBytes, k_buf(0),
                           k_buf(0) + kKeyBytes, x.k, st.ks, x.v, st.vs, s,
                           x.out + sub * kWgmmaRows * st.ol, st.ol,
                           lq - x.row0 - sub * kWgmmaRows, th);
    }
    return;
  }

  // All keys staged: K and V once a head, into the buffer the head before
  // did not use, and each step's q, one step ahead
  const int staged = (s + kWgKeys - 1) / kWgKeys * kWgKeys;
  auto stage = [&](int j, int qb, int kb, bool with_keys) {
    const Tile x = tile_at(j);
    stage_rows(q_buf(qb), x.q, st.ql, kRows, lq - x.row0);
    if (with_keys) {
      stage_rows(k_buf(kb), x.k, st.ks, staged, s);
      stage_rows(k_buf(kb) + kKeyBytes, x.v, st.vs, staged, s);
    }
    cp_async_commit();
  };
  stage(first, 0, 0, true);
  int kb = 0;
  for (int j = first; j < last; ++j) {
    const int qb = (j - first) & 1;
    const bool more = j + 1 < last;
    const bool new_head = more && (j + 1) % row_tiles == 0;
    // the buffers written here were last read before the step before's
    // final barrier
    PHASE_CLOCK_START();
    if (more)
      stage(j + 1, qb ^ 1, kb ^ 1, new_head);
    else
      cp_async_commit();
    copies_landed<1>();
    PHASE_CLOCK(11);
    const Tile x = tile_at(j);
    for (int sub = 0; sub * kWgmmaRows < min(kRows, lq - x.row0); ++sub)
      bf16_tile_staged(q_buf(qb) + sub * kWgmmaRows * kRowBytes, k_buf(kb),
                       k_buf(kb) + kKeyBytes, s,
                       x.out + sub * kWgmmaRows * st.ol, st.ol,
                       lq - x.row0 - sub * kWgmmaRows, th);
    if (new_head) kb ^= 1;
  }
  PHASE_CLOCKS_WRITE();
}

template <int kRows>
cudaError_t launch_tile_bf16(const void* q, const void* k, const void* v,
                             void* out, int b, int lq, int s, int h,
                             const Strides& st, float scale,
                             cudaStream_t stream) {
  constexpr int kBytes = Bf16Layout<kRows>::bytes;
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};  // 0: this device not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(attention_kernel_tile_bf16<kRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  const int row_tiles = (lq + kRows - 1) / kRows;
  const int64_t tiles = (int64_t)b * h * row_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(tiles < sms[dev] ? tiles : sms[dev]);
  attention_kernel_tile_bf16<kRows>
      <<<blocks, kWgs * kWgThreads, kBytes, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(out), lq, s, h, row_tiles, (int)tiles,
          st, scale);
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tile_rows == 64)
      return launch_tile_bf16<64>(q, k, v, out, b, lq, s, h, st, scale, stream);
    if (tile_rows == 128)
      return launch_tile_bf16<128>(q, k, v, out, b, lq, s, h, st, scale,
                                   stream);
  } else {
    if (tile_rows == 64)
      return launch_tile<T, 4>(q, k, v, out, b, lq, s, h, st, scale, stream);
    if (tile_rows == 128)
      return launch_tile<T, 8>(q, k, v, out, b, lq, s, h, st, scale, stream);
  }
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
