// Fused cross-attention for Hopper (sm_90a), exposed through a plain C entry
// point and called from cotr_tpu_torch/ops/attention.py over ctypes.
//
// Replaces: cotr_tpu/ops/pallas_attention.py:34-88, flash_cross_attention
// and its Pallas body _attn_kernel. Per (batch, head) it computes
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
// attention_kernel_tile_f32 (float32, Lq above 3: the same paths in float32,
// the engines', the demos' and the evaluation twin's default). What bounds
// it: the products. Float32 keeps seven digits on the TF32 tensor cores
// only with every operand split into hi = tf32(x) and lo = tf32(x - hi) and
// three products summed, lo*hi, hi*lo and hi*hi (hi*hi alone errs by
// 1e-3): 0.208 ms at (8, 8192) at 495 TFLOP/s, above the bytes (0.080 ms
// at (256, 512)) and the exponentials (0.064 ms at (8, 8192)). What the
// design does:
//   * three warpgroups a block, one block an SM, persistent over an even
//     share of the (batch, head, row tile) sequence. One stages: it walks
//     the block's keys in chunks of 64, loads a chunk of K and V (16 KB)
//     into registers a chunk ahead, splits each value and stores K hi, K lo
//     and V^T hi, V^T lo (V transposed on the way: TF32 wgmma reads both
//     operands K-major) under the 128-byte swizzle into a ring of 6 stages
//     of 32 KB, each signalled by an mbarrier. A head's split K and V (256
//     KB at 512 keys) do not fit a block's 227 KB; a pre-pass splitting
//     them once a call would write and read back twice their bytes (0.24 ms
//     at (256, 512)), where the ring reads a head's 128 KB from L2 again a
//     step of 128 rows (512 MB of L2 reads at (128, 512));
//   * two warpgroups compute, each on 64 query rows (128 rows a step), or
//     both on the same 64 rows, one the even and one the odd chunks, their
//     rows' maxima, sums and outputs merged through shared memory (64 rows
//     a step). q's hi and lo A fragments stay in registers, the next step's
//     q in flight. Per chunk: q k^T as 12 wgmma m64n64k8 in one chain,
//     small terms first; an online softmax, one exponential a logit, the
//     maxima, sums and outputs rescaled chunk by chunk (float32 has no
//     rounding of the probabilities to reproduce); the probabilities split
//     into hi and lo A fragments straight from the accumulator's registers
//     (V^T's keys lie in the order those registers give them); p v as 16
//     wgmma, p_lo v_hi then p_hi v_hi in one accumulator and p_hi v_lo in
//     another (m64n64k8 over V^T's hi and lo rows side by side), added to
//     the output on the fp32 pipes. The tensor cores truncate as they add,
//     so no chain is longer than one chunk's;
//   * the stager gives 64 registers a thread to the two that compute
//     (setmaxnreg: 104 and 200); the TF32 rounding is two integer
//     operations, where cvt.rna.tf32.f32 took longer;
//   * keys past S are zero-filled and get probability 0; rows past Lq are
//     computed on zeros and never stored; any S is taken.
// What sets its pace as built (profile_attention.py --dtype float32, SM
// clocks on the H100 at (8, 8192), 128 rows a step): a chunk takes a
// computing warpgroup about 4,000 clocks, where its products are 768 at the
// TF32 rate: its q k^T (about 900 with the wait), softmax (about 1,000)
// and p v (about 1,000) follow each other, and the two warpgroups' products
// share the tensor cores; the wait for a staged chunk about 500. The
// products themselves are not slow: chains of them from two warpgroups run
// at the TF32 peak (profile_attention.py --wgmma-rate), so the tensor cores
// are idle while a warpgroup's softmax runs and the other's has nothing
// queued. Tried and
// not kept, each slower: q k^T in 8 steps (m64n128k8 over K hi and lo side
// by side); the two warpgroups taking turns on the tensor cores (named
// barriers); each chunk's q k^T issued with the p v before it, the softmax
// under that p v (q from shared memory): ptxas serialized the wgmma and
// spilled at 208 registers.
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

// ------------------------------------------------ both tile kernels' helpers

constexpr float kLog2e = 1.4426950408889634f;

// to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds a finite x,
// in two integer operations: the conversion takes longer
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
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

// -------------------------------------------- float32 tile kernel (wgmma)

constexpr int kF32Keys = 64;          // keys a chunk
constexpr int kF32Consumers = 2;      // warpgroups that compute
constexpr int kF32Threads = (kF32Consumers + 1) * kWgThreads;  // + a stager
constexpr int kF32Stages = 6;         // chunks the ring holds
constexpr int kF32RowBytes = kHeadDim * 4;          // a float32 row of q, k, v
constexpr int kF32Piece = kF32Keys * kF32RowBytes;  // 8 KB: K hi, K lo,
                                                    // or half of V^T
constexpr int kF32Stage = 4 * kF32Piece;            // of a chunk: 32 KB
// registers a thread: a block starts with kF32LaunchRegs a thread, and the
// stager gives up what the two that compute take on (setmaxnreg waits until
// the registers it asks for are free)
constexpr int kF32LaunchRegs = 65536 / kF32Threads / 8 * 8;  // 168
constexpr int kF32ProducerRegs = 104;
constexpr int kF32ConsumerRegs = 200;
static_assert((kF32LaunchRegs - kF32ProducerRegs) >=
                  kF32Consumers * (kF32ConsumerRegs - kF32LaunchRegs),
              "the computing warpgroups take what the stager gives up");

// The block's shared memory, as byte offsets from its base, which is
// rounded up to 1,024 bytes (the swizzle reads address bits 7 to 9): the
// ring of staged chunks; at 64 rows a step the two warpgroups' outputs,
// row maxima and row sums, to be merged; the ring's mbarriers
struct F32Layout {
  static constexpr int ring = 0;
  static constexpr int part = ring + kF32Stages * kF32Stage;
  static constexpr int rmax = part + kF32Consumers * kWgmmaRows * kPartLd * 4;
  static constexpr int rsum = rmax + kF32Consumers * kWgmmaRows * 4;
  static constexpr int bars = rsum + kF32Consumers * kWgmmaRows * 4;
  static constexpr int bytes = bars + 2 * kF32Stages * 8 + 1024;
};
static_assert(F32Layout::bytes <= 232448, "a block's shared memory");

// A TF32 A fragment of wgmma (m64nNk8) from registers: a[i] is element
// (r + F32_A_ROW(i), F32_A_COL(i, t)) of the warp's 16 rows and the step's 8
// columns, r = lane / 4, t = lane % 4. An accumulator holds columns 2t and
// 2t + 1 of rows r and r + 8; F32_P(j, i) is the accumulator register that
// p v's step j takes as a[i], and F32_KEY(x) the key of a chunk that sits in
// column x of an 8-key group of V^T, so that the two agree.
#define F32_A_ROW(i) (8 * ((i) & 1))
#define F32_A_COL(i, t) ((t) + 4 * ((i) >> 1))
#define F32_P(j, i) (4 * (j) + (((i) & 1) << 1) + ((i) >> 1))
#define F32_KEY(x) (2 * ((x) & 3) + ((x) >> 2))

// d (64 x 64, fp32) (+)= a (64 x 8, TF32 from registers) b (8 x 64, TF32 in
// shared memory, K-major); d is laid out as in wgmma_qk
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
// d (64 x 32, fp32) (+)= a (64 x 8, TF32 from registers) b (8 x 32, TF32 in
// shared memory, K-major)
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
// byte offset of 16-byte chunk c (0..7) of row r in a tile of 128-byte rows
// under the 128-byte swizzle (chunk bits 4-6 XOR address bits 7-9) that
// desc_sw128 names; a tile starts 1,024-byte aligned
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * kF32RowBytes + ((c ^ (r & 7)) << 4);
}
// wgmma shared-memory descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzle: start address >> 4, leading byte offset 16 (unused: a k8 step's
// 32 bytes lie in one swizzle atom), stride byte offset 1,024 (eight rows),
// layout 1 = B128. A k8 step starts 32 bytes further into the rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// V^T's k8 step j (keys 8j .. 8j + 7 of the chunk): each half of the
// chunk's keys is a tile of 64 rows of 32 keys (128 bytes), the hi pieces'
// 32 dimensions, then the lo pieces'
__device__ __forceinline__ uint32_t vt_step(int j) {
  return (j >> 2) * kF32Piece + (j & 3) * 32;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               :: "r"(bar) : "memory");
}
// one arrival a warp, from lane 0, predicated rather than branched around:
// ptxas may serialize wgmma across a branch it cannot prove uniform
__device__ __forceinline__ void mbar_arrive_warp(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 st;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
      :: "r"(bar), "r"(threadIdx.x % 32) : "memory");
}
// until the phase of the given parity has completed; the loop inside one
// asm statement, for the same reason (CUTLASS's ClusterBarrier::wait)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}"
      :: "r"(bar), "r"(parity) : "memory");
}
// the consumer warpgroups alone
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kF32Consumers * kWgThreads)
               : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t addr,
                                            const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" :: "r"(addr),
               "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]) : "memory");
}

// one (batch, head, row tile) of the sequence the blocks share
struct F32Tile {
  int row0;
  const float *q, *k, *v;
  float* out;
};
__device__ __forceinline__ F32Tile f32_tile(int j, int rows, int row_tiles,
                                            int h, const float* q,
                                            const float* k, const float* v,
                                            float* out, const Strides& st) {
  F32Tile x;
  const int bh = j / row_tiles;
  x.row0 = j % row_tiles * rows;
  const int64_t b = bh / h, hh = bh % h;
  x.q = q + b * st.qb + x.row0 * st.ql + hh * st.qh;
  x.k = k + b * st.kb + hh * st.kh;
  x.v = v + b * st.vb + hh * st.vh;
  x.out = out + b * st.ob + x.row0 * st.ol + hh * st.oh;
  return x;
}

// The producer: one chunk of K and V in registers on its way to the ring,
// 16 bytes of four key rows and of four value rows a thread
struct F32Chunk {
  float4 k[4], v[4];
};
// keys [0, valid) of the chunk at kb, vb; zeros past them
__device__ __forceinline__ void f32_fetch(F32Chunk& x, const float* kb,
                                          int64_t ks, const float* vb,
                                          int64_t vs, int valid, int p) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = p + kWgThreads * u;  // key row i / 8, its 16 bytes i % 8
    x.k[u] = i / 8 < valid
                 ? *reinterpret_cast<const float4*>(kb + i / 8 * ks + i % 8 * 4)
                 : zero;
    // the keys whose values become columns 4 (p / 8 % 2) .. + 3 of the
    // 8-key group p / 16 of V^T, and their dimensions 4 (p % 8) .. + 3
    const int key = 8 * (p / 16) + F32_KEY(4 * (p / 8 % 2) + u);
    x.v[u] = key < valid
                 ? *reinterpret_cast<const float4*>(vb + key * vs + p % 8 * 4)
                 : zero;
  }
}
// the chunk split into TF32 hi and lo pieces, K as it is and V transposed,
// into ring stage `at`: K hi and K lo (64 key rows each), then V^T in two
// halves of 32 keys, each 32 hi and 32 lo dimension rows; 8 KB each
__device__ __forceinline__ void f32_put(const F32Chunk& x, uint32_t at, int p) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = p + kWgThreads * u;
    const uint32_t off = sw128(i / 8, i % 8);
    uint32_t hi[4], lo[4];
    split_tf32(x.k[u].x, hi[0], lo[0]);
    split_tf32(x.k[u].y, hi[1], lo[1]);
    split_tf32(x.k[u].z, hi[2], lo[2]);
    split_tf32(x.k[u].w, hi[3], lo[3]);
    st_shared16(at + off, hi);
    st_shared16(at + kF32Piece + off, lo);
  }
  const int g = p / 16;  // the 8-key group, in the chunk's half g / 4
  const uint32_t half = at + (2 + g / 4) * kF32Piece;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 4 * (p % 8) + e;
    const int c = 2 * (g % 4) + p / 8 % 2;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      split_tf32((&x.v[u].x)[e], hi[u], lo[u]);
    st_shared16(half + sw128(d, c), hi);
    st_shared16(half + sw128(kHeadDim + d, c), lo);
  }
}

// What a consumer thread is within its block
struct F32Thread {
  int wg;  // consumer warpgroup, 0 or 1
  int r0;  // its rows of a 64-row tile: r0 and r0 + 8
  int t;   // lane % 4: its columns 8i + 2t and + 1 of each row
  uint32_t ring, full, empty;
  float* part;
  float* rmax;
  float* rsum;
};

// this thread's elements of q's A fragments (four k8 steps) of a 64-row
// tile whose rows [0, rows) are rows of q; zeros past them
__device__ __forceinline__ void f32_fetch_q(float (&x)[4][4], const float* q,
                                            int64_t ql, int rows,
                                            const F32Thread& th) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = th.r0 + F32_A_ROW(i);
      x[ks][i] = r < rows ? q[r * ql + 8 * ks + F32_A_COL(i, th.t)] : 0.0f;
    }
}
// scaled in fp32 as the plain version scales q, split into TF32 hi and lo
__device__ __forceinline__ void f32_split_q(uint32_t (&qhi)[4][4],
                                            uint32_t (&qlo)[4][4],
                                            const float (&x)[4][4],
                                            float scale) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(x[ks][i] * scale, qhi[ks][i], qlo[ks][i]);
}
// the logits of a 64-row tile against a staged chunk: q k^T as three TF32
// products, lo*hi, hi*lo, hi*hi, small terms first, 12 k8 steps in one chain
__device__ __forceinline__ void f32_qk(float (&sc)[32], uint32_t (&qhi)[4][4],
                                       uint32_t (&qlo)[4][4], uint32_t at) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_tf32_n64(sc, qlo[ks], desc_sw128(at + 32 * ks), ks);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_tf32_n64(sc, qhi[ks], desc_sw128(at + kF32Piece + 32 * ks), 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_tf32_n64(sc, qhi[ks], desc_sw128(at + 32 * ks), 1);
  wgmma_commit();
  wgmma_wait<0>();
  pin(sc);
  pin(qhi);
  pin(qlo);
}
__device__ __forceinline__ float (&first16(float (&d)[32]))[16] {
  return *reinterpret_cast<float(*)[16]>(d);
}
// The online softmax of one chunk: keys at or past `keys` masked, the rows'
// running maxima m raised to the chunk's, the factors a = 2^((old m - m) c)
// by which the sums l and outputs so far shrink, e = 2^(logit c - m c) (one
// exponential a logit), l = l a + the chunk's sum of e, and e split into
// TF32 hi and lo A fragments of p v
__device__ __forceinline__ void f32_softmax(float (&sc)[32], int keys,
                                            float (&m)[2], float (&l)[2],
                                            float (&a)[2],
                                            uint32_t (&phi)[8][4],
                                            uint32_t (&plo)[8][4],
                                            const F32Thread& th) {
  if (keys < kF32Keys) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i / 4) + 2 * th.t + (i & 1) >= keys) sc[i] = -INFINITY;
  }
  float x0 = m[0], x1 = m[1];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x0 = fmaxf(x0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    x1 = fmaxf(x1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  // finite: key 0 of a chunk is a key; the first chunk's a is 2^-inf = 0
  x0 = quad_max(x0);
  x1 = quad_max(x1);
  a[0] = exp2_approx((m[0] - x0) * kLog2e);
  a[1] = exp2_approx((m[1] - x1) * kLog2e);
  m[0] = x0;
  m[1] = x1;
  const float mc0 = x0 * kLog2e, mc1 = x1 * kLog2e;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = F32_P(j, i);
      const bool second = at & 2;  // row r0 + 8
      const float e = exp2_approx(fmaf(sc[at], kLog2e, second ? -mc1 : -mc0));
      if (second)
        s1 += e;
      else
        s0 += e;
      split_tf32(e, phi[j][i], plo[j][i]);
    }
  l[0] = fmaf(l[0], a[0], s0);
  l[1] = fmaf(l[1], a[1], s1);
}
// o = o a + p v over the staged chunk: the chunk's product as three TF32
// products in two accumulators of their own, p_lo v_hi then p_hi v_hi in
// one (columns 0-31), p_hi v_lo in the other (32-63; V^T's hi and lo rows
// one after the other), added on the fp32 pipes: 16 wgmma
__device__ __forceinline__ void f32_pv(float (&o)[16], const float (&a)[2],
                                       uint32_t (&phi)[8][4],
                                       uint32_t (&plo)[8][4], uint32_t at) {
  float d[32];
  const uint32_t vt = at + 2 * kF32Piece;
#pragma unroll
  for (int i = 16; i < 32; ++i) d[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wgmma_tf32_n32(first16(d), plo[j], desc_sw128(vt + vt_step(j)), j);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wgmma_tf32_n64(d, phi[j], desc_sw128(vt + vt_step(j)), 1);
  wgmma_commit();
  wgmma_wait<0>();
  pin(d);
  pin(phi);
  pin(plo);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    o[i] = fmaf(o[i], a[(i >> 1) & 1], d[i] + d[16 + i]);
}

// The consumers: kSplitKeys (64 rows a step): both warpgroups take the
// step's 64 rows, warpgroup w the chunks c with c % 2 == w, and their
// maxima, sums and outputs meet in shared memory; otherwise (128 rows a
// step) warpgroup w takes rows [64 w, 64 w + 64) against every chunk.
template <bool kSplitKeys>
__device__ __forceinline__ void f32_consume(
    const float* q, const float* k, const float* v, float* out, int lq,
    int s, int h, int row_tiles, int first, int last, const Strides& st,
    float scale, const F32Thread& th) {
  constexpr int kRows = kSplitKeys ? kWgmmaRows : kF32Consumers * kWgmmaRows;
  const int chunks = (s + kF32Keys - 1) / kF32Keys;
  const int mine = kSplitKeys ? 0 : th.wg * kWgmmaRows;  // my first row
  PHASE_CLOCK_START();
  // q of the step j, in flight during the step before
  float qnext[4][4];
  auto fetch_q = [&](int j) {
    const F32Tile x = f32_tile(j, kRows, row_tiles, h, q, k, v, out, st);
    f32_fetch_q(qnext, x.q + mine * st.ql, st.ql, lq - x.row0 - mine, th);
  };
  fetch_q(first);
  int n = 0;  // chunks of the block's sequence before this one
  for (int j = first; j < last; ++j) {
    const F32Tile x = f32_tile(j, kRows, row_tiles, h, q, k, v, out, st);
    const int rows = lq - x.row0 - mine;  // of my 64; none if not above 0
    uint32_t qhi[4][4], qlo[4][4];
    f32_split_q(qhi, qlo, qnext, scale);
    if (j + 1 < last) fetch_q(j + 1);
    float o[16], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.0f;
    PHASE_CLOCK(0);
    for (int c = 0; c < chunks; ++c, ++n) {
      if (kSplitKeys && c % 2 != th.wg) continue;
      const int i = n % kF32Stages;
      const uint32_t at = th.ring + i * kF32Stage;
      mbar_wait(th.full + 8 * i, n / kF32Stages & 1);
      PHASE_CLOCK(1);
      if (rows > 0) {
        float sc[32], a[2];
        uint32_t phi[8][4], plo[8][4];
        f32_qk(sc, qhi, qlo, at);
        PHASE_CLOCK(2);
        f32_softmax(sc, min(kF32Keys, s - c * kF32Keys), m, l, a, phi, plo,
                    th);
        PHASE_CLOCK(3);
        f32_pv(o, a, phi, plo, at);
        PHASE_CLOCK(4);
      }
      mbar_arrive_warp(th.empty + 8 * i);
    }
    if (!kSplitKeys) {
      if (rows > 0) {
        const float inv[2] = {1.0f / quad_sum(l[0]), 1.0f / quad_sum(l[1])};
        float* at = x.out + (int64_t)(mine + th.r0) * st.ol + 2 * th.t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (th.r0 + 8 * r >= rows) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float2*>(at + 8 * r * st.ol + 8 * i) =
                make_float2(o[4 * i + 2 * r] * inv[r],
                            o[4 * i + 2 * r + 1] * inv[r]);
        }
      }
      PHASE_CLOCK(5);
      continue;
    }
    // split keys: each warpgroup's maxima, sums and outputs into shared
    // memory, then each thread merges 8 outputs of one row and stores them
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    if (th.t == 0) {
      th.rmax[th.wg * kWgmmaRows + th.r0] = m[0];
      th.rmax[th.wg * kWgmmaRows + th.r0 + 8] = m[1];
      th.rsum[th.wg * kWgmmaRows + th.r0] = l0;
      th.rsum[th.wg * kWgmmaRows + th.r0 + 8] = l1;
    }
    float* mine_part =
        th.part + (th.wg * kWgmmaRows + th.r0) * kPartLd + 2 * th.t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float2*>(mine_part + 8 * i) =
          make_float2(o[4 * i], o[4 * i + 1]);
      *reinterpret_cast<float2*>(mine_part + 8 * kPartLd + 8 * i) =
          make_float2(o[4 * i + 2], o[4 * i + 3]);
    }
    consumers_sync();
    const int r = threadIdx.x / 4, c = threadIdx.x % 4 * 8;
    if (r < rows) {
      // a warpgroup that held no chunk (S up to 64) counts -inf and 0
      const float ma = th.rmax[r], mb = th.rmax[kWgmmaRows + r];
      const float mx = fmaxf(ma, mb);
      const float fa = exp2_approx((ma - mx) * kLog2e);
      const float fb = exp2_approx((mb - mx) * kLog2e);
      const float inv = 1.0f / (th.rsum[r] * fa + th.rsum[kWgmmaRows + r] * fb);
      const float* pa = th.part + r * kPartLd + c;
      const float* pb = pa + kWgmmaRows * kPartLd;
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = (pa[e] * fa + pb[e] * fb) * inv;
      float4* to = reinterpret_cast<float4*>(x.out + (int64_t)r * st.ol + c);
      to[0] = make_float4(y[0], y[1], y[2], y[3]);
      to[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
    consumers_sync();  // the shared outputs are free for the next step
    PHASE_CLOCK(5);
  }
}

// The producer warpgroup: every chunk of the block's sequence (its steps in
// order, each step's chunks in order) into the ring, the next chunk's loads
// in flight while this one is split and stored
__device__ __forceinline__ void f32_produce(
    const float* q, const float* k, const float* v, float* out, int s, int h,
    int row_tiles, int rows, int first, int last, const Strides& st,
    const F32Thread& th) {
  const int p = threadIdx.x - kF32Consumers * kWgThreads;
  const int chunks = (s + kF32Keys - 1) / kF32Keys;
  const int total = (last - first) * chunks;
  if (total < 1) return;
  auto fetch = [&](F32Chunk& x, int n) {
    const F32Tile t = f32_tile(first + n / chunks, rows, row_tiles, h, q, k,
                               v, out, st);
    const int key0 = n % chunks * kF32Keys;
    f32_fetch(x, t.k + key0 * st.ks, st.ks, t.v + key0 * st.vs, st.vs,
              min(kF32Keys, s - key0), p);
  };
  PHASE_CLOCK_START();
  auto put = [&](const F32Chunk& x, int n) {
    const int i = n % kF32Stages;
    mbar_wait(th.empty + 8 * i, (n / kF32Stages & 1) ^ 1);  // free at first
    PHASE_CLOCK(0);
    f32_put(x, th.ring + i * kF32Stage, p);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(th.full + 8 * i);
    PHASE_CLOCK(1);
  };
  F32Chunk a, b;  // two, so that no copy waits for loads in flight
  fetch(a, 0);
  for (int n = 0; n < total; n += 2) {
    if (n + 1 < total) fetch(b, n + 1);
    put(a, n);
    if (n + 1 >= total) break;
    if (n + 2 < total) fetch(a, n + 2);
    put(b, n + 1);
  }
}

// Three warpgroups a block, one block an SM: two compute, one stages. The
// block walks the steps [first, last) of the sequence (batch, head, row
// tile of 64 rows if kSplitKeys, else 128).
template <bool kSplitKeys>
__global__ void __launch_bounds__(kF32Threads, 1)
attention_kernel_tile_f32(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out, int lq, int s, int h,
                          int row_tiles, int tiles, Strides st, float scale) {
  constexpr int kRows = kSplitKeys ? kWgmmaRows : kF32Consumers * kWgmmaRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(base);
  F32Thread th;
  th.wg = threadIdx.x / kWgThreads;
  th.r0 = threadIdx.x % kWgThreads / 32 * 16 + threadIdx.x % 32 / 4;
  th.t = threadIdx.x % 4;
  th.ring = sb + F32Layout::ring;
  th.full = sb + F32Layout::bars;
  th.empty = th.full + 8 * kF32Stages;
  th.part = reinterpret_cast<float*>(base + F32Layout::part);
  th.rmax = reinterpret_cast<float*>(base + F32Layout::rmax);
  th.rsum = reinterpret_cast<float*>(base + F32Layout::rsum);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kF32Stages; ++i) {
      mbar_init(th.full + 8 * i, kWgThreads);
      // a chunk's release: one arrival a warp that reads it
      mbar_init(th.empty + 8 * i, (kSplitKeys ? 1 : kF32Consumers) * 4);
    }
  }
  PHASE_CLOCKS_CLEAR();
  __syncthreads();
  const int share = tiles / gridDim.x, extra = tiles % gridDim.x;
  const int first = blockIdx.x * share + min((int)blockIdx.x, extra);
  const int last = first + share + ((int)blockIdx.x < extra);
  if (th.wg == kF32Consumers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 :: "n"(kF32ProducerRegs));
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 :: "n"(kF32ConsumerRegs));
  if (th.wg == kF32Consumers)
    f32_produce(q, k, v, out, s, h, row_tiles, kRows, first, last, st, th);
  else
    f32_consume<kSplitKeys>(q, k, v, out, lq, s, h, row_tiles, first, last,
                            st, scale, th);
  PHASE_CLOCKS_WRITE();
}

template <bool kSplitKeys>
cudaError_t launch_tile_f32(const void* q, const void* k, const void* v,
                            void* out, int b, int lq, int s, int h,
                            const Strides& st, float scale,
                            cudaStream_t stream) {
  constexpr int kRows = kSplitKeys ? kWgmmaRows : kF32Consumers * kWgmmaRows;
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};  // 0: this device not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(attention_kernel_tile_f32<kSplitKeys>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F32Layout::bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  const int row_tiles = (lq + kRows - 1) / kRows;
  const int64_t tiles = (int64_t)b * h * row_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(tiles < sms[dev] ? tiles : sms[dev]);
  attention_kernel_tile_f32<kSplitKeys>
      <<<blocks, kF32Threads, F32Layout::bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), lq, s, h,
          row_tiles, (int)tiles, st, scale);
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
      return launch_tile_f32<true>(q, k, v, out, b, lq, s, h, st, scale,
                                   stream);
    if (tile_rows == 128)
      return launch_tile_f32<false>(q, k, v, out, b, lq, s, h, st, scale,
                                    stream);
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
