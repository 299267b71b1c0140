// Adam over all trainable float32 tensors of a step in two launches, for
// Hopper (sm_90a), exposed through plain C entry points and called from
// cotr_tpu_torch/training/optim.py over ctypes.
//
// Replaces no TPU kernel. The JAX package's optimizer is optax.adam under
// optax.apply_if_finite (cotr_tpu/training/optim.py), which XLA fuses on the
// TPU. The port's eager loop (Optimizer.step_plain) issues about 22 PyTorch
// ops a tensor, 4,465 launches a step over the published model's 202
// trainable tensors, and the card waits while the host issues them. These
// two kernels do the same work:
//
// adam_finite: every gradient's finiteness, reduced into one device flag
//   (1: every value finite; a block that finds a NaN or an Inf stores 0).
//   On a process mesh the wrapper takes the flag's minimum over the ranks
//   between the two launches.
// adam_update: reads the flag, the Adam count and the run of non-finite
//   steps from device memory; applies the step when the flag holds or the
//   run passed max_errors (optax.apply_if_finite), with both moments
//   bias-corrected at count + 1 and each group's rate at count, the cosine
//   schedule included. A step it does not apply writes no weight or moment.
//   The last block to finish (an atomic count of finished blocks) moves the
//   counters (count, notfinite_count, total_notfinite, last_finite) and sets
//   the flag back to 1 for the next step's check; every other block has
//   read them by then.
//
// Both walk a table of tensors (w, g, mu, nu, numel, group) and a table of
// chunks (tensor, first element) in device memory, one block a chunk, its
// threads on neighbouring elements. The wrapper uploads the tables only
// when a tensor's address changes. Every value is computed as the eager
// loop's PyTorch ops compute it, op by op, with round-to-nearest intrinsics
// that the compiler does not contract into FMAs; so on the card the result
// equals the loop's to the bit.
//
// What bounds them on this card: bytes. A step reads g, w, mu and nu and
// writes w, mu and nu, 28 bytes an element: 276 MB for the published
// model's 9,872,130 trainable parameters, 0.08 ms at 3.35 TB/s; the check
// reads g once more, 0.012 ms. Both are far below the host's cost of the
// launches they replace.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// what a step reads besides the tables (the layout of optim.py's _Step,
// which checks it against cotr_adam_step_layout at load; outside the
// anonymous namespace, so the C entry that takes it keeps external linkage)
struct AdamStep {
  int* flag;
  int* count;
  int* notfinite;
  int* total_notfinite;
  bool* last_finite;
  unsigned int* done;
  float one_minus_beta1, beta1, one_minus_beta2, beta2, eps;
  float base_lr[2];  // by group: main, backbone
  int cosine;  // 1: the cosine schedule over decay_steps
  int decay_steps;
  float inv_decay_steps, pi, one_minus_final, final_frac;
  int max_errors;
};

namespace {

constexpr int kThreads = 256;

// one row of the tensor table, six int64 each
struct TensorRow {
  int64_t w, g, mu, nu, numel, group;
};

__device__ __forceinline__ bool is_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

// the chunk of block blockIdx.x: its tensor's row, first element, length
__device__ __forceinline__ const TensorRow& chunk_of(
    const int64_t* table, int n_tensors, int chunk, int64_t* start,
    int64_t* n) {
  const int64_t* c = table + 6 * (int64_t)n_tensors + 2 * (int64_t)blockIdx.x;
  const TensorRow& row = reinterpret_cast<const TensorRow*>(table)[c[0]];
  *start = c[1];
  *n = row.numel - c[1] < chunk ? row.numel - c[1] : chunk;
  return row;
}

__global__ void __launch_bounds__(kThreads)
adam_finite(const int64_t* __restrict__ table, int n_tensors, int chunk,
            int* __restrict__ flag) {
  int64_t start, n;
  const TensorRow& row = chunk_of(table, n_tensors, chunk, &start, &n);
  const float* g = reinterpret_cast<const float*>(row.g) + start;
  bool bad = false;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) bad |= !is_finite(g[i]);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 0;
}

// _group_lr of optim.py: the base rate, or its cosine decay at Adam count
// ``count``, rounded op by op as PyTorch's float32 ops round it (a division
// by a host scalar is a product with its float reciprocal there)
__device__ __forceinline__ float group_lr(const AdamStep& s, int group,
                                          int count) {
  const float base = group ? s.base_lr[1] : s.base_lr[0];
  if (!s.cosine) return base;
  const float steps = (float)(count < s.decay_steps ? count : s.decay_steps);
  const float frac = __fmul_rn(steps, s.inv_decay_steps);
  const float cosine =
      __fmul_rn(0.5f, __fadd_rn(1.0f, cosf(__fmul_rn(s.pi, frac))));
  return __fmul_rn(
      base, __fadd_rn(__fmul_rn(s.one_minus_final, cosine), s.final_frac));
}

__global__ void __launch_bounds__(kThreads)
adam_update(const int64_t* __restrict__ table, int n_tensors, int chunk,
            AdamStep s) {
  __shared__ int scalars[3];
  if (threadIdx.x == 0) {
    scalars[0] = *s.flag;
    scalars[1] = *s.count;
    scalars[2] = *s.notfinite;
  }
  __syncthreads();
  const bool finite = scalars[0] != 0;
  const int count = scalars[1];
  const int notfinite = finite ? 0 : scalars[2] + 1;
  const bool apply = finite || notfinite > s.max_errors;
  if (apply) {
    int64_t start, n;
    const TensorRow& row = chunk_of(table, n_tensors, chunk, &start, &n);
    float* w = reinterpret_cast<float*>(row.w) + start;
    const float* g = reinterpret_cast<const float*>(row.g) + start;
    float* mu = reinterpret_cast<float*>(row.mu) + start;
    float* nu = reinterpret_cast<float*>(row.nu) + start;
    const float t = (float)(count + 1);
    const float c1 = __fsub_rn(1.0f, powf(s.beta1, t));
    const float c2 = __fsub_rn(1.0f, powf(s.beta2, t));
    const float lr = group_lr(s, (int)row.group, count);
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      const float gi = g[i];
      const float m = __fadd_rn(__fmul_rn(s.one_minus_beta1, gi),
                                __fmul_rn(s.beta1, mu[i]));
      const float v = __fadd_rn(__fmul_rn(s.one_minus_beta2, __fmul_rn(gi, gi)),
                                __fmul_rn(s.beta2, nu[i]));
      const float update = __fdiv_rn(
          __fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), s.eps));
      w[i] = __fsub_rn(w[i], __fmul_rn(lr, update));
      mu[i] = m;
      nu[i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(s.done, 1u) == gridDim.x - 1) {
      *s.count = apply ? count + 1 : count;
      *s.notfinite = notfinite;
      *s.total_notfinite += finite ? 0 : 1;
      *s.last_finite = finite;
      *s.flag = 1;
      *s.done = 0;
    }
  }
}

}  // namespace

extern "C" {

// table: n_tensors rows of (w, g, mu, nu, numel, group) then n_chunks rows
// of (tensor, first element), int64, in device memory; every tensor float32
// and contiguous; chunk: elements a chunk. Each returns the CUDA error of
// its launch, or cudaErrorInvalidValue for arguments these kernels do not
// take.
int cotr_adam_finite(const int64_t* table, int n_tensors, int n_chunks,
                     int chunk, int* flag, void* stream) {
  if (n_tensors < 1 || n_chunks < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  adam_finite<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_tensors, chunk, flag);
  return (int)cudaGetLastError();
}

// AdamStep's layout, for the binding to check its mirror against: its size,
// then each field's offset in declaration order, into out (20 values).
// Returns the count written.
int cotr_adam_step_layout(int64_t* out) {
  int i = 0;
  out[i++] = (int64_t)sizeof(AdamStep);
#define COTR_OFFSET(f) out[i++] = (int64_t)offsetof(AdamStep, f)
  COTR_OFFSET(flag);
  COTR_OFFSET(count);
  COTR_OFFSET(notfinite);
  COTR_OFFSET(total_notfinite);
  COTR_OFFSET(last_finite);
  COTR_OFFSET(done);
  COTR_OFFSET(one_minus_beta1);
  COTR_OFFSET(beta1);
  COTR_OFFSET(one_minus_beta2);
  COTR_OFFSET(beta2);
  COTR_OFFSET(eps);
  COTR_OFFSET(base_lr);
  COTR_OFFSET(cosine);
  COTR_OFFSET(decay_steps);
  COTR_OFFSET(inv_decay_steps);
  COTR_OFFSET(pi);
  COTR_OFFSET(one_minus_final);
  COTR_OFFSET(final_frac);
  COTR_OFFSET(max_errors);
#undef COTR_OFFSET
  return i;
}

int cotr_adam_update(const int64_t* table, int n_tensors, int n_chunks,
                     int chunk, const AdamStep* step, void* stream) {
  if (n_tensors < 1 || n_chunks < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  adam_update<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_tensors, chunk, *step);
  return (int)cudaGetLastError();
}

}  // extern "C"
