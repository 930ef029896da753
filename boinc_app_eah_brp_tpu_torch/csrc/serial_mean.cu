// The reference's serial float32 padding mean, on the card.
//
// No Pallas kernel stands behind this one: the JAX package computes the
// mean of unwhitened runs on the host, per template, with the reference's
// chain (boinc_app_eah_brp_tpu/models/search.py `host_exact_mean_params`,
// oracle/resample.py `serial_mean_f32`, demod_binary_resamp_cpu.c:121).
// Here it reads kernel A's gathered samples, which the card already holds:
//
//   mean[t] = (sum over i < n_steps[t] of raw[t, i & 1, i >> 1],
//              added strictly in order i = 0, 1, 2, ... in float32)
//             / (float) n_steps[t]                    (0.0 if n_steps <= 0)
//
// Every add rounds on its own (__fadd_rn), the division is IEEE
// (__fdiv_rn): bitwise the oracle's np.add.accumulate chain.
//
// What bounds it on the card: the dependency chain, not bytes.  A template
// is ~4.19M dependent float adds at the production width, ~4 cycles each:
// ~8.5 ms at 1.98 GHz whatever the batch size, against a byte bound of
// ~0.16 ms for 32 templates (each sample read once at 3.35 TB/s).  The
// chain is fixed by bitwise parity with the reference: a float sum in any
// other order rounds differently.
//
// What the design does about it: one block a template; its thread 0 runs
// the chain and does nothing else, reading its operands from shared memory
// four at a time, issued ahead of the adds.  The other warps stage the next
// chunk of both parity rows into the other half of a double buffer with
// cp.async while thread 0 adds the current one, so device-memory latency
// never stands in the chain.  All templates of a batch run side by side.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // warp 0's lane 0 adds; warps 1..7 stage
constexpr int kHalfChunk = 2048;  // outputs of each parity in one stage

__device__ __forceinline__ void stage(float (*dst)[kHalfChunk], const float* __restrict__ ev,
                                      const float* __restrict__ od, int m0, int half, int first,
                                      int stride) {
  for (int k = first; k < 2 * kHalfChunk; k += stride) {
    const int p = k / kHalfChunk;
    const int j = k - p * kHalfChunk;
    const int m = m0 + j;
    if (m < half) __pipeline_memcpy_async(&dst[p][j], (p ? od : ev) + m, sizeof(float));
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads)
    serial_mean_kernel(const float* __restrict__ raw, const int* __restrict__ n_steps,
                       float* __restrict__ mean, int half) {
  __shared__ __align__(16) float buf[2][2][kHalfChunk];
  const int t = blockIdx.x;
  const int n = n_steps[t];
  if (n <= 0) {
    if (threadIdx.x == 0) mean[t] = 0.0f;
    return;
  }
  const float* ev = raw + static_cast<size_t>(t) * 2 * half;
  const float* od = ev + half;
  const int n_sum = min(n, 2 * half);  // kernel A's n_steps is below 2 * half
  const int n_chunks = (n_sum + 2 * kHalfChunk - 1) / (2 * kHalfChunk);

  stage(buf[0], ev, od, 0, half, threadIdx.x, kThreads);
  __pipeline_wait_prior(0);
  __syncthreads();

  // -0.0 + x == x for every x, so the first add gives raw[0] exactly, as
  // the accumulate's first element is
  float s = -0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c & 1;
    if (threadIdx.x >= 32) {
      if (c + 1 < n_chunks) {
        stage(buf[slot ^ 1], ev, od, (c + 1) * kHalfChunk, half, threadIdx.x - 32, kThreads - 32);
        __pipeline_wait_prior(0);
      }
    } else if (threadIdx.x == 0) {
      const float* e = buf[slot][0];
      const float* o = buf[slot][1];
      const int cnt = min(n_sum - 2 * c * kHalfChunk, 2 * kHalfChunk);  // samples of this chunk
      const int pairs = cnt >> 1;
      int j = 0;
#pragma unroll 4
      for (; j + 4 <= pairs; j += 4) {
        const float4 e4 = *reinterpret_cast<const float4*>(e + j);
        const float4 o4 = *reinterpret_cast<const float4*>(o + j);
        s = __fadd_rn(s, e4.x);
        s = __fadd_rn(s, o4.x);
        s = __fadd_rn(s, e4.y);
        s = __fadd_rn(s, o4.y);
        s = __fadd_rn(s, e4.z);
        s = __fadd_rn(s, o4.z);
        s = __fadd_rn(s, e4.w);
        s = __fadd_rn(s, o4.w);
      }
      for (; j < pairs; ++j) {
        s = __fadd_rn(s, e[j]);
        s = __fadd_rn(s, o[j]);
      }
      if (cnt & 1) s = __fadd_rn(s, e[pairs]);
    }
    __syncthreads();  // the next chunk is in; this one may be overwritten
  }
  if (threadIdx.x == 0) mean[t] = __fdiv_rn(s, static_cast<float>(n));
}

}  // namespace

// raw: float32[T, 2, half]; n_steps: int32[T]; mean: float32[T] (out).
extern "C" int erp_serial_mean(int device, void* stream, const float* raw, const int* n_steps,
                               float* mean, int T, int half) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  serial_mean_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(raw, n_steps, mean, half);
  return static_cast<int>(cudaGetLastError());
}
