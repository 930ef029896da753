// Kernel C: the 16-harmonic fold into five phase-major run-max levels.
//
// Replaces the Pallas kernel `_fold_kernel_body`
// (boinc_app_eah_brp_tpu/ops/pallas_sumspec.py, entry `sumspec_pallas_batch`).
//
// For column q and phase row r (spectrum index i = 16q + r), multiplier l
// reads the power spectrum at (i*l + 8) >> 4 = l*q + ((l*r + 8) >> 4).  The
// running sums start from l = 16 and add one harmonic level at a time in the
// reference order (hs_common.c:78-148): each level's new terms are summed
// left to right and the group is added to the running sum in one operation,
// so the float32 results match `harmonic_sumspec` bit for bit.  Indices
// i >= harm_hi are masked to 0 before each level's run maxima; level k's
// phase p at column q takes the max over rows [m*p - m/2, m*p + m/2), with
// m = 2^k, the negative rows wrapping to column q-1 (which reads 0 at q = 0).
// Output: float32[T, 5, W] phase-major planes, written directly.
//
// What bounds it on the card: bytes.  Each template's fold reads the
// spectrum prefix up to harm_hi (21 MB at the production workunit, which
// fits the 50 MB L2) and writes 5*W floats (6.6 MB); the ~16 adds and
// ~20 max per column are far below the card's float32 rate.
//
// What the design does about it: one block per (template, tile of kCols
// output columns), one thread per column with the 16 running sums in
// registers.  For each multiplier l the block stages the contiguous
// spectrum range it needs (l*256 + 1 floats) through shared memory with
// coalesced loads, so each multiplier costs one pass over the prefix from
// L2 and the strided per-thread reads hit shared memory.  The Pallas
// 136-row deinterleaved operand (8.5x the spectrum written to HBM) was a
// Mosaic workaround and is gone.  Thread 0 of each block computes the halo
// column q0-1 that the first output column's wrap reads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // columns per block, halo included
constexpr int kCols = kThreads - 1;  // output columns per block

// max that propagates NaN like torch.maximum / jnp.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// buf[j] = spec[base + j] for j in [0, kThreads*L + 1), 0 outside [0, len)
template <int L>
__device__ __forceinline__ void stage(const float* __restrict__ spec, long len,
                                      long base, float* buf) {
  __syncthreads();  // previous readers of buf are done
  for (int j = threadIdx.x; j < kThreads * L + 1; j += kThreads) {
    const long g = base + j;
    buf[j] = (g >= 0 && g < len) ? spec[g] : 0.0f;
  }
  __syncthreads();
}

// level[r] (+)= spectrum term of multiplier L at row r, for this column
template <int L, bool First>
__device__ __forceinline__ void add_terms(const float* __restrict__ spec, long len,
                                          int q0, float* buf, float (&level)[16]) {
  stage<L>(spec, len, static_cast<long>(L) * (q0 - 1), buf);
  const int j = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float term = buf[L * j + ((L * r + 8) >> 4)];
    level[r] = First ? term : __fadd_rn(level[r], term);
  }
}

// running += level; mask; run maxima of level K into plane K of `o`
template <int K>
__device__ __forceinline__ void finish_level(float (&run)[16], const float (&level)[16],
                                             int q, int harm_hi, int fund_hi, int W,
                                             float* tail, float* __restrict__ o) {
  constexpr int m = 1 << K;
  constexpr int h = m >> 1;
  constexpr int n_ph = 16 >> K;
  float masked[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    run[r] = __fadd_rn(run[r], level[r]);
    masked[r] = (16 * q + r < harm_hi) ? run[r] : 0.0f;
  }
  // rows of this column that the next column's phase-0 run wraps into
  float tl = masked[16 - h];
#pragma unroll
  for (int r = 16 - h + 1; r < 16; ++r) tl = nan_max(tl, masked[r]);
  tail[threadIdx.x] = (q >= 0) ? tl : 0.0f;
  __syncthreads();
  if (threadIdx.x > 0) {
    const float prev = tail[threadIdx.x - 1];
    const int Qk = (fund_hi + n_ph - 1) / n_ph;
    float* plane = o + static_cast<long>(K) * W;
    if (q < Qk) {
#pragma unroll
      for (int p = 0; p < n_ph; ++p) {
        const int lo = m * p - h;
        const int hi = m * p + h;
        float v;
        if (lo < 0) {
          v = masked[0];
#pragma unroll
          for (int r = 1; r < hi; ++r) v = nan_max(v, masked[r]);
          v = nan_max(prev, v);
        } else {
          v = masked[lo];
#pragma unroll
          for (int r = lo + 1; r < hi; ++r) v = nan_max(v, masked[r]);
        }
        plane[p * Qk + q] = v;
      }
    }
    const int pad = n_ph * Qk + q;  // junk slots past the last phase row
    if (pad < W) plane[pad] = 0.0f;
  }
  __syncthreads();  // tail is rewritten by the next level
}

__global__ void __launch_bounds__(kThreads)
    fold_kernel(const float* __restrict__ ps, float* __restrict__ out, int len,
                int fund_hi, int harm_hi, int W) {
  __shared__ float buf[kThreads * 16 + 1];
  __shared__ float tail[kThreads];
  const int t = blockIdx.y;
  const int q0 = blockIdx.x * kCols;
  const int q = q0 - 1 + static_cast<int>(threadIdx.x);
  const float* spec = ps + static_cast<long>(t) * len;
  float* o = out + static_cast<long>(t) * 5 * W;

  if (threadIdx.x > 0 && q < W) o[q] = (q < fund_hi && q < len) ? spec[q] : 0.0f;

  float run[16];
  float level[16];
  add_terms<16, true>(spec, len, q0, buf, run);

  add_terms<8, true>(spec, len, q0, buf, level);
  finish_level<1>(run, level, q, harm_hi, fund_hi, W, tail, o);

  add_terms<12, true>(spec, len, q0, buf, level);
  add_terms<4, false>(spec, len, q0, buf, level);
  finish_level<2>(run, level, q, harm_hi, fund_hi, W, tail, o);

  add_terms<14, true>(spec, len, q0, buf, level);
  add_terms<10, false>(spec, len, q0, buf, level);
  add_terms<6, false>(spec, len, q0, buf, level);
  add_terms<2, false>(spec, len, q0, buf, level);
  finish_level<3>(run, level, q, harm_hi, fund_hi, W, tail, o);

  add_terms<15, true>(spec, len, q0, buf, level);
  add_terms<13, false>(spec, len, q0, buf, level);
  add_terms<11, false>(spec, len, q0, buf, level);
  add_terms<9, false>(spec, len, q0, buf, level);
  add_terms<7, false>(spec, len, q0, buf, level);
  add_terms<5, false>(spec, len, q0, buf, level);
  add_terms<3, false>(spec, len, q0, buf, level);
  add_terms<1, false>(spec, len, q0, buf, level);
  finish_level<4>(run, level, q, harm_hi, fund_hi, W, tail, o);
}

}  // namespace

extern "C" int erp_fold_cols() { return kCols; }

// ps: float32[T, len]; out: float32[T, 5, W].
extern "C" int erp_fold(int device, void* stream, const float* ps, float* out,
                        int T, int len, int fund_hi, int harm_hi, int W) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + kCols - 1) / kCols, T);
  fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ps, out, len, fund_hi, harm_hi, W);
  return static_cast<int>(cudaGetLastError());
}
