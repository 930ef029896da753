// Kernel A: the orbital resampler, one launch for a batch of templates.
//
// Replaces the Pallas kernels `_batched_stream_kernel` and
// `_parity_stream_kernel` (boinc_app_eah_brp_tpu/ops/pallas_resample.py,
// body `_stream_block_body`); the single-template form is the T=1 launch.
//
// Per (template t, parity p, output m) with interleaved index i = 2m+p:
//   phase = omega * (i*dt) + psi0
//   s     = LUT sine of phase (65-entry table, 2nd-order Taylor)
//   del_t = tau * s * step_inv - S0
//   idx   = clip(trunc(i - del_t + 0.5), 0, n-1)
//   out   = ts[idx] (* renorm)
// and per block of kStreamBlock outputs, the largest m whose
// i - del_t < n-1 (the start of the trailing run that sets n_steps).
//
// What bounds it on the card: bytes.  Each output is ~30 float32 operations
// and one 4-byte gather, so the time is the output store (4 bytes per
// sample per template) plus the gather reads of a time series that stays in
// L2 (16.8 MB at the production workunit).
//
// What the design does about it: one thread per output sample, a direct
// load of ts[idx] from the parity stream idx & 1 at idx >> 1 (the Pallas
// window DMA and shifted-select ladder were workarounds for gathers on the
// TPU), stores coalesced along m, and the trailing-run position reduced in
// registers with warp shuffles (a max is exact in any order).
//
// Numerics: the index arithmetic must not be contracted into FMAs: one
// fused multiply-add flips a nearest index and with it the candidate set.
// Every multiply and add below is an explicit round-to-nearest intrinsic in
// the reference op order (pallas_resample.py:199-253), and the file is also
// compiled with -fmad=false.  Float to int is truncation toward zero, as
// `.astype(int32)`.  The table is indexed as table[iu & 63] for the
// unwrapped LUT index iu >= 0: the entry the tiled table selects wherever
// the geometry contract (models/search.py::validate_bank_bounds) holds; a
// negative iu reads entry 0, as the clipped tiled window does.

#include <cuda_runtime.h>

namespace {

constexpr int kStreamBlock = 256;

__constant__ float c_sin[64];
__constant__ float c_cos[64];
// {2*pi as the reference's truncated literal, its float32 inverse}
__constant__ float c_two_pi[2];

__global__ void __launch_bounds__(kStreamBlock)
    stream_kernel(const float* __restrict__ ts_e, const float* __restrict__ ts_o,
                  const float* __restrict__ params, float* __restrict__ out,
                  int* __restrict__ lf, int half, int n_unpadded, float dt,
                  float step_inv, float renorm, int apply_renorm) {
  const int b = blockIdx.x;
  const int p = blockIdx.y;
  const int t = blockIdx.z;
  const int m = b * kStreamBlock + threadIdx.x;
  const float tau = params[4 * t + 0];
  const float omega = params[4 * t + 1];
  const float psi0 = params[4 * t + 2];
  const float s0 = params[4 * t + 3];

  int last = -1;
  if (m < half) {
    const float i_f = static_cast<float>(2 * m + p);  // exact below 2^24
    const float tt = __fmul_rn(i_f, dt);
    const float phase = __fadd_rn(__fmul_rn(omega, tt), psi0);
    const float scaled = __fmul_rn(c_two_pi[1], phase);
    const int iu = __float2int_rz(__fadd_rn(__fmul_rn(scaled, 64.0f), 0.5f));
    const float d = __fmul_rn(
        c_two_pi[0],
        __fsub_rn(scaled, __fmul_rn(0.015625f, __int2float_rn(iu))));
    const int k = max(iu, 0) & 63;
    const float tsv = c_sin[k];
    const float tcv = c_cos[k];
    const float d2 = __fmul_rn(d, __fmul_rn(0.5f, d));
    const float s = __fsub_rn(__fadd_rn(tsv, __fmul_rn(d, tcv)), __fmul_rn(d2, tsv));
    const float del_t = __fsub_rn(__fmul_rn(__fmul_rn(tau, s), step_inv), s0);
    const float x = __fsub_rn(i_f, del_t);
    const bool cond = x >= static_cast<float>(n_unpadded - 1);
    int idx = __float2int_rz(__fadd_rn(x, 0.5f));
    idx = min(max(idx, 0), n_unpadded - 1);
    float v = (idx & 1) ? ts_o[idx >> 1] : ts_e[idx >> 1];
    if (apply_renorm) v = __fmul_rn(v, renorm);
    out[(static_cast<size_t>(t) * 2 + p) * half + m] = v;
    if (!cond) last = m;
  }

  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  __shared__ int warp_last[kStreamBlock / 32];
  if ((threadIdx.x & 31) == 0) warp_last[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int v = warp_last[0];
    for (int w = 1; w < kStreamBlock / 32; ++w) v = max(v, warp_last[w]);
    lf[(static_cast<size_t>(t) * 2 + p) * gridDim.x + b] = v;
  }
}

}  // namespace

extern "C" int erp_resample_block() { return kStreamBlock; }

// Loads the sine/cosine tables (64 entries each, host pointers) and the
// two 2*pi constants into this device's constant memory.  Synchronous;
// called once per device before the first launch.
extern "C" int erp_resample_init(int device, const float* sin64,
                                 const float* cos64, const float* two_pi) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyToSymbol(c_sin, sin64, 64 * sizeof(float));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyToSymbol(c_cos, cos64, 64 * sizeof(float));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyToSymbol(c_two_pi, two_pi, 2 * sizeof(float));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out: float32[T, 2, half]; lf: int32[T, 2, ceil(half / kStreamBlock)];
// params: float32[T, 4] rows (tau, omega, psi0, s0).
extern "C" int erp_resample_stream(int device, void* stream, const float* ts_e,
                                   const float* ts_o, const float* params,
                                   float* out, int* lf, int T, int half,
                                   int n_unpadded, float dt, float step_inv,
                                   float renorm, int apply_renorm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblk = (half + kStreamBlock - 1) / kStreamBlock;
  const dim3 grid(nblk, 2, T);
  stream_kernel<<<grid, kStreamBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ts_e, ts_o, params, out, lf, half, n_unpadded, dt, step_inv, renorm,
      apply_renorm);
  return static_cast<int>(cudaGetLastError());
}
