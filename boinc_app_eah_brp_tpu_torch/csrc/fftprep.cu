// Kernel B: FFT-prep, the finalize pass of the resample chain.
//
// Replaces the Pallas kernel `_fftprep_kernel`
// (boinc_app_eah_brp_tpu/ops/pallas_resample.py, entry
// `resample_fftprep_pallas_batch`).
//
// Per template t and padded interleaved index i < nsamples: the gathered
// sample of kernel A where i < n_steps[t], else the template's pad mean.
// The output is the interleaved real series float32[T, nsamples] that
// cuFFT's R2C transform reads, so the search hands it to torch.fft.rfft
// with no re-interleave; the (even, odd) layout of the reference is a
// strided view of it.
//
// What bounds it on the card: bytes.  No arithmetic; it reads kernel A's
// raw streams (4 bytes per unpadded sample) and writes the padded series
// (4 bytes per padded sample) once.
//
// What the design does about it: one thread per output sample along the
// interleaved index, so stores are fully coalesced; the two parity reads of
// a warp fall into two contiguous runs.

#include <cuda_runtime.h>

namespace {

constexpr int kPrepBlock = 256;

__global__ void __launch_bounds__(kPrepBlock)
    fftprep_kernel(const float* __restrict__ raw, const int* __restrict__ n_steps,
                   const float* __restrict__ mean, float* __restrict__ out,
                   int half, int nsamples) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * kPrepBlock + threadIdx.x;
  if (i >= nsamples) return;
  float v = mean[t];
  if (i < n_steps[t] && (i >> 1) < half)
    v = raw[(static_cast<size_t>(t) * 2 + (i & 1)) * half + (i >> 1)];
  out[static_cast<size_t>(t) * nsamples + i] = v;
}

}  // namespace

// raw: float32[T, 2, half]; n_steps: int32[T]; mean: float32[T];
// out: float32[T, nsamples].
extern "C" int erp_fftprep(int device, void* stream, const float* raw,
                           const int* n_steps, const float* mean, float* out,
                           int T, int half, int nsamples) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nsamples + kPrepBlock - 1) / kPrepBlock, T);
  fftprep_kernel<<<grid, kPrepBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      raw, n_steps, mean, out, half, nsamples);
  return static_cast<int>(cudaGetLastError());
}
