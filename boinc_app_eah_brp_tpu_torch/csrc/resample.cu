// Kernel A: the orbital resampler and its batch statistics, one call for a
// batch of templates.
//
// Replaces the Pallas kernels `_batched_stream_kernel` and
// `_parity_stream_kernel` (boinc_app_eah_brp_tpu/ops/pallas_resample.py,
// body `_stream_block_body`; the single-template form is the T=1 launch),
// and the XLA glue `_batch_stats` of the same file that turns their
// outputs into each template's (n_steps, mean).
//
// Per (template t, parity p, output m) with interleaved index i = 2m+p:
//   phase = omega * (i*dt) + psi0
//   s     = LUT sine of phase (65-entry table, 2nd-order Taylor)
//   del_t = tau * s * step_inv - S0
//   idx   = clip(trunc(i - del_t + 0.5), 0, n-1)
//   raw   = ts[idx] (* renorm)
// then per template n_steps = max(2*lf_e, 2*lf_o + 1), lf_p the largest m
// of parity p whose i - del_t < n-1 (the start of the trailing run), and
// mean = (sum_e + sum_o) / n_steps over the samples with i < n_steps.
//
// The sum has one fixed order, which ops/resample.py::masked_sum_plain
// writes out as eager float32 adds: a warp's unit of kUnit = 256 outputs
// gives lane j the kPer = 8 outputs j, j+32, ..., j+224, summed in that
// order; the 32 lane sums meet in a halving tree (lane j + lane j^16, ...,
// the xor butterfly); the unit sums of a parity meet in a halving tree over
// units padded with +0.0 to a power of two; then sum_e + sum_o.  Masked and
// missing (m >= half) samples add +0.0.  No float atomics: the result does
// not depend on which block finishes first.
//
// What bounds it on the card, at T = 32 and the production workunit
// (n = 2^22):
// - bytes: ts read once (16.8 MB) and raw written once (537 MB): 0.166 ms
//   at 3.35 TB/s;
// - issue: the reference chain is 24 float32 instructions a sample on the
//   interior path (phase and LUT argument 6, LUT index 2, Taylor sine 9,
//   del_t 3, nearest index 3, the add into its lane's sum 1; every multiply
//   and add is its own instruction under -fmad=false), and a sample also
//   needs its table and gather addresses, the gather and its store: ~34
//   instructions, 0.14 ms at one warp instruction a clock on each of the
//   132 x 4 schedulers.  The first port's kernel issued about 67 (4
//   conversions, index and bounds tests, parity selects, a block barrier
//   and a serial max).
// So the kernel sits at the ridge: memory alone does not set its floor.
//
// What the design does about it (the design study is in PERF.md):
// - Each thread makes kPer outputs 32 apart, so every gather and store
//   instruction of a warp covers 32 consecutive outputs (consecutive
//   outputs a thread made each gather touch kPer cache lines and ran much
//   slower); its kPer gathers are issued before any is used, the stores
//   carry the evict-first hint (kernel B reads raw only after the whole
//   batch has passed through L2), and the per-template parameters stay in
//   registers.
// - A block owns a tile of 2048 outputs and walks every template and both
//   parities over it, so the ts window of the tile (+- max |del_t|) is
//   fetched from device memory about once a batch and served from L1 after
//   that; the grid has no template dimension.
// - The gather reads the interleaved series itself: no parity select.
// - Interior runs: where all of a thread's outputs exist, its LUT arguments
//   lie in [0, 2^23) (checked at the ends of the run: the argument is
//   monotone in i) and a bound on |del_t| keeps every i - del_t inside
//   [0, n-2], no sample needs a test of any kind: no clip, no trailing-run
//   test, no bounds test.  Other runs (kEdge) take the same arithmetic with
//   the tests.
// - Conversions: for n <= 2^23, i is an exact float sum of integers, and
//   the two truncations toward zero (LUT index, nearest index) are an add
//   of 2^23 rounded toward zero, whose bits give the integer and whose
//   value less 2^23 the float: exact for arguments in [0, 2^23), which the
//   clip to [0, n-1] guarantees for the nearest index; a LUT argument
//   outside that range takes the conversion instructions.  A longer series
//   (kWide, chosen at launch) takes the edge path with conversions for i
//   and the nearest index, as the plain version computes them.
// - Statistics: each warp reduces its unit's sum (and, unless the whole
//   unit is interior, its trailing-run position) with shuffles and writes
//   them, one pair a unit, with no block barrier; a second launch of one
//   block per template finds n_steps, takes the unit sums below the cut,
//   re-sums the one unit per parity that the cut crosses from raw with the
//   mask, and runs the halving tree in shared memory.  Nothing runs between
//   this and kernel B.
// - The sine and cosine tables stay in __constant__ memory, one float2 an
//   entry: at bank200's shortest orbit a warp's 512 interleaved samples
//   move the LUT index by 0.003 entries, so a warp reads one entry (rarely
//   two).
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

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// outputs a thread; with the lane stride it sets the summation order, so
// ops/resample.py's PER_LANE must follow it
constexpr int kPer = 8;
constexpr int kUnit = 32 * kPer;            // outputs a warp: one unit sum
// a lane's k-th output is m0 + k * kStride: 32 interleaves the lanes, so
// each gather and store instruction of a warp covers consecutive outputs
constexpr int kStride = 32;
constexpr int kUnitsPerBlock = kThreads / 32;
constexpr int kFinThreads = 512;            // finisher: one block a template
constexpr int kTreeMax = 8192;              // finisher: shared tree entries
constexpr float kMagic = 8388608.0f;        // 2^23
constexpr unsigned kMagicBits = 0x4B000000u;  // its bits
constexpr int kMaxNarrow = 1 << 23;         // longest series of the 2^23 add

__constant__ float2 c_sincos[64];  // {sin, cos} at the 64 LUT points
// {2*pi as the reference's truncated literal, its float32 inverse}
__constant__ float c_two_pi[2];

__device__ __forceinline__ bool below_magic(float y) { return y >= 0.0f && y < kMagic; }

// kInterior: every output exists, every LUT argument y lies in [0, 2^23)
// and every i - del_t in [0, n-2] (so the clip is the identity and no
// sample is in the trailing run): the common case, with no test of any
// kind a sample.  kEdge: the tests, and the nearest index clipped to
// [0, n-1] as a float before it is truncated (trunc is monotone and the
// bounds are integers; fmaxf maps NaN to 0, as the conversion does), so it
// truncates by the 2^23 add.  kWide: n > 2^23, the nearest index truncated
// by conversion and clipped as an integer.
enum Path { kInterior, kEdge, kWide };

// The samples of one template and parity at a thread's kPer outputs m0 +
// k * kStride (times renorm; 0 past half), and the largest of those m whose
// i - del_t < n-1 (-1 when none).  The index that a gather reads is held
// as its bits plus those of 2^23, which base (ts less that bias) undoes.
template <Path kPath>
__device__ __forceinline__ int gather(const float (&i_f)[kPer], const float (&scaled)[kPer],
                                      const float (&y)[kPer], float tau, float s0,
                                      float step_inv, float n_last, int n_unpadded, int m0,
                                      int m_left, uintptr_t base, float (&v)[kPer]) {
  int last = -1;
  unsigned bits[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    float iu_f;
    int e;
    if (kPath == kInterior || below_magic(y[k])) {
      const float r = __fadd_rz(y[k], kMagic);
      iu_f = __fsub_rn(r, kMagic);
      e = __float_as_int(r) & 63;  // kMagicBits has no low bits
    } else {
      const int iu = __float2int_rz(y[k]);
      iu_f = __int2float_rn(iu);
      e = max(iu, 0) & 63;
    }
    const float2 sc = c_sincos[e];
    const float d = __fmul_rn(c_two_pi[0], __fsub_rn(scaled[k], __fmul_rn(0.015625f, iu_f)));
    const float d2 = __fmul_rn(d, __fmul_rn(0.5f, d));
    const float s = __fsub_rn(__fadd_rn(sc.x, __fmul_rn(d, sc.y)), __fmul_rn(d2, sc.x));
    const float del_t = __fsub_rn(__fmul_rn(__fmul_rn(tau, s), step_inv), s0);
    const float x = __fsub_rn(i_f[k], del_t);
    const float z = __fadd_rn(x, 0.5f);
    if (kPath != kInterior && !(x >= n_last) && k * kStride < m_left) last = m0 + k * kStride;
    if (kPath == kInterior)
      bits[k] = __float_as_uint(__fadd_rz(z, kMagic));
    else if (kPath == kEdge)
      bits[k] = __float_as_uint(__fadd_rz(fminf(fmaxf(z, 0.0f), n_last), kMagic));
    else
      bits[k] = static_cast<unsigned>(min(max(__float2int_rz(z), 0), n_unpadded - 1)) + kMagicBits;
  }
  if (kPath == kInterior) last = m0 + (kPer - 1) * kStride;
  // all gathers issued before any is used
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    v[k] = __ldg(reinterpret_cast<const float*>(base + static_cast<uintptr_t>(bits[k]) * sizeof(float)));
  if (kPath != kInterior) {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k * kStride >= m_left) v[k] = 0.0f;
  }
  return last;
}

template <bool kWideSeries>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const float* __restrict__ ts, const float* __restrict__ params,
                  float* __restrict__ out,
                  float* __restrict__ unit_sum, int* __restrict__ unit_last,
                  int T, int half, int n_units, int n_unpadded, float dt,
                  float step_inv, float renorm, int apply_renorm) {
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kUnitsPerBlock + (threadIdx.x >> 5);
  if (unit >= n_units) return;  // whole warps only
  const int m0 = unit * kUnit + lane;
  const int m_left = half - m0;  // output k exists where k * kStride < m_left
  const bool full = (kPer - 1) * kStride < m_left;
  const float n_last = static_cast<float>(n_unpadded - 1);
  const uintptr_t base = reinterpret_cast<uintptr_t>(ts) - static_cast<uintptr_t>(kMagicBits) * sizeof(float);
  // interleaved indices i = 2(m0 + k kStride) + p, exact float sums of
  // integers below 2^24 (converted one by one for a wide series), and
  // their times i*dt: the same for every template
  float i_f[2][kPer], tt[2][kPer];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      i_f[p][k] = (kWideSeries || k == 0)
                      ? static_cast<float>(2 * (m0 + k * kStride) + p)
                      : __fadd_rn(i_f[p][0], static_cast<float>(2 * k * kStride));
      tt[p][k] = __fmul_rn(i_f[p][k], dt);
    }
  }

  for (int t = 0; t < T; ++t) {
    const float tau = params[4 * t + 0];
    const float omega = params[4 * t + 1];
    const float psi0 = params[4 * t + 2];
    const float s0 = params[4 * t + 3];
    // a bound on |del_t| wherever the LUT argument is in range (there the
    // Taylor step |d| < 0.074 and |s| < 1.01), with room for the roundings;
    // NaN fails every test below
    const float reach = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(fabsf(tau), step_inv), 1.125f), fabsf(s0)), 4.0f);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float scaled[kPer], y[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float phase = __fadd_rn(__fmul_rn(omega, tt[p][k]), psi0);
        scaled[k] = __fmul_rn(c_two_pi[1], phase);
        y[k] = __fadd_rn(__fmul_rn(scaled[k], 64.0f), 0.5f);
      }
      // y is monotone in k (every step is a rounded product or sum with a
      // constant), so its ends bound the whole run
      float v[kPer];
      const bool interior = !kWideSeries && full && below_magic(y[0]) && below_magic(y[kPer - 1]) &&
                            i_f[p][0] >= reach && __fadd_rn(i_f[p][kPer - 1], reach) < __fsub_rn(n_last, 1.0f);
      int last;
      if (kWideSeries)
        last = gather<kWide>(i_f[p], scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
      else if (interior)
        last = gather<kInterior>(i_f[p], scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
      else
        last = gather<kEdge>(i_f[p], scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
      if (apply_renorm) {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (k * kStride < m_left) v[k] = __fmul_rn(v[k], renorm);
      }
      float* row = out + (static_cast<size_t>(t) * 2 + p) * half;
      if (full) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) __stcs(row + m0 + k * kStride, v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (k * kStride < m_left) __stcs(row + m0 + k * kStride, v[k]);
      }
      float acc = v[0];
#pragma unroll
      for (int k = 1; k < kPer; ++k) acc = __fadd_rn(acc, v[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      // a unit wholly interior ends inside the run: its last output
      if (__all_sync(0xffffffffu, interior)) {
        last = unit * kUnit + kUnit - 1;
      } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
      }
      if (lane == 0) {
        const size_t u = (static_cast<size_t>(t) * 2 + p) * n_units + unit;
        unit_sum[u] = acc;
        unit_last[u] = last;
      }
    }
  }
}

// One block per template: n_steps from the unit positions, then per parity
// the halving tree over the unit sums below the cut, the unit that the cut
// crosses re-summed from raw with the mask.  The tree's top levels, while
// more than kTreeMax entries are left, run in place in unit_sum (the
// production series needs none); the rest in shared memory.
__global__ void __launch_bounds__(kFinThreads)
    stats_kernel(const float* __restrict__ raw, float* __restrict__ unit_sum,
                 const int* __restrict__ unit_last, int* __restrict__ n_steps_out,
                 float* __restrict__ mean_out, int half, int n_units, int n_pow2) {
  __shared__ float tree[kTreeMax];
  __shared__ int warp_max[2][kFinThreads / 32];
  __shared__ float parity_sum[2];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int lf[2] = {-1, -1};
  for (int u = tid; u < n_units; u += kFinThreads) {
    lf[0] = max(lf[0], unit_last[(static_cast<size_t>(t) * 2 + 0) * n_units + u]);
    lf[1] = max(lf[1], unit_last[(static_cast<size_t>(t) * 2 + 1) * n_units + u]);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    for (int off = 16; off > 0; off >>= 1)
      lf[p] = max(lf[p], __shfl_xor_sync(0xffffffffu, lf[p], off));
    if (lane == 0) warp_max[p][warp] = lf[p];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    lf[p] = warp_max[p][0];
    for (int w = 1; w < kFinThreads / 32; ++w) lf[p] = max(lf[p], warp_max[p][w]);
  }
  const int n_steps = max(2 * lf[0], 2 * lf[1] + 1);

  for (int p = 0; p < 2; ++p) {
    const int m_cut = n_steps - p <= 0 ? 0 : (n_steps - p + 1) >> 1;  // first m left out
    const int u_cut = m_cut / kUnit;
    const size_t row = (static_cast<size_t>(t) * 2 + p);
    float* g = unit_sum + row * n_units;
    if (warp == 0 && u_cut < n_units) {
      const int m0 = u_cut * kUnit + lane;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int m = m0 + k * kStride;
        const float v = (m < half && m < m_cut) ? raw[row * half + m] : 0.0f;
        acc = k == 0 ? v : __fadd_rn(acc, v);
      }
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      if (lane == 0) g[u_cut] = acc;
    }
    __syncthreads();
    // the tree's leaves: the units below the cut, the cut unit's re-sum,
    // +0.0 above it and past n_units
    const auto leaf = [&](int u) { return u <= u_cut && u < n_units ? g[u] : 0.0f; };
    int len = n_pow2;
    bool leaves = true;
    for (; len > kTreeMax; len >>= 1, leaves = false) {
      const int h = len >> 1;  // < n_units: g[u] exists for every u < h
      for (int u = tid; u < h; u += kFinThreads)
        g[u] = leaves ? __fadd_rn(leaf(u), leaf(u + h)) : __fadd_rn(g[u], g[u + h]);
      __syncthreads();
    }
    for (int u = tid; u < len; u += kFinThreads) tree[u] = leaves ? leaf(u) : g[u];
    __syncthreads();
    for (int h = len >> 1; h > 0; h >>= 1) {
      for (int u = tid; u < h; u += kFinThreads) tree[u] = __fadd_rn(tree[u], tree[u + h]);
      __syncthreads();
    }
    if (tid == 0) parity_sum[p] = tree[0];
    __syncthreads();
  }
  if (tid == 0) {
    n_steps_out[t] = n_steps;
    mean_out[t] = __fdiv_rn(__fadd_rn(parity_sum[0], parity_sum[1]), static_cast<float>(n_steps));
  }
}

}  // namespace

extern "C" int erp_resample_unit() { return kUnit; }

// Loads the sine/cosine tables (64 entries each, host pointers) and the
// two 2*pi constants into this device's constant memory.  Synchronous;
// called once per device before the first launch.
extern "C" int erp_resample_init(int device, const float* sin64,
                                 const float* cos64, const float* two_pi) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  float2 sc[64];
  for (int k = 0; k < 64; ++k) sc[k] = make_float2(sin64[k], cos64[k]);
  e = cudaMemcpyToSymbol(c_sincos, sc, sizeof(sc));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyToSymbol(c_two_pi, two_pi, 2 * sizeof(float));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ts: the interleaved series float32[n_unpadded]; out: float32[T, 2, half];
// params: float32[T, 4] rows (tau, omega, psi0, s0); n_steps: int32[T];
// mean: float32[T]; scratch: unit_sum float32 and unit_last int32, each
// [T, 2, ceil(half / kUnit)].
extern "C" int erp_resample_stream(int device, void* stream, const float* ts,
                                   const float* params,
                                   float* out, int* n_steps, float* mean,
                                   float* unit_sum, int* unit_last, int T,
                                   int half, int n_unpadded, float dt,
                                   float step_inv, float renorm, int apply_renorm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_units = (half + kUnit - 1) / kUnit;
  int n_pow2 = 1;
  while (n_pow2 < n_units) n_pow2 <<= 1;
  const int blocks = (n_units + kUnitsPerBlock - 1) / kUnitsPerBlock;
  const auto kernel = n_unpadded > kMaxNarrow ? stream_kernel<true> : stream_kernel<false>;
  kernel<<<blocks, kThreads, 0, s>>>(ts, params, out, unit_sum, unit_last, T, half, n_units,
                                     n_unpadded, dt, step_inv, renorm, apply_renorm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_kernel<<<T, kFinThreads, 0, s>>>(out, unit_sum, unit_last, n_steps, mean, half,
                                         n_units, n_pow2);
  return static_cast<int>(cudaGetLastError());
}
