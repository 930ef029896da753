// Kernel A: the orbital resampler and its batch statistics, one call for a
// batch of templates.  The file also holds the exact pad mean of
// unwhitened runs (exact_mean_kernel, after A), which makes A's samples
// with A's own device functions.
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
// The exact-sine instantiation (kExact, chosen at launch; --exact-sin, the
// JAX package's use_lut=False, boinc_app_eah_brp_tpu/ops/resample.py
// `_del_t`, which XLA runs: no Pallas kernel stands behind it) takes
//   s = sinf(phase)
// in place of the LUT sine; the phase, del_t, nearest-index and statistics
// chain is the same code.  CUDA's sinf (libdevice) is exact to ~1 ulp;
// its Cody-Waite reduction and polynomial use explicit fused multiply-adds
// that -fmad=false does not touch, so it is the same function as
// torch.sin on a float32 CUDA tensor.  Above |phase| ~ 105,615 rad sinf
// takes its Payne-Hanek reduction (local memory): at t_obs 274.6 s every
// P_orb below ~16 ms.  What bounds it: the same bytes as the LUT kernel,
// and ~18 float32 instructions and 2 conversions a sample for the sine in
// place of the LUT's 14 (argument 3, index 2, Taylor 9), ~50 more on the
// slow path (runtime/roofline.py).
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
// With kExact, scaled holds the phase itself and y is 0 (sine_args).
template <Path kPath, bool kExact>
__device__ __forceinline__ int gather(const float (&i_f)[kPer], const float (&scaled)[kPer],
                                      const float (&y)[kPer], float tau, float s0,
                                      float step_inv, float n_last, int n_unpadded, int m0,
                                      int m_left, uintptr_t base, float (&v)[kPer]) {
  int last = -1;
  unsigned bits[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    float s;
    if (kExact) {
      s = sinf(scaled[k]);
    } else {
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
      s = __fsub_rn(__fadd_rn(sc.x, __fmul_rn(d, sc.y)), __fmul_rn(d2, sc.x));
    }
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

// The interleaved indices i = 2(m0 + k kStride) + p of a thread's kPer
// outputs of parity p, exact float sums of integers below 2^24 (converted
// one by one for a wide series), and their times i*dt.
template <bool kWideSeries>
__device__ __forceinline__ void index_times(int m0, int p, float dt, float (&i_f)[kPer], float (&tt)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    i_f[k] = (kWideSeries || k == 0) ? static_cast<float>(2 * (m0 + k * kStride) + p)
                                     : __fadd_rn(i_f[0], static_cast<float>(2 * k * kStride));
    tt[k] = __fmul_rn(i_f[k], dt);
  }
}

// A bound on |del_t| wherever the LUT argument is in range (there the
// Taylor step |d| < 0.074 and |s| < 1.01), with room for the roundings;
// NaN fails every test it enters.
__device__ __forceinline__ float reach_of(float tau, float s0, float step_inv) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(fabsf(tau), step_inv), 1.125f), fabsf(s0)), 4.0f);
}

// The phase of each output, as a fraction of a turn and as the LUT
// argument y.  y is monotone in k (every step is a rounded product or sum
// with a constant), so its ends bound the whole run.  With kExact, the
// phase itself and y = 0 (no table: every y test passes).
template <bool kExact>
__device__ __forceinline__ void sine_args(const float (&tt)[kPer], float omega, float psi0,
                                          float (&scaled)[kPer], float (&y)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float phase = __fadd_rn(__fmul_rn(omega, tt[k]), psi0);
    if (kExact) {
      scaled[k] = phase;
      y[k] = 0.0f;
    } else {
      scaled[k] = __fmul_rn(c_two_pi[1], phase);
      y[k] = __fadd_rn(__fmul_rn(scaled[k], 64.0f), 0.5f);
    }
  }
}

// One template's samples of parity p at a thread's kPer outputs (no
// renorm), by the path stream_kernel takes for them (the test-free path
// where its contract holds), so bit for bit kernel A's.  stream_kernel
// keeps its own copy of this choice inline: calling this cost it three
// registers.
template <bool kWideSeries, bool kExact>
__device__ __forceinline__ void samples(const float (&i_f)[kPer], const float (&tt)[kPer], float tau,
                                        float omega, float psi0, float s0, float reach, float step_inv,
                                        float n_last, int n_unpadded, int m0, int m_left, bool full,
                                        uintptr_t base, float (&v)[kPer]) {
  float scaled[kPer], y[kPer];
  sine_args<kExact>(tt, omega, psi0, scaled, y);
  const bool interior = !kWideSeries && full && below_magic(y[0]) && below_magic(y[kPer - 1]) &&
                        i_f[0] >= reach && __fadd_rn(i_f[kPer - 1], reach) < __fsub_rn(n_last, 1.0f);
  if (kWideSeries)
    gather<kWide, kExact>(i_f, scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
  else if (interior)
    gather<kInterior, kExact>(i_f, scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
  else
    gather<kEdge, kExact>(i_f, scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
}

template <bool kWideSeries, bool kExact>
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
  // the indices and times of this thread's outputs: the same for every
  // template
  float i_f[2][kPer], tt[2][kPer];
#pragma unroll
  for (int p = 0; p < 2; ++p) index_times<kWideSeries>(m0, p, dt, i_f[p], tt[p]);

  for (int t = 0; t < T; ++t) {
    const float tau = params[4 * t + 0];
    const float omega = params[4 * t + 1];
    const float psi0 = params[4 * t + 2];
    const float s0 = params[4 * t + 3];
    const float reach = reach_of(tau, s0, step_inv);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float scaled[kPer], y[kPer];
      sine_args<kExact>(tt[p], omega, psi0, scaled, y);
      float v[kPer];
      const bool interior = !kWideSeries && full && below_magic(y[0]) && below_magic(y[kPer - 1]) &&
                            i_f[p][0] >= reach && __fadd_rn(i_f[p][kPer - 1], reach) < __fsub_rn(n_last, 1.0f);
      int last;
      if (kWideSeries)
        last = gather<kWide, kExact>(i_f[p], scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
      else if (interior)
        last = gather<kInterior, kExact>(i_f[p], scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
      else
        last = gather<kEdge, kExact>(i_f[p], scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, m_left, base, v);
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

// ---------------------------------------------------------------------
// The exact (serial) pad mean of unwhitened runs, for a whole bank ahead
// of the search.
//
// No Pallas kernel stands behind this one: the JAX package computes it on
// the host, per template, ahead of each batch (boinc_app_eah_brp_tpu/
// models/search.py `host_exact_mean_params` fed by `ExactMeanPrefetch`;
// oracle/resample.py `resample_stats`, demod_binary_resamp_cpu.c:105-121):
//
//   n_steps[t] = the start of the trailing run, kernel A's n_steps
//   mean[t]    = (sum over i < n_steps[t] of the gathered sample i, added
//                 strictly in order i = 0, 1, 2, ... in float32)
//                / (float) n_steps[t]                  (0.0 if n_steps <= 0)
//
// Every add rounds on its own (__fadd_rn) and the division is IEEE
// (__fdiv_rn): bitwise the oracle's np.add.accumulate chain.  The samples
// are made here from ts by kernel A's own code (samples / gather above),
// not read from A's output, so they are A's bit for bit and the means of
// a whole bank need no batch's resample to exist yet.
//
// What bounds it on the card, at the production width (n = 2^22):
// - the chain: a template is ~4.19M dependent float adds, 4 cycles each,
//   ~8.5 ms at 1.98 GHz however many templates run beside it.  No other
//   order of the adds rounds the same, so nothing inside a template runs
//   in parallel;
// - issue: each sample costs kernel A's ~24 float32 instructions (~34
//   with addresses, the gather and its shared-memory store) plus its one
//   add: ~1.1 warp instructions a sample, so 200 templates need ~0.9 ms
//   of the card's issue, 6,600 templates ~28 ms;
// - bytes: ts read once (16.8 MB), 0.005 ms.
//
// What the design does about it: one launch takes every template of the
// bank.  A block holds G <= 32 templates (G chosen at launch so that the
// blocks spread over every SM: 2 for bank200, 25 for 6,600 templates);
// lane g of warp 0 runs template g's chain and does nothing else, its
// operands read four at a time from shared memory into two register sets
// that take turns, one group ahead of the adds.  Every other instruction
// in the chain's warp, and every warp that shares its scheduler, delays
// an add now and then; so in a launch held by its chains (at most
// kQuietChains templates a block) the warps on warp 0's scheduler make no
// samples.  The producer warps (kProducers, 12 of them in such a launch)
// make the samples of the next stage (U units of both parities a
// template, in order) into the other half of a double buffer while the
// chains add the current one, one barrier a stage; samples at or past n_steps are stored as -0.0, which adds as the
// identity (x + -0.0 == x for every x), so every chain runs the same
// loop.  n_steps comes first, from a walk down from the end of the series
// a unit at a time (both parities, kernel A's trailing-run test on every
// output), which stops at the first unit holding a position: the trailing
// run is at most ~|del_t| long.  So a launch of N templates takes about
// one chain floor while N is small (bank200) and the issue bound when it
// is large.

constexpr int kProducers = 16;                      // sample-making warps of a block
constexpr int kMeanThreads = 32 * (kProducers + 1);  // + warp 0, the chains
constexpr int kMaxChains = 32;                      // templates of a block: one a lane of warp 0
constexpr int kMaxStageUnits = 4;                   // units of a template in one stage
constexpr int kRowPad = 4;  // floats after a row: lanes' float4 reads meet no bank conflict
constexpr int kGroup = 8;   // float4 operands a chain reads ahead of its adds
// a launch of at most this many templates a block is held by its chains:
// the warps that share warp 0's scheduler (warp % 4 == 0) then make no
// samples, so the chains' adds issue undisturbed
constexpr int kQuietChains = 8;

// The row of template g in a buffer half holds the 2 * kUnit * U samples
// of one stage, in order.
template <bool kWideSeries, bool kExact>
__global__ void __launch_bounds__(kMeanThreads)
    exact_mean_kernel(const float* __restrict__ ts, const float* __restrict__ params,
                      int* __restrict__ n_steps_out, float* __restrict__ mean_out, int N, int G,
                      int U, int half, int n_units, int n_unpadded, float dt, float step_inv) {
  extern __shared__ __align__(16) float buf[];  // [2][G][row]
  __shared__ float s_par[kMaxChains][4];
  __shared__ int s_n[kMaxChains];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * G;
  const int g_here = min(G, N - t0);
  const int stage = 2 * kUnit * U;  // samples of a template in one stage
  const int row = stage + kRowPad;
  const float n_last = static_cast<float>(n_unpadded - 1);
  const uintptr_t base = reinterpret_cast<uintptr_t>(ts) - static_cast<uintptr_t>(kMagicBits) * sizeof(float);

  if (threadIdx.x < 4 * g_here) s_par[threadIdx.x >> 2][threadIdx.x & 3] = params[4 * t0 + threadIdx.x];
  __syncthreads();

  // n_steps = max(2 lf_0, 2 lf_1 + 1), lf_p the largest output of parity p
  // whose i - del_t < n-1: producer warp w walks templates w, w + kProducers, ...
  if (warp > 0) {
    for (int g = warp - 1; g < g_here; g += kProducers) {
      const float tau = s_par[g][0], omega = s_par[g][1], psi0 = s_par[g][2], s0 = s_par[g][3];
      int lf[2] = {-1, -1};
      for (int u = n_units - 1; u >= 0 && (lf[0] < 0 || lf[1] < 0); --u) {
        const int m0 = u * kUnit + lane;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (lf[p] >= 0) continue;  // warp-uniform
          float i_f[kPer], tt[kPer], scaled[kPer], y[kPer], v[kPer];
          index_times<kWideSeries>(m0, p, dt, i_f, tt);
          sine_args<kExact>(tt, omega, psi0, scaled, y);
          int last = kWideSeries
                         ? gather<kWide, kExact>(i_f, scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, half - m0, base, v)
                         : gather<kEdge, kExact>(i_f, scaled, y, tau, s0, step_inv, n_last, n_unpadded, m0, half - m0, base, v);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
          lf[p] = last;
        }
      }
      if (lane == 0) s_n[g] = max(2 * lf[0], 2 * lf[1] + 1);
    }
  }
  __syncthreads();

  int n_max = 0;
  for (int g = 0; g < g_here; ++g) n_max = max(n_max, s_n[g]);
  const int n_stages = (n_max + stage - 1) / stage;  // block-uniform

  // producer number prod of n_prod (-1: none)
  const bool quiet = G <= kQuietChains;
  const int n_prod = quiet ? kProducers - kProducers / 4 : kProducers;
  const int prod = !quiet ? warp - 1 : warp % 4 == 0 ? -1 : warp - 1 - warp / 4;
  // the samples of stage s of every template, into buffer half dst; an
  // item is one unit (both parities) of one template
  const auto produce = [&](int s, float* dst) {
    if (prod < 0) return;
    for (int item = prod; item < g_here * U; item += n_prod) {
      const int g = item / U;
      const int j = item - g * U;
      const float tau = s_par[g][0], omega = s_par[g][1], psi0 = s_par[g][2], s0 = s_par[g][3];
      const float reach = reach_of(tau, s0, step_inv);
      const int n = s_n[g];
      const int m0 = (s * U + j) * kUnit + lane;
      const int m_left = half - m0;
      const bool full = (kPer - 1) * kStride < m_left;
      float v[2][kPer];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float i_f[kPer], tt[kPer];
        index_times<kWideSeries>(m0, p, dt, i_f, tt);
        samples<kWideSeries, kExact>(i_f, tt, tau, omega, psi0, s0, reach, step_inv, n_last, n_unpadded, m0, m_left,
                             full, base, v[p]);
      }
      float* r = dst + g * row + j * 2 * kUnit;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = 2 * (m0 + k * kStride);  // the even sample's index
        *reinterpret_cast<float2*>(r + 2 * (lane + k * kStride)) =
            make_float2(i < n ? v[0][k] : -0.0f, i + 1 < n ? v[1][k] : -0.0f);
      }
    }
  };

  float* const half_buf[2] = {buf, buf + G * row};
  if (n_stages > 0) {
    if (warp > 0) produce(0, half_buf[0]);
    __syncthreads();
  }
  // -0.0 + x == x for every x, so the first add gives sample 0 exactly, as
  // the accumulate's first element is
  float acc = -0.0f;
  for (int s = 0; s < n_stages; ++s) {
    if (warp > 0) {
      if (s + 1 < n_stages) produce(s + 1, half_buf[(s + 1) & 1]);
    } else if (lane < g_here) {
      // operands a group of kGroup float4 ahead of the adds, in two
      // register sets that take turns (no copies between them)
      const float4* q = reinterpret_cast<const float4*>(half_buf[s & 1] + lane * row);
      const int n4 = stage / 4;  // a multiple of 2 * kGroup
      float4 a[kGroup], b[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) a[j] = q[j];
      for (int k = 0; k < n4; k += 2 * kGroup) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) b[j] = q[k + kGroup + j];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          acc = __fadd_rn(acc, a[j].x);
          acc = __fadd_rn(acc, a[j].y);
          acc = __fadd_rn(acc, a[j].z);
          acc = __fadd_rn(acc, a[j].w);
        }
        const int ka = min(k + 2 * kGroup, n4 - kGroup);  // the last turn reads its group again
#pragma unroll
        for (int j = 0; j < kGroup; ++j) a[j] = q[ka + j];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          acc = __fadd_rn(acc, b[j].x);
          acc = __fadd_rn(acc, b[j].y);
          acc = __fadd_rn(acc, b[j].z);
          acc = __fadd_rn(acc, b[j].w);
        }
      }
    }
    __syncthreads();  // the next stage is in; this one may be overwritten
  }
  if (warp == 0 && lane < g_here) {
    const int n = s_n[lane];
    n_steps_out[t0 + lane] = n;
    mean_out[t0 + lane] = n > 0 ? __fdiv_rn(acc, static_cast<float>(n)) : 0.0f;
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
// [T, 2, ceil(half / kUnit)]; exact_sin: the sinf instantiation.
extern "C" int erp_resample_stream(int device, void* stream, const float* ts,
                                   const float* params,
                                   float* out, int* n_steps, float* mean,
                                   float* unit_sum, int* unit_last, int T,
                                   int half, int n_unpadded, float dt,
                                   float step_inv, float renorm, int apply_renorm,
                                   int exact_sin) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_units = (half + kUnit - 1) / kUnit;
  int n_pow2 = 1;
  while (n_pow2 < n_units) n_pow2 <<= 1;
  const int blocks = (n_units + kUnitsPerBlock - 1) / kUnitsPerBlock;
  const bool wide = n_unpadded > kMaxNarrow;
  const auto kernel = exact_sin ? (wide ? stream_kernel<true, true> : stream_kernel<false, true>)
                                : (wide ? stream_kernel<true, false> : stream_kernel<false, false>);
  kernel<<<blocks, kThreads, 0, s>>>(ts, params, out, unit_sum, unit_last, T, half, n_units,
                                     n_unpadded, dt, step_inv, renorm, apply_renorm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_kernel<<<T, kFinThreads, 0, s>>>(out, unit_sum, unit_last, n_steps, mean, half,
                                         n_units, n_pow2);
  return static_cast<int>(cudaGetLastError());
}

// ts: the interleaved series float32[n_unpadded]; params: float32[N, 4]
// rows (tau, omega, psi0, s0); n_steps: int32[N] and mean: float32[N]
// (out); exact_sin: the sinf instantiation.  Needs erp_resample_init on
// this device first.
extern "C" int erp_exact_mean(int device, void* stream, const float* ts, const float* params,
                              int* n_steps, float* mean, int N, int n_unpadded, float dt,
                              float step_inv, int exact_sin) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as few templates a block as fill every SM, in as few rounds of at
  // most kMaxChains templates an SM as N needs
  const int rounds = (N + sms * kMaxChains - 1) / (sms * kMaxChains);
  const int G = (N + sms * rounds - 1) / (sms * rounds);
  const int U = max(1, min(kMaxStageUnits, kMaxChains / G));
  const int half = n_unpadded / 2;
  const int n_units = (half + kUnit - 1) / kUnit;
  const size_t smem = 2 * static_cast<size_t>(G) * (2 * kUnit * U + kRowPad) * sizeof(float);
  const bool wide = n_unpadded > kMaxNarrow;
  const auto kernel = exact_sin ? (wide ? exact_mean_kernel<true, true> : exact_mean_kernel<false, true>)
                                : (wide ? exact_mean_kernel<true, false> : exact_mean_kernel<false, false>);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(N + G - 1) / G, kMeanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ts, params, n_steps, mean, N, G, U, half, n_units, n_unpadded, dt, step_inv);
  return static_cast<int>(cudaGetLastError());
}
