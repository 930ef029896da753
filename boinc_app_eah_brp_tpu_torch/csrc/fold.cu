// Kernel C: the 16-harmonic fold into five phase-major run-max levels,
// from float32 power spectra or straight from the complex rfft output.
//
// Replaces the Pallas kernel `_fold_kernel_body`
// (boinc_app_eah_brp_tpu/ops/pallas_sumspec.py, entry `sumspec_pallas_batch`)
// and, for complex input, the |X|^2/N epilogue that the reference package
// fuses into that kernel's producer (`_deinterleave`, same file).
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
// Complex input: power = (re*re + im*im) * (1/nsamples) with every multiply
// and add rounded on its own, DC bin 0 (ops/spectrum.py::power_from_rfft).
//
// What bounds it on the card.  The fold of one template reads the spectrum
// prefix [0, read), read = min(len, 16W + 16) (5,272,848 bins at the
// production workunit, W = 329,552) and writes 5W floats: at T = 32 that is
// 0.466 ms of device-memory bytes for complex input (8 bytes a bin), the
// bound.  What holds it back is the gather: a tile of columns needs its own
// range of the prefix for every multiplier, 136 floats a column, 179 MB a
// template against a 21 MB prefix, an 8.5x re-read inherent to the fold.
// Between a bin's first and last use the fold walks at most 15W columns, so
// the re-read comes from the 50 MB L2 only if one template is folded at a
// time, and then L2 bandwidth bounds the kernel.  The adds and maxima are
// far below the card's float32 rate.  The kernel of the first port read
// that prefix 8.5x through 16 serial load -> barrier -> add phases a tile
// plus 4 more barriers a level, with stride-l shared-memory reads (16-, 8-,
// 4- and 2-way bank conflicts, 3.7x the wavefronts they need), and its
// input was an 805 MB float power tensor written by four eager passes.
//
// What the design does about it.
// - Persistent blocks (kBlocksPerSM per SM, one cooperative launch per
//   batch) walk the templates in order, so one template's prefix is in L2
//   at a time.  Complex input: the power of template t lives in slot t % 2
//   of a scratch of 2 x read floats (42 MB); phase 1 turns a template's
//   complex prefix into power there, each bin once, reading the complex
//   input with a streaming hint; phase 2 folds from the slot; a grid
//   barrier separates them.  Phase 1 of template t+1 rides inside phase 2
//   of template t (one bin a thread per multiplier step, the rest after the
//   block's last tile), so one barrier per template suffices and the
//   device-memory reads of t+1 overlap the L2 reads of t.  The batch's float
//   power tensor (805 MB) is never written.
// - Phase 2: one thread per column (16 running sums in registers), tiles of
//   kCols columns plus one halo column for the wrap.  Every multiplier's
//   range is staged through a ring of kStages shared-memory slots filled
//   with cp.async, three multipliers ahead (across tile edges too), so the
//   loads overlap the adds; one barrier per multiplier.  Each range starts
//   at its 32-byte sector, so every warp's copy covers whole sectors.
// - The slots are skewed by one pad word per 32: the stride-l reads then
//   meet at most 2-way bank conflicts, 1.9x the wavefronts of conflict-free
//   reads against 3.7x unskewed (tests/test_torch_harmonic.py counts them).
// - A level's phase 0 needs the tail of column q-1: a warp shuffle within a
//   warp; across warps through shared memory, written out after the next
//   multiplier's barrier, so the level finish costs no barrier of its own.
// - The five planes are stored with a streaming hint.
// - 256 threads, 2 blocks per SM: ptxas gives the complex-input kernel 111
//   registers and the float one 96, no spills (chip_smoke.py prints the
//   report); 3 blocks would cap a thread at 85.  W / (2 x 132 x 255) = 4.9
//   tiles a block and template, so the per-template barrier idles 2% of the
//   blocks' time (3 blocks: 3.3 tiles, 18%).  Times: PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // columns per tile, halo included
constexpr int kCols = kThreads - 1;  // output columns per tile
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;           // ring depth; divides 16
constexpr int kBlocksPerSM = 2;
constexpr int kSector = 8;           // floats per 32-byte sector

__host__ __device__ constexpr int skew(int e) { return e + (e >> 5); }

constexpr int kRow = skew(kThreads);  // skew(e + kThreads) = skew(e) + kRow
constexpr int kSlotFloats = skew(16 * kThreads + kSector) + 1;
constexpr int kRingBytes = kStages * kSlotFloats * 4;

// multiplier of step n of a tile: the reference accumulation order
__host__ __device__ constexpr int order(int n) {
  const int o[16] = {16, 8, 12, 4, 14, 10, 6, 2, 15, 13, 11, 9, 7, 5, 3, 1};
  return o[n];
}

// max that propagates NaN like torch.maximum / jnp.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float power(float2 v, int i, float scale) {
  const float p = __fmul_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), scale);
  return i == 0 ? 0.0f : p;
}

// 4 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where multiplier L's range of the tile at q0 starts inside its 32-byte
// sector: the range is staged from the sector's start, so that every warp's
// copy covers whole sectors.
template <int L>
__device__ __forceinline__ int shift(const float* src, int q0) {
  const unsigned word = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) >> 2);
  return static_cast<int>((word + static_cast<unsigned>(L * (q0 - 1))) & (kSector - 1));
}

// slot[skew(e)] = src[a + e] for e in [0, L*kThreads + 1 + sh), 0 outside
// [0, read); a = L*(q0-1) - sh is the sector-aligned start of the range
template <int L>
__device__ __forceinline__ void stage_copy(const float* __restrict__ src, int read, int q0, float* slot) {
  const int sh = shift<L>(src, q0);
  const int a = L * (q0 - 1) - sh;
  const int n = L * kThreads + 1 + sh;
  const int tid = threadIdx.x;
  float* d = slot + skew(tid);
  if (a >= 0 && a + n <= read) {  // the whole range lies in the prefix
    const float* p = src + a + tid;
#pragma unroll
    for (int k = 0; k < L; ++k) cp_async4(d + k * kRow, p + k * kThreads, true);
    if (tid < n - L * kThreads) cp_async4(d + L * kRow, p + L * kThreads, true);
  } else {
#pragma unroll
    for (int k = 0; k <= L; ++k) {
      const int e = tid + k * kThreads;
      if (k == L && e >= n) break;
      const int g = a + e;
      const bool ok = g >= 0 && g < read;
      cp_async4(d + k * kRow, ok ? src + g : src, ok);
    }
  }
}

// What one block carries from step to step of its tiles.
struct Fold {
  const float* src;  // the spectrum prefix of this template
  float* o;          // this template's (5, W) planes
  float* ring;
  float* tails;      // [kWarps]: each warp's last column's level tail
  int read, fund_hi, harm_hi, W;
  int q0, q0_next;   // this tile's and the block's next tile's first column (-1: none)
  float run[16];
  float level[16];
  float pend;        // phase 0 of a warp's first column, waiting for tails[warp-1]
  int pend_at;       // where it goes in o (-1: nothing pending)
  // phase 1 of the next template, carried along: this block's bins
  // [ci, cend) of cF are still to be turned into power in cdst
  const float2* cF;
  float* cdst;
  float scale;
  int ci, cend;
  int cidx;          // the bin this thread has loaded into cv (-1: none)
  float2 cv;
};

// One step of the carried phase 1: store the power of the bin loaded one
// step ago, load the next.
__device__ __forceinline__ void convert_step(Fold& f) {
  if (f.cidx >= 0) {
    f.cdst[f.cidx] = power(f.cv, f.cidx, f.scale);
    f.cidx = -1;
  }
  if (f.ci < f.cend) {
    const int i = f.ci + static_cast<int>(threadIdx.x);
    if (i < f.cend) {
      f.cv = __ldcs(f.cF + i);
      f.cidx = i;
    }
    f.ci += kThreads;
  }
}

// Step N of a tile: wait for its slot, refill the slot of step N-1 with
// the step kStages-1 ahead (maybe of the next tile), resolve what waits for
// this barrier, advance the carried phase 1.
template <int N>
__device__ __forceinline__ const float* pipe(Fold& f) {
  cp_wait<kStages - 2>();
  __syncthreads();
  constexpr int M = N + kStages - 1;
  float* slot = f.ring + (M % kStages) * kSlotFloats;
  if constexpr (M < 16) {
    stage_copy<order(M)>(f.src, f.read, f.q0, slot);
  } else {
    if (f.q0_next >= 0) stage_copy<order(M - 16)>(f.src, f.read, f.q0_next, slot);
  }
  cp_commit();
  if (f.pend_at >= 0) {
    const int warp = threadIdx.x >> 5;
    __stcs(f.o + f.pend_at, nan_max(f.tails[warp - 1], f.pend));
    f.pend_at = -1;
  }
  convert_step(f);
  return f.ring + (N % kStages) * kSlotFloats;
}

// level[r] (+)= spectrum term of multiplier L at row r, for this column
template <int L, bool First>
__device__ __forceinline__ void add_terms(const float* slot, const Fold& f, float (&level)[16]) {
  const int x = L * static_cast<int>(threadIdx.x) + shift<L>(f.src, f.q0);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float term = slot[skew(x + ((L * r + 8) >> 4))];
    level[r] = First ? term : __fadd_rn(level[r], term);
  }
}

// running += level; mask; run maxima of level K into plane K
template <int K>
__device__ __forceinline__ void finish_level(Fold& f) {
  constexpr int m = 1 << K;
  constexpr int h = m >> 1;
  constexpr int n_ph = 16 >> K;
  const int lane = threadIdx.x & 31;
  const int q = f.q0 - 1 + static_cast<int>(threadIdx.x);
  float masked[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    f.run[r] = __fadd_rn(f.run[r], f.level[r]);
    masked[r] = (16 * q + r < f.harm_hi) ? f.run[r] : 0.0f;
  }
  // rows of this column that the next column's phase-0 run wraps into
  float tl = masked[16 - h];
#pragma unroll
  for (int r = 16 - h + 1; r < 16; ++r) tl = nan_max(tl, masked[r]);
  if (q < 0) tl = 0.0f;
  const float prev = __shfl_up_sync(0xffffffffu, tl, 1);
  if (lane == 31) f.tails[threadIdx.x >> 5] = tl;
  if (threadIdx.x == 0) return;  // the halo column
  const int Qk = (f.fund_hi + n_ph - 1) / n_ph;
  float* plane = f.o + static_cast<long>(K) * f.W;
  if (q < Qk) {
#pragma unroll
    for (int p = 0; p < n_ph; ++p) {
      const int lo = m * p - h;
      const int hi = m * p + h;
      if (lo < 0) {
        float v = masked[0];
#pragma unroll
        for (int r = 1; r < hi; ++r) v = nan_max(v, masked[r]);
        if (lane == 0) {  // column q-1 is the last of the previous warp
          f.pend = v;
          f.pend_at = K * f.W + q;
        } else {
          __stcs(plane + q, nan_max(prev, v));
        }
      } else {
        float v = masked[lo];
#pragma unroll
        for (int r = lo + 1; r < hi; ++r) v = nan_max(v, masked[r]);
        __stcs(plane + p * Qk + q, v);
      }
    }
  }
  const int pad = n_ph * Qk + q;  // junk slots past the last phase row
  if (pad < f.W) __stcs(plane + pad, 0.0f);
}

// the 16 multipliers of one tile, in the reference order
__device__ __forceinline__ void fold_tile(Fold& f) {
  const float* s;
  s = pipe<0>(f);
  add_terms<16, true>(s, f, f.run);
  s = pipe<1>(f);
  add_terms<8, true>(s, f, f.level);
  finish_level<1>(f);

  s = pipe<2>(f);
  add_terms<12, true>(s, f, f.level);
  s = pipe<3>(f);
  add_terms<4, false>(s, f, f.level);
  finish_level<2>(f);

  s = pipe<4>(f);
  add_terms<14, true>(s, f, f.level);
  s = pipe<5>(f);
  add_terms<10, false>(s, f, f.level);
  s = pipe<6>(f);
  add_terms<6, false>(s, f, f.level);
  s = pipe<7>(f);
  add_terms<2, false>(s, f, f.level);
  finish_level<3>(f);

  s = pipe<8>(f);
  add_terms<15, true>(s, f, f.level);
  s = pipe<9>(f);
  add_terms<13, false>(s, f, f.level);
  s = pipe<10>(f);
  add_terms<11, false>(s, f, f.level);
  s = pipe<11>(f);
  add_terms<9, false>(s, f, f.level);
  s = pipe<12>(f);
  add_terms<7, false>(s, f, f.level);
  s = pipe<13>(f);
  add_terms<5, false>(s, f, f.level);
  s = pipe<14>(f);
  add_terms<3, false>(s, f, f.level);
  s = pipe<15>(f);
  add_terms<1, false>(s, f, f.level);
  const int q = f.q0 - 1 + static_cast<int>(threadIdx.x);
  if (threadIdx.x > 0 && q < f.W) {
    __stcs(f.o + q, q < f.fund_hi ? s[skew(threadIdx.x + shift<1>(f.src, f.q0))] : 0.0f);
  }
  finish_level<4>(f);
}

// ps[i] = power of F[i] for i = first, first + stride, ... < end, four
// loads in flight per thread
__device__ void to_power(const float2* __restrict__ F, float* __restrict__ ps, int first,
                         int end, int stride, float scale) {
  int i = first;
  for (; i + 3 * stride < end; i += 4 * stride) {
    float2 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldcs(F + i + k * stride);
#pragma unroll
    for (int k = 0; k < 4; ++k) ps[i + k * stride] = power(v[k], i + k * stride, scale);
  }
  for (; i < end; i += stride) ps[i] = power(__ldcs(F + i), i, scale);
}

// Phase 2 of one template: this block's tiles b, b + G, ...  With nextF,
// phase 1 of the next template rides along: the block turns its share of
// nextF's prefix into power in next_ps, one bin a thread per step, and
// what is left after its last tile at the end.
__device__ void fold_template(const float* src, int read, float* o, float* ring, float* tails,
                              int fund_hi, int harm_hi, int W, const float2* nextF,
                              float* next_ps, float scale) {
  const int n_tiles = (W + kCols - 1) / kCols;
  Fold f;
  f.src = src;
  f.o = o;
  f.ring = ring;
  f.tails = tails;
  f.read = read;
  f.fund_hi = fund_hi;
  f.harm_hi = harm_hi;
  f.W = W;
  f.pend_at = -1;
  f.cF = nextF;
  f.cdst = next_ps;
  f.scale = scale;
  f.cidx = -1;
  f.ci = f.cend = 0;
  if (nextF != nullptr) {
    const int share = kThreads * ((read + gridDim.x * kThreads - 1) / (gridDim.x * kThreads));
    f.ci = static_cast<int>(blockIdx.x) * share;
    f.cend = min(read, f.ci + share);
  }
  int tile = blockIdx.x;
  if (tile < n_tiles) {
    f.q0 = tile * kCols;
    __syncthreads();  // the ring's last readers are done
    static_assert(kStages == 4, "the prologue stages steps 0..2");
    stage_copy<order(0)>(src, read, f.q0, ring);
    cp_commit();
    stage_copy<order(1)>(src, read, f.q0, ring + kSlotFloats);
    cp_commit();
    stage_copy<order(2)>(src, read, f.q0, ring + 2 * kSlotFloats);
    cp_commit();
    for (; tile < n_tiles; tile += gridDim.x) {
      f.q0 = tile * kCols;
      const int next = tile + static_cast<int>(gridDim.x);
      f.q0_next = next < n_tiles ? next * kCols : -1;
      fold_tile(f);
    }
    cp_wait<0>();
    __syncthreads();
    if (f.pend_at >= 0) {
      __stcs(o + f.pend_at, nan_max(tails[(threadIdx.x >> 5) - 1], f.pend));
    }
  }
  if (f.cidx >= 0) f.cdst[f.cidx] = power(f.cv, f.cidx, f.scale);
  if (f.ci < f.cend) {
    to_power(f.cF, f.cdst, f.ci + static_cast<int>(threadIdx.x), f.cend, kThreads, f.scale);
  }
}

template <bool Complex>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    fold_kernel(const void* __restrict__ in, float* __restrict__ scratch, float* __restrict__ out,
                int T, int len, int read, int fund_hi, int harm_hi, int W, float scale) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float tails[kWarps];
  const long plane_len = 5L * W;
  if constexpr (Complex) {
    // scratch: two power slots of `read` floats, template t in slot t % 2
    cg::grid_group grid = cg::this_grid();
    const float2* F = static_cast<const float2*>(in);
    const int stride = static_cast<int>(gridDim.x) * kThreads;
    to_power(F, scratch, static_cast<int>(blockIdx.x * kThreads + threadIdx.x), read, stride,
             scale);
    grid.sync();
    for (int t = 0; t < T; ++t) {
      const bool more = t + 1 < T;
      fold_template(scratch + (t & 1) * static_cast<long>(read), read, out + t * plane_len, ring,
                    tails, fund_hi, harm_hi, W, more ? F + (t + 1) * static_cast<long>(len) : nullptr,
                    scratch + ((t + 1) & 1) * static_cast<long>(read), scale);
      if (more) grid.sync();
    }
  } else {
    const float* ps = static_cast<const float*>(in);
    for (int t = 0; t < T; ++t) {
      fold_template(ps + static_cast<long>(t) * len, read, out + t * plane_len, ring, tails,
                    fund_hi, harm_hi, W, nullptr, nullptr, 1.0f);
    }
  }
}

template <bool Complex>
int launch(int device, void* stream, const void* in, float* scratch, float* out, int T, int len,
           int read, int fund_hi, int harm_hi, int W, float scale) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kernel = reinterpret_cast<const void*>(&fold_kernel<Complex>);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, &fold_kernel<Complex>, kThreads,
                                                    kRingBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM) * sms;
  void* args[] = {&in, &scratch, &out, &T, &len, &read, &fund_hi, &harm_hi, &W, &scale};
  e = cudaLaunchCooperativeKernel(kernel, blocks, kThreads, args, kRingBytes,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int erp_fold_cols() { return kCols; }

// ps: float32[T, len]; out: float32[T, 5, W]; read = min(len, 16W + 16).
extern "C" int erp_fold(int device, void* stream, const float* ps, float* out, int T, int len,
                        int read, int fund_hi, int harm_hi, int W) {
  return launch<false>(device, stream, ps, nullptr, out, T, len, read, fund_hi, harm_hi, W, 1.0f);
}

// F: complex64[T, len] as float2; scratch: float32[2 * read]; out:
// float32[T, 5, W]; scale = float32(1 / nsamples).
extern "C" int erp_fold_spectrum(int device, void* stream, const void* F, float* scratch,
                                 float* out, int T, int len, int read, int fund_hi, int harm_hi,
                                 int W, float scale) {
  return launch<true>(device, stream, F, scratch, out, T, len, read, fund_hi, harm_hi, W, scale);
}
