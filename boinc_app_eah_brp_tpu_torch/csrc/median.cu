// The whitening's sliding median on the card: out[m] is the median of
// x[m, m + w), the two central order statistics' float32 midpoint for an
// even window.
//
// Replaces the reference package's device running median `_running_median`
// (boinc_app_eah_brp_tpu/ops/median.py, entry `running_median`), a blocked
// sort of every window that XLA runs; no Pallas kernel.  It computes the
// same function, not the same sort: bitwise the plain version
// (ops/median.py::running_median_plain, a torch.sort of every window).
//
// What bounds it on the card.  The function moves (n + n_out) x 4 bytes,
// 0.015 ms at the production spectrum (n 6,291,457, w 1000); the
// arithmetic is order statistics, compares and counts, no float math but
// the midpoint.  This algorithm's work is the walk below, about
// n_out x (w/2) x (TILE + w - 1) / w steps (6.3e9 at production), and the
// sort of each tile's union, both in shared memory: issue and
// shared-memory bound, far above the bytes.
//
// The design.  A block owns a tile of kTile consecutive outputs and needs
// the kTile + w - 1 inputs they read.  Each input becomes one 64-bit entry,
// its key (the float's bits mapped so that unsigned order is float order:
// exact for every non-NaN float, and the spectrum is non-negative) above
// its position in the tile; padding entries are all ones, so they sort
// last and their position is in no window.  The block sorts the entries
// once with a bitonic network.  Thread t (output m = tile start + t) then
// walks the sorted entries in order, counting those whose position lies in
// [t, t + w), up to the central rank or ranks; all threads of a warp read
// the same entry at a step (a broadcast, no bank conflict).  The even
// window's midpoint is __fmul_rn(__fadd_rn(lo, hi), 0.5f), the plain
// version's (a + b) * 0.5.
// - median_shared_kernel: the sorted union in dynamic shared memory,
//   next_pow2(kTile + w - 1) <= kSharedEntries entries (128 KB), so
//   w <= 15,361; at the production window 2,048 entries, 16 KB a block,
//   two blocks of 1,024 threads on an SM.
// - median_global_kernel: wider windows (the command line takes up to
//   250,000).  Persistent blocks walk the tiles; each block's union lives
//   in a scratch of its own in device memory that the wrapper allocates,
//   and is sorted there: the network's strides of kChunk and more pass
//   over device memory (one barrier a stride), the shorter ones run on a
//   kChunk-entry chunk staged in shared memory.
// One entry, erp_median, picks the instantiation by the window, launches it
// on the caller's stream and returns cudaGetLastError();
// erp_median_scratch_entries says how much scratch it needs.  Times:
// PERF.md.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;           // one output a thread
constexpr int kTile = kThreads;          // outputs a block
constexpr int kSharedEntries = 1 << 14;  // the shared instantiation's largest union (128 KB)
constexpr int kChunk = 1 << 12;          // the global instantiation's shared chunk (32 KB)
constexpr u64 kPad = ~0ull;

__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the entries of positions [c, c + count) of the tile that starts at input
// o0: position i holds x[o0 + i] while i < kTile + w - 1 and the input
// exists, padding after
__device__ __forceinline__ void load_entries(const float* __restrict__ x, u64* a, long long o0, int c,
                                             int count, int n, int w) {
  const int M = kTile + w - 1;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int pos = c + i;
    const long long g = o0 + pos;
    a[i] = (pos < M && g < n) ? (static_cast<u64>(key_of(x[g])) << 32) | static_cast<u64>(pos) : kPad;
  }
}

// step (k, j) of the bitonic network over a[0, n); `base` is a[0]'s index
// in the whole sequence, which sets each run's direction
__device__ __forceinline__ void bitonic_step(u64* a, int n, int k, int j, int base) {
  for (int p = threadIdx.x; p < (n >> 1); p += kThreads) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int l = i | j;
    const bool up = ((base + i) & k) == 0;
    const u64 lo = a[i], hi = a[l];
    if ((lo > hi) == up) {
      a[i] = hi;
      a[l] = lo;
    }
  }
}

// the network's levels of run length k0 .. k1 (powers of two), each from
// stride min(k, top) / 2 down to 1, on n entries at sequence index `base`
__device__ void bitonic_levels(u64* a, int n, int base, int k0, int k1, int top) {
  for (int k = k0; k <= k1; k <<= 1) {
    for (int j = min(k, top) >> 1; j > 0; j >>= 1) {
      bitonic_step(a, n, k, j, base);
      __syncthreads();
    }
  }
}

// the median of output t of a tile from its P sorted entries.  The loop
// always ends at the central rank, before j reaches P, and is bounded by P
// all the same: built without the bound (nvcc 12.8, sm_90a), every thread
// of a block past the first returned wrong medians
__device__ __forceinline__ float walk(const u64* a, int P, uint32_t t, uint32_t w) {
  const int k_hi = static_cast<int>(w >> 1);
  const int k_lo = (w & 1) ? k_hi : k_hi - 1;
  int count = 0;
  uint32_t lo = 0, hi = 0;
  for (int j = 0; j < P; ++j) {
    const u64 e = a[j];
    if (static_cast<uint32_t>(e) - t < w) {
      if (count == k_lo) lo = static_cast<uint32_t>(e >> 32);
      if (count == k_hi) {
        hi = static_cast<uint32_t>(e >> 32);
        break;
      }
      ++count;
    }
  }
  if (w & 1) return value_of(hi);
  return __fmul_rn(__fadd_rn(value_of(lo), value_of(hi)), 0.5f);
}

__global__ void __launch_bounds__(kThreads)
    median_shared_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int n_out,
                         int w, int P) {
  extern __shared__ u64 s[];
  const long long o0 = static_cast<long long>(blockIdx.x) * kTile;
  load_entries(x, s, o0, 0, P, n, w);
  __syncthreads();
  bitonic_levels(s, P, 0, 2, P, P);
  const long long o = o0 + threadIdx.x;
  if (o < n_out) out[o] = walk(s, P, threadIdx.x, static_cast<uint32_t>(w));
}

__global__ void __launch_bounds__(kThreads)
    median_global_kernel(const float* __restrict__ x, u64* scratch, float* __restrict__ out, int n,
                         int n_out, int w, int P) {
  __shared__ u64 s[kChunk];
  u64* a = scratch + static_cast<size_t>(blockIdx.x) * P;
  const int n_tiles = (n_out + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long o0 = static_cast<long long>(tile) * kTile;
    // the first log2(kChunk) levels on each chunk alone
    for (int c = 0; c < P; c += kChunk) {
      load_entries(x, s, o0, c, kChunk, n, w);
      __syncthreads();
      bitonic_levels(s, kChunk, c, 2, kChunk, kChunk);
      for (int i = threadIdx.x; i < kChunk; i += kThreads) a[c + i] = s[i];
      __syncthreads();
    }
    // the longer runs: strides >= kChunk over device memory, the rest per chunk
    for (int k = kChunk << 1; k <= P; k <<= 1) {
      for (int j = k >> 1; j >= kChunk; j >>= 1) {
        bitonic_step(a, P, k, j, 0);
        __syncthreads();
      }
      for (int c = 0; c < P; c += kChunk) {
        for (int i = threadIdx.x; i < kChunk; i += kThreads) s[i] = a[c + i];
        __syncthreads();
        bitonic_levels(s, kChunk, c, k, k, kChunk);
        for (int i = threadIdx.x; i < kChunk; i += kThreads) a[c + i] = s[i];
        __syncthreads();
      }
    }
    const long long o = o0 + threadIdx.x;
    if (o < n_out) out[o] = walk(a, P, threadIdx.x, static_cast<uint32_t>(w));
    __syncthreads();  // every walk is done before the next tile overwrites the scratch
  }
}

// the entries of a tile's union: next_pow2(kTile + w - 1)
int union_entries(int w) {
  int P = 1;
  while (P < kTile + w - 1) P <<= 1;
  return P;
}

// the device-memory instantiation's persistent blocks: two an SM, at most
// one a tile; 0 with an error in *e
int global_grid(int device, int n_out, cudaError_t* e) {
  int sms = 0;
  *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*e != cudaSuccess) return 0;
  const int tiles = (n_out + kTile - 1) / kTile;
  return tiles < 2 * sms ? tiles : 2 * sms;
}

}  // namespace

// int64 entries of device-memory scratch that erp_median needs for n inputs
// and window w: 0 where a tile's union fits shared memory (the shared
// instantiation runs), else one union a persistent block; minus the CUDA
// error on a failed query
extern "C" int erp_median_scratch_entries(int device, int n, int w) {
  const int P = union_entries(w);
  if (P <= kSharedEntries) return 0;
  cudaError_t e;
  const int grid = global_grid(device, n - w + 1, &e);
  return e == cudaSuccess ? grid * P : -static_cast<int>(e);
}

// x: float32[n]; out: float32[n - w + 1], 1 <= w <= n; scratch: int64 of
// erp_median_scratch_entries(device, n, w) entries (unused when that is 0).
// Picks the instantiation by the window.
extern "C" int erp_median(int device, void* stream, const float* x, void* scratch, float* out, int n,
                          int w) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = n - w + 1;
  const int P = union_entries(w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= kSharedEntries) {
    const int smem = P * static_cast<int>(sizeof(u64));
    e = cudaFuncSetAttribute(median_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    median_shared_kernel<<<(n_out + kTile - 1) / kTile, kThreads, smem, st>>>(x, out, n, n_out, w, P);
  } else {
    const int grid = global_grid(device, n_out, &e);
    if (e != cudaSuccess) return static_cast<int>(e);
    median_global_kernel<<<grid, kThreads, 0, st>>>(x, static_cast<u64*>(scratch), out, n, n_out, w, P);
  }
  return static_cast<int>(cudaGetLastError());
}
