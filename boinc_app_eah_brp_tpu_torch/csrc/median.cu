// The whitening's sliding median on the card: out[m] is the median of
// x[m, m + w), the two central order statistics' float32 midpoint for an
// even window.
//
// Replaces the reference package's device running median `_running_median`
// (boinc_app_eah_brp_tpu/ops/median.py:57, entry `running_median`), a
// blocked sort of every window that XLA runs; no Pallas kernel.  It
// computes the same function, not the same sort: bitwise the plain version
// (ops/median.py::running_median_plain, a torch.sort of every window).
//
// What bounds it on the card.  The function moves (n + n_out) x 4 bytes,
// 0.015 ms at the production spectrum (n 6,291,457, w 1000); the
// arithmetic is order statistics, compares and counts, no float math but
// the midpoint.  The kernel's own work is a sort of each tile's union and
// the walks over it, in shared memory: issue and shared-memory bound, far
// above the bytes (runtime/roofline.py::median_steps counts it).  A walk
// of the sorted union from index 0 for every output would read ~1,000
// entries an output (6.4e9 at production); this kernel carries each
// median along a run of outputs instead, and the sort, then most of the
// time, keeps its short strides in registers.
//
// The tile.  A block owns a tile of T consecutive outputs and needs the
// T + w - 1 inputs they read, the union.  Each input becomes one 64-bit
// entry, its key (the float's bits mapped so that unsigned order is float
// order: exact for every non-NaN float) above its position in the tile;
// padding entries are all ones, so they sort last and their position is in
// no window.  Key above position is a total order, so ties need no special
// case and every window's order statistics are the plain version's.  The
// block sorts the entries once (a bitonic network whose comparators all
// point one way: each merge starts with a mirror stage) and scatters a
// rank map, rank[position] = sorted index (16-bit in shared memory, 32-bit
// in device memory).  In shared memory the network's strides below 32 run
// in registers, 32 entries a thread, and the longer ones over shared
// memory, two strides a pass where they can; while it sorts, the array is
// kept XOR-swizzled (swz) so that both access patterns are free of bank
// conflicts.
//
// The runs.  Neighbouring outputs' windows differ by one entry leaving and
// one entering, so each thread owns a run of R consecutive outputs and
// carries its median along it: j, the index of the in-window entry with
// k_lo in-window entries below it (k_lo = (w - 1) / 2 odd, w / 2 - 1 even).
// For the run's first output the thread walks to j from J, the sorted
// index where the central entry is expected, eight entries a step, up or
// down from the count of its window's entries below J; a bit mask of the
// positions whose entries lie below J and its prefix sums give that count
// with two lookups (count_below).  From window [t, t + w) to [t + 1, t + 1
// + w) the entry at rank[t] leaves and the one at rank[t + w] enters; the
// in-window entries below j become c = k_lo - [rank[t] < j] + [rank[t + w]
// < j], and j steps to the next in-window entry above it when c < k_lo (or
// c = k_lo and j itself left), to the one below when c > k_lo, and stays
// otherwise: about one entry read an output where the union's density of
// in-window entries is one half (U ~ 2w).  An even window's upper central
// entry is the next in-window entry after j, a short forward scan.  The
// midpoint is __fmul_rn(__fadd_rn(lo, hi), 0.5f), the plain version's (a +
// b) * 0.5.
//
// Every loop is bounded by the union size: built with an unbounded walk
// loop, nvcc 12.8 (sm_90a) returned wrong medians for every thread of a
// block past the first.
//
// - median_shared_kernel: the sorted union, its ranks and the masks in
//   dynamic shared memory, P = next_pow2(kTile + w - 1) <= kSharedEntries,
//   so w <= 15,361; at the production window P = 2,048 (the union 2,023),
//   20 KB a block of 64 threads, eight blocks an SM (ptxas then keeps a
//   thread's 32 entries and its walk in 128 registers without spilling).
// - median_global_kernel: wider windows (the command line takes up to
//   250,000).  Persistent blocks of kGThreads walk tiles of kGTile outputs;
//   each block's union, ranks and masks live in a scratch of its own in
//   device memory that the wrapper allocates, and the union is sorted
//   there: chunks of kChunk entries sorted in shared memory as above, then
//   each merge's mirror stage and strides of kChunk and more over device
//   memory (one barrier a pass), the shorter ones per chunk in shared
//   memory.  Here U ~ w, so the larger tile shares the sort among more
//   outputs at the same P.
// T and R (kTile, kRun; kGTile, kGRun) were chosen from the step model and
// timed on the card against the neighbouring choices (PERF.md).  One entry,
// erp_median, picks the instantiation by the window, launches it on the
// caller's stream and returns cudaGetLastError();
// erp_median_scratch_entries says how much scratch it needs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned long long u64;

// the shared instantiation: tiles of kTile outputs, kRun a thread
constexpr int kRun = 16;
constexpr int kTile = 1024;
constexpr int kThreads = kTile / kRun;
constexpr int kBlocksPerSM = 8;
constexpr int kSharedEntries = 1 << 14;  // its largest union: 128 KB of entries, 32 KB of ranks
// the device-memory instantiation
constexpr int kGRun = 16;
constexpr int kGThreads = 512;
constexpr int kGTile = kGThreads * kGRun;
constexpr int kChunk = 1 << 12;  // its shared chunk (32 KB)
constexpr u64 kPad = ~0ull;
constexpr uint32_t kPadPos = ~0u;

__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(u64 e) {
  const uint32_t k = static_cast<uint32_t>(e >> 32);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// entry e's position lies in the window [t, t + w)
__device__ __forceinline__ bool in_window(u64 e, uint32_t t, uint32_t w) {
  return static_cast<uint32_t>(e) - t < w;
}

// the entry of position `pos` of the tile that starts at input o0: x[o0 +
// pos] while pos < M (the union) and the input exists, padding after
__device__ __forceinline__ u64 entry_of(const float* __restrict__ x, long long o0, int pos, int n, int M) {
  const long long g = o0 + pos;
  return (pos < M && g < n) ? (static_cast<u64>(key_of(x[g])) << 32) | static_cast<u64>(pos) : kPad;
}

// where the shared instantiation keeps sorted index i while it sorts: the
// low five bits XORed with the next five, so that a thread's 32 consecutive
// entries (the strides below 32, in registers) and a warp's 32 consecutive
// pairs (the longer strides) each fall in distinct banks
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 5) & 31); }

// a compare-exchange in registers: a the smaller
__device__ __forceinline__ void cex(u64& a, u64& b) {
  const u64 lo = a < b ? a : b, hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// The network sorts ascending with every comparator ascending: the merge of
// two sorted runs of length h first pairs i with its mirror i ^ (2h - 1),
// then half-cleaners of strides h / 2 .. 1 pair i with i + stride.

// one stage of the network over a[0, n) (kSwz: a[] in the swz() layout):
// the mirror stage of runs of length h (kMirror), or the half-cleaner of
// stride h
template <int NT, bool kMirror, bool kSwz = false>
__device__ __forceinline__ void sort_step(u64* a, int n, int h) {
  for (int p = threadIdx.x; p < (n >> 1); p += NT) {
    const int i = ((p & ~(h - 1)) << 1) | (p & (h - 1));
    const int l = kMirror ? i ^ (2 * h - 1) : i + h;
    const int si = kSwz ? swz(i) : i, sl = kSwz ? swz(l) : l;
    const u64 lo = a[si], hi = a[sl];
    if (lo > hi) {
      a[si] = hi;
      a[sl] = lo;
    }
  }
}

// the half-cleaners of strides h and h / 2 in one pass: four entries a
// thread (kSwz: a[] in the swz() layout)
template <int NT, bool kSwz = false>
__device__ __forceinline__ void sort_step4(u64* a, int n, int h) {
  const int q = h >> 1;
  for (int p = threadIdx.x; p < (n >> 2); p += NT) {
    const int i = ((p & ~(q - 1)) << 2) | (p & (q - 1));
    const int s0 = kSwz ? swz(i) : i, s1 = kSwz ? swz(i + q) : i + q;
    const int s2 = kSwz ? swz(i + h) : i + h, s3 = kSwz ? swz(i + h + q) : i + h + q;
    u64 v0 = a[s0], v1 = a[s1], v2 = a[s2], v3 = a[s3];
    cex(v0, v2);
    cex(v1, v3);
    cex(v0, v1);
    cex(v2, v3);
    a[s0] = v0;
    a[s1] = v1;
    a[s2] = v2;
    a[s3] = v3;
  }
}

// the half-cleaners of strides h .. last (powers of two) over a[0, n), two
// a pass while both are at least `last` (kSwz: in the swz() layout)
template <int NT, bool kSwz = false>
__device__ void clean_level(u64* a, int n, int h, int last) {
  while (h >= last) {
    if (h >= 2 * last) {
      sort_step4<NT, kSwz>(a, n, h);
      h >>= 2;
    } else {
      sort_step<NT, false, kSwz>(a, n, h);
      h >>= 1;
    }
    __syncthreads();
  }
}

// the merge of runs of length k / 2 into runs of k down to stride `last`:
// the mirror stage, then the half-cleaners of strides k / 4 .. last
template <int NT, bool kSwz = false>
__device__ void merge_level(u64* a, int n, int k, int last) {
  sort_step<NT, true, kSwz>(a, n, k >> 1);
  __syncthreads();
  clean_level<NT, kSwz>(a, n, k >> 2, last);
}

// rank[position] = its index among the P sorted entries (padding has none)
template <int NT, typename Rank>
__device__ __forceinline__ void scatter_ranks(const u64* a, Rank* rank, int P) {
  for (int j = threadIdx.x; j < P; j += NT) {
    const uint32_t pos = static_cast<uint32_t>(a[j]);
    if (pos != kPadPos) rank[pos] = static_cast<Rank>(j);
  }
}

// the network on 32 entries in registers: every level (kAll), or the
// half-cleaners of strides 16 .. 1 that end each longer level
template <bool kAll>
__device__ __forceinline__ void sort32(u64 (&r)[32]) {
#pragma unroll
  for (int k = kAll ? 2 : 64; k <= (kAll ? 32 : 64); k <<= 1) {
    if (k <= 32) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if ((e & (k >> 1)) == 0) cex(r[e], r[e ^ (k - 1)]);
    }
#pragma unroll
    for (int h = min(k >> 2, 16); h > 0; h >>= 1)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if ((e & h) == 0) cex(r[e], r[e | h]);
  }
}

// sort32 on every 32-entry chunk of a[0, P) in the swz() layout
template <int NT, bool kAll>
__device__ __forceinline__ void sort_chunks(u64* a, int P) {
  u64 r[32];
  for (int c = threadIdx.x; c < P / 32; c += NT) {
#pragma unroll
    for (int e = 0; e < 32; ++e) r[e] = a[32 * c + (e ^ (c & 31))];
    sort32<kAll>(r);
#pragma unroll
    for (int e = 0; e < 32; ++e) a[32 * c + (e ^ (c & 31))] = r[e];
  }
  __syncthreads();
}

// the shared instantiation's sort of P >= 1,024 entries in the swz()
// layout: the strides below 32 in a thread's registers (a 32-entry chunk
// each), the longer ones over shared memory
template <int NT>
__device__ void sort_shared(u64* a, int P) {
  sort_chunks<NT, true>(a, P);
  for (int k = 64; k <= P; k <<= 1) {
    merge_level<NT, true>(a, P, k, 32);
    sort_chunks<NT, false>(a, P);
  }
}

// back from the swz() layout to sorted order, with the rank map: each warp
// permutes whole 32-entry blocks
template <int NT, typename Rank>
__device__ __forceinline__ void unswizzle_ranks(u64* a, Rank* rank, int P) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < P / 32; b += NT / 32) {
    const u64 e = a[32 * b + lane];
    const int j = 32 * b + (lane ^ (b & 31));
    __syncwarp();
    a[j] = e;
    const uint32_t pos = static_cast<uint32_t>(e);
    if (pos != kPadPos) rank[pos] = static_cast<Rank>(j);
    __syncwarp();
  }
}

// the index of the first in-window entry after j, or before it
__device__ __forceinline__ int next_in(const u64* a, int P, int j, uint32_t t, uint32_t w) {
  for (int q = j + 1; q < P; ++q)
    if (in_window(a[q], t, w)) return q;
  return P - 1;  // not reached: the window has an entry above every central one
}

__device__ __forceinline__ int prev_in(const u64* a, int j, uint32_t t, uint32_t w) {
  for (int q = j - 1; q >= 0; --q)
    if (in_window(a[q], t, w)) return q;
  return 0;  // not reached
}

// The first walk starts at J, the sorted index where the central entry is
// expected (walk_start), from the count of its window's entries below J:
// bit i of mask[b] says that position 32 b + i holds an entry below J,
// before[b] counts those positions below 32 b (nb = P / 32 + 1 words each).
__device__ __forceinline__ int walk_start(int tile, int w, int P) {
  const int k_lo = (w - 1) / 2;
  const long long J = (static_cast<long long>(k_lo + 1) * (tile + w - 1) / w) & ~7ll;
  return static_cast<int>(J < P - 8 ? J : P - 8);
}

// mask and before for the M positions of a tile from its rank map
template <int NT, typename Rank>
__device__ void count_below(const Rank* rank, uint32_t* mask, uint32_t* before, int M, int nb, int J) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < nb; b += NT / 32) {
    const int p = 32 * b + lane;
    const uint32_t m = __ballot_sync(~0u, p < M && static_cast<int>(rank[p]) < J);
    if (lane == 0) mask[b] = m;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // one warp: the exclusive prefix sum of the masks' bits
    uint32_t total = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const uint32_t c = b < nb ? __popc(mask[b]) : 0;
      uint32_t incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(~0u, incl, off);
        if (lane >= off) incl += y;
      }
      if (b < nb) before[b] = total + incl - c;
      total += __shfl_sync(~0u, incl, 31);
    }
  }
  __syncthreads();
}

// the positions below q that hold an entry below J
__device__ __forceinline__ int below(const uint32_t* mask, const uint32_t* before, int q) {
  return static_cast<int>(before[q >> 5] + __popc(mask[q >> 5] & ((1u << (q & 31)) - 1)));
}

// the index of the in-window entry with k_lo in-window entries below it,
// for the window [t, t + w), from index J (a multiple of eight) with
// `count` in-window entries below it: groups of eight while they leave the
// count on the same side of k_lo, then entry by entry
__device__ __forceinline__ int first_walk(const u64* a, int P, uint32_t t, uint32_t w, int k_lo, int J,
                                          int count) {
  int j = J;
  if (count <= k_lo) {
    for (; j < P; j += 8) {
      int c = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) c += in_window(a[j + u], t, w);
      if (count + c > k_lo) break;
      count += c;
    }
    for (; j < P; ++j) {
      if (in_window(a[j], t, w)) {
        if (count == k_lo) return j;
        ++count;
      }
    }
  } else {
    for (; j >= 8; j -= 8) {
      int c = 0;
#pragma unroll
      for (int u = 1; u <= 8; ++u) c += in_window(a[j - u], t, w);
      if (count - c <= k_lo) break;
      count -= c;
    }
    for (--j; j >= 0; --j) {
      if (in_window(a[j], t, w) && --count == k_lo) return j;
    }
  }
  return 0;  // not reached
}

// the medians of outputs [t0, t0 + len) of a tile from its P sorted
// entries a and their rank map: the first walk, then the slide
template <typename Rank>
__device__ __forceinline__ void median_run(const u64* a, const Rank* rank, const uint32_t* mask,
                                           const uint32_t* before, int P, int J, uint32_t t0, int len,
                                           uint32_t w, float* __restrict__ out) {
  const int k_hi = static_cast<int>(w >> 1);
  const int k_lo = (w & 1) ? k_hi : k_hi - 1;
  uint32_t t = t0;
  int j = first_walk(a, P, t, w, k_lo, J, below(mask, before, t0 + w) - below(mask, before, t0));
  for (int i = 0; i < len; ++i) {
    if (i > 0) {
      const int ra = static_cast<int>(rank[t]), rb = static_cast<int>(rank[t + w]);
      ++t;
      const int c = k_lo - (ra < j) + (rb < j);  // the new window's entries below j
      if (c < k_lo || (c == k_lo && ra == j)) {
        j = next_in(a, P, j, t, w);
      } else if (c > k_lo) {
        j = prev_in(a, j, t, w);
      }
    }
    const float lo = value_of(a[j]);
    out[i] = (w & 1) ? lo : __fmul_rn(__fadd_rn(lo, value_of(a[next_in(a, P, j, t, w)])), 0.5f);
  }
}

// how many of the `run` outputs from output o0 + t0 on exist
__device__ __forceinline__ int run_length(long long o0, int t0, int run, int n_out) {
  const long long left = n_out - o0 - t0;
  return left <= 0 ? 0 : (left < run ? static_cast<int>(left) : run);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    median_shared_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int n_out,
                         int w, int P) {
  extern __shared__ u64 s[];
  uint16_t* rank = reinterpret_cast<uint16_t*>(s + P);
  const int nb = P / 32 + 1;
  uint32_t* mask = reinterpret_cast<uint32_t*>(rank + P);
  uint32_t* before = mask + nb;
  const long long o0 = static_cast<long long>(blockIdx.x) * kTile;
  const int M = kTile + w - 1;
  for (int i = threadIdx.x; i < P; i += kThreads) s[swz(i)] = entry_of(x, o0, i, n, M);
  __syncthreads();
  sort_shared<kThreads>(s, P);
  unswizzle_ranks<kThreads>(s, rank, P);
  __syncthreads();
  const int J = walk_start(kTile, w, P);
  count_below<kThreads>(rank, mask, before, static_cast<int>(min(static_cast<long long>(M), n - o0)), nb, J);
  const int t0 = threadIdx.x * kRun;
  const int len = run_length(o0, t0, kRun, n_out);
  if (len > 0) median_run(s, rank, mask, before, P, J, t0, len, static_cast<uint32_t>(w), out + o0 + t0);
}

__global__ void __launch_bounds__(kGThreads)
    median_global_kernel(const float* __restrict__ x, u64* scratch, float* __restrict__ out, int n,
                         int n_out, int w, int P) {
  __shared__ u64 s[kChunk];
  const int nb = P / 32 + 1;
  u64* a = scratch + static_cast<size_t>(blockIdx.x) * (P + P / 2 + nb);
  uint32_t* rank = reinterpret_cast<uint32_t*>(a + P);
  uint32_t* mask = rank + P;
  uint32_t* before = mask + nb;
  const int M = kGTile + w - 1;
  const int J = walk_start(kGTile, w, P);
  const int n_tiles = (n_out + kGTile - 1) / kGTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long o0 = static_cast<long long>(tile) * kGTile;
    // runs of kChunk: each chunk sorted alone in shared memory
    for (int c = 0; c < P; c += kChunk) {
      for (int i = threadIdx.x; i < kChunk; i += kGThreads) s[swz(i)] = entry_of(x, o0, c + i, n, M);
      __syncthreads();
      sort_shared<kGThreads>(s, kChunk);
      for (int i = threadIdx.x; i < kChunk; i += kGThreads) a[c + i] = s[swz(i)];
      __syncthreads();
    }
    // the longer runs: the mirror stage and the strides >= kChunk over
    // device memory, the shorter ones per chunk
    for (int k = kChunk << 1; k <= P; k <<= 1) {
      merge_level<kGThreads>(a, P, k, kChunk);
      for (int c = 0; c < P; c += kChunk) {
        for (int i = threadIdx.x; i < kChunk; i += kGThreads) s[swz(i)] = a[c + i];
        __syncthreads();
        clean_level<kGThreads, true>(s, kChunk, kChunk >> 1, 32);
        sort_chunks<kGThreads, false>(s, kChunk);
        for (int i = threadIdx.x; i < kChunk; i += kGThreads) a[c + i] = s[swz(i)];
        __syncthreads();
      }
    }
    scatter_ranks<kGThreads>(a, rank, P);
    __syncthreads();
    count_below<kGThreads>(rank, mask, before, static_cast<int>(min(static_cast<long long>(M), n - o0)), nb, J);
    const int t0 = threadIdx.x * kGRun;
    const int len = run_length(o0, t0, kGRun, n_out);
    if (len > 0) median_run(a, rank, mask, before, P, J, t0, len, static_cast<uint32_t>(w), out + o0 + t0);
    __syncthreads();  // every run is done before the next tile overwrites the scratch
  }
}

// the padded union of a tile of `tile` outputs: next_pow2(tile + w - 1)
int union_entries(int tile, int w) {
  int P = 1;
  while (P < tile + w - 1) P <<= 1;
  return P;
}

// the device-memory instantiation's persistent blocks: two an SM, at most
// one a tile; 0 with an error in *e
int global_grid(int device, int n_out, cudaError_t* e) {
  int sms = 0;
  *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*e != cudaSuccess) return 0;
  const int tiles = (n_out + kGTile - 1) / kGTile;
  return tiles < 2 * sms ? tiles : 2 * sms;
}

}  // namespace

// int64 entries of device-memory scratch that erp_median needs for n inputs
// and window w: 0 where a tile's union fits shared memory (the shared
// instantiation runs), else a union and its 32-bit ranks a persistent
// block; minus the CUDA error on a failed query
extern "C" int erp_median_scratch_entries(int device, int n, int w) {
  if (union_entries(kTile, w) <= kSharedEntries) return 0;
  const int P = union_entries(kGTile, w);
  cudaError_t e;
  const int grid = global_grid(device, n - w + 1, &e);
  return e == cudaSuccess ? grid * (P + P / 2 + P / 32 + 1) : -static_cast<int>(e);
}

// x: float32[n]; out: float32[n - w + 1], 1 <= w <= n; scratch: int64 of
// erp_median_scratch_entries(device, n, w) entries (unused when that is 0).
// Picks the instantiation by the window.
extern "C" int erp_median(int device, void* stream, const float* x, void* scratch, float* out, int n,
                          int w) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = n - w + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = union_entries(kTile, w);
  if (P <= kSharedEntries) {
    const int smem = P * static_cast<int>(sizeof(u64) + sizeof(uint16_t)) + (P / 32 + 1) * 2 * 4;
    e = cudaFuncSetAttribute(median_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    median_shared_kernel<<<(n_out + kTile - 1) / kTile, kThreads, smem, st>>>(x, out, n, n_out, w, P);
  } else {
    const int grid = global_grid(device, n_out, &e);
    if (e != cudaSuccess) return static_cast<int>(e);
    median_global_kernel<<<grid, kGThreads, 0, st>>>(x, static_cast<u64*>(scratch), out, n, n_out, w,
                                                      union_entries(kGTile, w));
  }
  return static_cast<int>(cudaGetLastError());
}
