// The search's real-to-complex transform: the packed half-length complex FFT
// of the upstream OpenCL backend (demod_binary_ocl.cpp:1170-1300), done
// four-step in two passes over device memory, with its R2C untangle.
//
// Counterpart of the reference package's `rfft_packed_split`
// (boinc_app_eah_brp_tpu/ops/fft.py:268), which XLA runs as matrix products
// on the TPU; no Pallas kernel.  In the batch step it takes the place of
// cuFFT's R2C through torch.fft.rfft, whose plan of 3*2^22 points makes four
// passes over the data.
//
// The real series x[T, N] is read as z[T, M], z[n] = x[2n] + i x[2n+1], with
// M = N / 2 = N1 * N2 (N1 = 2^p, 16 <= N1 <= 2048; N2 = 2048 or 3072):
//   pass 1, r2c_fft_cols_kernel: z viewed as [N1][N2]; each column's N1-point
//     FFT over n1, times W_M^(n2 k1), written back over z in place as
//     Y[T][k1][n2] (a block reads its columns whole before it writes them);
//   pass 2, r2c_fft_rows_kernel: each row of Y's N2-point FFT over n2, which gives
//     Z[k1 + N1 k2].  Rows k1 and N1 - k1 share a block (rows 0 and N1/2 pair
//     with themselves), so Z[k] and Z[M - k] meet there for the untangle
//       X[k] = (Z[k] + conj Z[M-k]) / 2 - i W_N^k (Z[k] - conj Z[M-k]) / 2,
//     written to F[T, M + 1] in the layout torch.fft.rfft gives, or (the
//     search's form) turned into the fold's power |X[k]|^2 / N, DC 0, and
//     written to p[T, read] for the bins k < read that the fold reads, so
//     the complex spectrum is never stored.
//
// What bounds it on the card: bytes.  Each pass reads and writes the
// spectrum's size once, twice the least one transform could move (PERF.md,
// section 3); the FFTs' arithmetic runs in registers and shared memory.
//
// What the design does about it: the strided side of each pass moves whole
// 32-byte sectors.  A pass-1 block holds four adjacent columns, so it reads
// z and writes Y in runs of four bins; a pass-2 block holds four adjacent
// rows and their mirrors (two tiles of four transforms), chosen so that the
// rows' outputs fill sectors of F (a sector written in parts costs several
// times a whole one).  Tiles are copied in with cp.async, the mirrors' while
// the rows' stages run.  The radix-16/8/4/2/3 stages work in place on
// four interleaved transforms; shared slots are XOR-swizzled so that a
// half-warp's threads meet no bank twice.  Every twiddle is a
// float32 rounded once from double: the FFTs' own from float tables made in
// double on the host, the four-step and untangle ones from products of two
// double table entries (W_2M^e = TH[e >> 11] * TL[e & 2047]), carried along a
// thread's outputs by a double recurrence.  No atomics: each output is
// written once, by one thread, in a fixed order, so every call gives the same
// bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the transforms a tile interleaves: a block's columns in pass 1, its rows
// and their mirrors (two tiles) in pass 2; four bins fill a 32-byte sector
constexpr int kTile = 4;
constexpr int kThreads1 = 512, kThreads2 = 1024;
constexpr int kLoBits = 11;  // TL holds W_2M^j for j < 2^kLoBits

struct alignas(8) c32 {
  float re, im;
};
struct alignas(16) c64 {
  double re, im;
};

__device__ __forceinline__ c32 add(c32 a, c32 b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ c32 sub(c32 a, c32 b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ c32 mul(c32 a, c32 b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ c64 mul(c64 a, c64 b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ c32 narrow(c64 a) {
  return {static_cast<float>(a.re), static_cast<float>(a.im)};
}

// W_2M^e, e in [0, 2M), in double: one product of two table entries
__device__ __forceinline__ c64 root(const c64* __restrict__ th, const c64* __restrict__ tl, int e) {
  return mul(th[e >> kLoBits], tl[e & ((1 << kLoBits) - 1)]);
}

// cos and sin of 2 pi e / 16, e in [0, 8): the radix-2^n butterflies' roots
__host__ __device__ constexpr float cos16(int e) {
  return e == 0 ? 1.0f
       : e == 1 ? 0.92387953251128675613f
       : e == 2 ? 0.70710678118654752440f
       : e == 3 ? 0.38268343236508977173f
       : e == 4 ? 0.0f
       : e == 5 ? -0.38268343236508977173f
       : e == 6 ? -0.70710678118654752440f
                : -0.92387953251128675613f;
}
__host__ __device__ constexpr float sin16(int e) { return e == 0 ? 0.0f : cos16(4 - e < 0 ? e - 4 : 4 - e); }

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }
__host__ __device__ constexpr int bitrev(int k, int bits) {
  return bits == 0 ? 0 : ((k & 1) << (bits - 1)) | bitrev(k >> 1, bits - 1);
}

// The in-place plan of an L-point FFT, L = 3^b 2^p (b <= 1): a radix-3
// stage first where L has the factor, then 2^(p - 4(s - 1)), then 16s.  A
// slot holds the digits of its index, the first stage's most significant
// (stride(0) = L / radix(0)); stage j transforms digit j in place, so the
// output k = k_0 + R_0 k_1 + R_0 R_1 k_2 + ... sits at slot sum k_j stride(j).
template <int L>
struct Plan {
  static constexpr bool three = L % 3 == 0;
  static constexpr int bits = log2i(three ? L / 3 : L);
  static constexpr int n16 = (bits + 3) / 4;
  static constexpr int head = bits - 4 * (n16 - 1);
  static constexpr int stages = n16 + (three ? 1 : 0);
  __host__ __device__ static constexpr int radix(int j) {
    return three ? (j == 0 ? 3 : j == 1 ? 1 << head : 16) : (j == 0 ? 1 << head : 16);
  }
  __host__ __device__ static constexpr int stride(int j) {
    int s = 1;
    for (int i = j + 1; i < stages; ++i) s *= radix(i);
    return s;
  }
};

template <int L, int J = 0>
__device__ __forceinline__ int slot_of(int k) {
  if constexpr (J == Plan<L>::stages) {
    return 0;
  } else {
    constexpr int R = Plan<L>::radix(J);
    return (k % R) * Plan<L>::stride(J) + slot_of<L, J + 1>(k / R);
  }
}

// A slot's place in a tile: its low two bits XORed with mask(slot), the
// fold of all its higher 2-bit fields, so four slots a power of two apart
// (or four consecutive ones) land in four banks, and a half-warp's 16
// eight-byte accesses, the tile's four transforms by four slots, meet no
// bank twice.  Slots stay below 2^18.  The mask is linear over XOR, so for
// slots a and c with no bit in common idx(a + c, col) = idx(a, col) ^
// off(c): a loop over c with a fixed base costs one XOR an access, with
// off(c) a constant.
__host__ __device__ constexpr int mask(int s) {
  int f = s >> 2;
  f ^= f >> 8;
  f ^= f >> 4;
  f ^= f >> 2;
  return f & 3;
}
__host__ __device__ constexpr int idx(int slot, int col) { return (slot ^ mask(slot)) * kTile + col; }
__host__ __device__ constexpr int off(int c) { return (c ^ mask(c)) * kTile; }

// One level of a radix-2 decimation in frequency over v: butterfly J of
// R / 2 pairs elements i and i + H and turns their difference by W_2H^m.
// Every index is a template constant, so v stays in registers.
template <int R, int H, int J = 0>
__device__ __forceinline__ void dif_level(c32 (&v)[R]) {
  if constexpr (J < R / 2) {
    constexpr int m = J % H, i = (J / H) * 2 * H + m, e = m * (8 / H);  // W_2H^m = W_16^e
    const c32 d = sub(v[i], v[i + H]);
    v[i] = add(v[i], v[i + H]);
    if constexpr (e == 0) {
      v[i + H] = d;
    } else if constexpr (e == 4) {
      v[i + H] = c32{d.im, -d.re};
    } else {
      v[i + H] = mul(d, c32{cos16(e), -sin16(e)});
    }
    dif_level<R, H, J + 1>(v);
  }
}

template <int R, int H = R / 2>
__device__ __forceinline__ void dif(c32 (&v)[R]) {
  if constexpr (H >= 1) {
    dif_level<R, H>(v);
    dif<R, H / 2>(v);
  }
}

// t[k] = v[bitrev(k)]: the radix-2 levels' bit-reversed outputs in order
template <int R, int K = 0>
__device__ __forceinline__ void unscramble(const c32 (&v)[R], c32 (&t)[R]) {
  if constexpr (K < R) {
    constexpr int src = bitrev(K, log2i(R));
    t[K] = v[src];
    unscramble<R, K + 1>(v, t);
  }
}

// R-point DFT in registers, natural order in and out
template <int R>
__device__ __forceinline__ void dft(c32 (&v)[R]) {
  if constexpr (R == 3) {
    const c32 s = add(v[1], v[2]), d = sub(v[1], v[2]);
    const c32 m = {v[0].re - 0.5f * s.re, v[0].im - 0.5f * s.im};
    constexpr float h = 0.86602540378443864676f;  // sin(pi / 3)
    const c32 r = {h * d.im, -(h * d.re)};        // -i h d
    v[0] = add(v[0], s);
    v[1] = add(m, r);
    v[2] = sub(m, r);
  } else {
    dif(v);
    c32 t[R];
    unscramble(v, t);
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = t[k];
  }
}

// Stage J of the plan over the tile's transforms, in place.  Digit J
// of a slot has stride S; l < S are the digits not yet transformed, and
// after the R-point DFT each output k takes the twiddle W_(R S)^(k l)
// (tw holds W_L^m, m < L).
template <int L, int J, int THREADS>
__device__ __forceinline__ void fft_stage(c32* sm, const c32* __restrict__ tw) {
  constexpr int R = Plan<L>::radix(J), S = Plan<L>::stride(J);
  for (int b = threadIdx.x; b < kTile * L / R; b += THREADS) {
    const int col = b % kTile, u = b / kTile;
    const int l = u % S, a = idx((u / S) * (R * S) + l, col);  // slot r S above it
    c32 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = sm[a ^ off(r * S)];
    dft<R>(v);
    if constexpr (S > 1) {
#pragma unroll
      for (int k = 1; k < R; ++k) v[k] = mul(v[k], tw[k * l * (L / (R * S))]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) sm[a ^ off(r * S)] = v[r];
  }
}

template <int L, int THREADS, int J = 0>
__device__ __forceinline__ void fft_tile(c32* sm, const c32* __restrict__ tw) {
  if constexpr (J < Plan<L>::stages) {
    __syncthreads();
    fft_stage<L, J, THREADS>(sm, tw);
    fft_tile<L, THREADS, J + 1>(sm, tw);
  } else {
    __syncthreads();
  }
}

// Pass 1: block (x, t) takes columns [C x, C x + C) of template t, in
// place: every thread's copies have landed before the first stage's
// barrier, and the outputs go back over the same columns after the last.
// No other block touches them.
template <int N1>
__global__ void __launch_bounds__(kThreads1)
    r2c_fft_cols_kernel(c32* z, const c32* __restrict__ tw, const c64* __restrict__ th,
                        const c64* __restrict__ tl, int n2_len) {
  extern __shared__ c32 sm[];
  constexpr int C = kTile, kRowStep = kThreads1 / C;
  const int c0 = blockIdx.x * C, col = threadIdx.x % C, n2 = c0 + col, w0 = threadIdx.x / C;
  const size_t M = static_cast<size_t>(N1) * n2_len;
  // element (n1, col) of the tile, n1 = w0 + j kRowStep, copied without registers
  {
    const c32* src = z + blockIdx.y * M + n2 + static_cast<size_t>(w0) * n2_len;
    const int a = idx(w0, col);
#pragma unroll
    for (int j = 0; j < (C * N1 + kThreads1 - 1) / kThreads1; ++j)
      if ((C * N1) % kThreads1 == 0 || w0 + j * kRowStep < N1)
        __pipeline_memcpy_async(&sm[a ^ off(j * kRowStep)], src + static_cast<size_t>(j) * kRowStep * n2_len,
                                sizeof(c32));
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  fft_tile<N1, kThreads1>(sm, tw);
  // output k1 = w + P k of column col sits at slot slot_of(w) + k (k below
  // the last radix RL), times W_M^(n2 k1) = W_2M^(2 n2 k1), carried along k
  constexpr int RL = Plan<N1>::radix(Plan<N1>::stages - 1), P = N1 / RL;
  const int two_m = 2 * N1 * n2_len;
  for (int b = threadIdx.x; b < C * P; b += kThreads1) {
    const int w = b / C;
    const int a = idx(slot_of<N1>(w), col);
    c64 t = root(th, tl, static_cast<int>(2LL * n2 * w % two_m));
    const c64 step = root(th, tl, static_cast<int>(2LL * n2 * P % two_m));
    c32* dst = z + blockIdx.y * M + n2 + static_cast<size_t>(w) * n2_len;
#pragma unroll
    for (int k = 0; k < RL; ++k, t = mul(t, step))
      dst[static_cast<size_t>(k) * P * n2_len] = mul(sm[a ^ off(k)], narrow(t));
  }
}

// Where pass 2 puts X[k], 0 <= k <= M, of template t: the complex spectrum
// F[T, M + 1], whose rows start at any phase of a sector ...
struct SpectrumOut {
  c32* f;
  __device__ SpectrumOut row(int t, int M) const { return {f + t * (static_cast<size_t>(M) + 1)}; }
  // how many bins into a 32-byte sector the row starts
  __device__ int phase() const { return static_cast<int>(reinterpret_cast<uintptr_t>(f) / sizeof(c32) % kTile); }
  __device__ void put(int k, c32 v) const { f[k] = v; }
};

// ... or the fold's power p[T, read], p[k] = |X[k]|^2 * scale with every
// multiply and add rounded on its own and p[0] = 0 (csrc/fold.cu's power,
// so each bin is bitwise what the fold forms from F), bins k >= read left
// out.  The fold reads read = min(M + 1, 16W + 16) bins, 16W + 16 at the
// production width: a multiple of 16, so each row starts on a sector of an
// aligned tensor (phase 0; any phase gives the same bins, only slower).
struct PowerOut {
  float* p;
  int read;
  float scale;
  __device__ PowerOut row(int t, int) const { return {p + t * static_cast<size_t>(read), read, scale}; }
  __device__ int phase() const { return 0; }
  __device__ void put(int k, c32 v) const {
    if (k < read) p[k] = k == 0 ? 0.0f : __fmul_rn(__fadd_rn(__fmul_rn(v.re, v.re), __fmul_rn(v.im, v.im)), scale);
  }
};

// X[k] and X[M - k] from zk = Z[k], zm = Z[M - k] and w = W_N^k:
// X[k] = A/2 - i P/2 and X[M - k] = conj(A)/2 - i conj(P)/2, with
// A = zk + conj zm, P = w (zk - conj zm).
template <class Out>
__device__ __forceinline__ void untangle(c32 zk, c32 zm, c32 w, const Out& out, int k, int m, bool both) {
  const c32 a = {zk.re + zm.re, zk.im - zm.im};
  const c32 p = mul(w, c32{zk.re - zm.re, zk.im + zm.im});
  out.put(k, {0.5f * a.re + 0.5f * p.im, 0.5f * a.im - 0.5f * p.re});
  if (both) out.put(m - k, {0.5f * a.re - 0.5f * p.im, -(0.5f * a.im) - 0.5f * p.re});
}

// Pass 2: block (x, t) takes G = 4 rows k1 of template t and their mirrors
// N1 - k1, the rows whose outputs fill 32-byte sectors of F: template t's
// spectrum starts phi bins into a sector, so block x >= 1
// takes rows 4x - phi + i (those below N1/2), and block 0 rows 0 .. 3 - phi,
// with row N1/2 in place of row 0's mirror.  The mirrors' outputs, at M - k,
// fall a bin off the sectors whatever the rows.  (A sector written in parts,
// even by one block microseconds apart, costs far more than a whole one.)
// Into the fold's power (PowerOut) four rows fill half a sector, and blocks
// x and x + 1 the two halves.
template <int N2, class Out>
__global__ void __launch_bounds__(kThreads2)
    r2c_fft_rows_kernel(const c32* __restrict__ y, Out f, const c32* __restrict__ tw,
                        const c64* __restrict__ th, const c64* __restrict__ tl, int n1_len) {
  extern __shared__ c32 sm[];
  constexpr int G = kTile;
  const int M = n1_len * N2;
  const Out out = f.row(blockIdx.y, M);
  const int phi = out.phase();
  const int first = blockIdx.x == 0 ? 0 : G * blockIdx.x - phi;
  // rows first + i for i < n_rows, all below N1/2
  const int n_rows = blockIdx.x == 0 ? G - phi : min(G, n1_len / 2 - first);
  // the lower rows' tile, then their mirrors', copied without registers; the
  // second copy runs while the first tile's stages do
  c32* lo = sm;
  c32* hi = sm + G * N2;
  const c32* src = y + blockIdx.y * static_cast<size_t>(M);
  {
    constexpr int kSlotStep = kThreads2 / G;
    const int col = threadIdx.x % G, s0 = threadIdx.x / G, a = idx(s0, col);
    const int low = first + min(col, n_rows - 1);
    const c32* rows[2] = {src + static_cast<size_t>(low) * N2 + s0,
                          src + static_cast<size_t>(low == 0 ? n1_len / 2 : n1_len - low) * N2 + s0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < G * N2 / kThreads2; ++j)
        __pipeline_memcpy_async(&sm[h * G * N2 + (a ^ off(j * kSlotStep))], rows[h] + j * kSlotStep, sizeof(c32));
      __pipeline_commit();
    }
  }
  __pipeline_wait_prior(1);
  fft_tile<N2, kThreads2>(lo, tw);
  __pipeline_wait_prior(0);
  fft_tile<N2, kThreads2>(hi, tw);
  // Z[k1 + N1 k2], k2 = w + P k (k below the last radix RL), sits at slot
  // slot_of(w) + k, its mirror's at N2 - 1 - that = (N2 - 1 - slot_of(w)) ^ k;
  // W_N^k = W_2M^k for k = k1 + N1 k2, carried along k
  constexpr int RL = Plan<N2>::radix(Plan<N2>::stages - 1), P = N2 / RL;
  const c64 step = root(th, tl, n1_len * P);
  for (int b = threadIdx.x; b < G * P; b += kThreads2) {
    const int i = b % G, w = b / G, k1 = first + i;
    if (i >= n_rows) continue;
    const int sw = slot_of<N2>(w);
    c64 t = root(th, tl, k1 + n1_len * w);
    if (k1 != 0) {
      const int a = idx(sw, i), am = idx(N2 - 1 - sw, i);
#pragma unroll
      for (int k = 0; k < RL; ++k, t = mul(t, step))
        untangle(lo[a ^ off(k)], hi[am ^ off(k)], narrow(t), out, k1 + n1_len * (w + P * k), M, true);
      continue;
    }
    for (int k = 0; k < RL; ++k, t = mul(t, step)) {
      const int k2 = w + P * k, s = sw + k;
      // row 0: k2 pairs with (N2 - k2) mod N2; k2 = 0 gives X[0] and X[M]
      if (2 * k2 <= N2)
        untangle(lo[idx(s, 0)], lo[idx(slot_of<N2>(k2 == 0 ? 0 : N2 - k2), 0)], narrow(t), out,
                 n1_len * k2, M, 2 * k2 != N2);
      // row N1/2: k2 pairs with N2 - 1 - k2
      if (2 * k2 < N2) {
        const int kk = n1_len / 2 + n1_len * k2;
        untangle(hi[idx(s, 0)], hi[idx(N2 - 1 - s, 0)], narrow(root(th, tl, kk)), out, kk, M, true);
      }
    }
  }
}

template <int N1, int N2, class Out>
cudaError_t launch(cudaStream_t stream, c32* z, Out f, const c32* tw1, const c32* tw2, const c64* th,
                   const c64* tl, int T) {
  auto cols = r2c_fft_cols_kernel<N1>;
  auto rows = r2c_fft_rows_kernel<N2, Out>;
  const int smem1 = kTile * N1 * static_cast<int>(sizeof(c32));
  const int smem2 = 2 * kTile * N2 * static_cast<int>(sizeof(c32));
  cudaError_t e = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return e;
  const dim3 grid1(N2 / kTile, T);
  const dim3 grid2(N1 / (2 * kTile) + 1, T);
  cols<<<grid1, kThreads1, smem1, stream>>>(z, tw1, th, tl, N2);
  rows<<<grid2, kThreads2, smem2, stream>>>(z, f, tw2, th, tl, N1);
  return cudaGetLastError();
}

template <int N2, class Out>
cudaError_t launch_n1(int n1, cudaStream_t s, c32* z, Out f, const c32* tw1, const c32* tw2,
                      const c64* th, const c64* tl, int T) {
  switch (n1) {
    case 16: return launch<16, N2>(s, z, f, tw1, tw2, th, tl, T);
    case 32: return launch<32, N2>(s, z, f, tw1, tw2, th, tl, T);
    case 64: return launch<64, N2>(s, z, f, tw1, tw2, th, tl, T);
    case 128: return launch<128, N2>(s, z, f, tw1, tw2, th, tl, T);
    case 256: return launch<256, N2>(s, z, f, tw1, tw2, th, tl, T);
    case 512: return launch<512, N2>(s, z, f, tw1, tw2, th, tl, T);
    case 1024: return launch<1024, N2>(s, z, f, tw1, tw2, th, tl, T);
    case 2048: return launch<2048, N2>(s, z, f, tw1, tw2, th, tl, T);
    default: return cudaErrorInvalidValue;
  }
}

template <class Out>
int launch_split(int device, void* stream, float* x, Out f, const float* tw1, const float* tw2,
                 const double* th, const double* tl, int T, int n1, int n2) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* z = reinterpret_cast<c32*>(x);
  const auto* w1 = reinterpret_cast<const c32*>(tw1);
  const auto* w2 = reinterpret_cast<const c32*>(tw2);
  const auto* h = reinterpret_cast<const c64*>(th);
  const auto* l = reinterpret_cast<const c64*>(tl);
  if (n2 == 2048) return static_cast<int>(launch_n1<2048>(n1, s, z, f, w1, w2, h, l, T));
  if (n2 == 3072) return static_cast<int>(launch_n1<3072>(n1, s, z, f, w1, w2, h, l, T));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: float32[T, 2 n1 n2], overwritten (it holds pass 1's Y afterwards); f:
// complex64[T, n1 n2 + 1]; tw1: complex64[n1] (W_n1^m); tw2: complex64[n2]
// (W_n2^m); th: complex128[2 n1 n2 >> 11] (W_2M^(2048 h)); tl:
// complex128[2048] (W_2M^j).  n1 a power of two in [16, 2048], n2 2048 or
// 3072 (ops/spectrum.py::r2c_split); any other split returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int erp_fft_r2c(int device, void* stream, float* x, float* f, const float* tw1, const float* tw2,
                           const double* th, const double* tl, int T, int n1, int n2) {
  return launch_split(device, stream, x, SpectrumOut{reinterpret_cast<c32*>(f)}, tw1, tw2, th, tl, T, n1, n2);
}

// erp_fft_r2c with the fold's power in place of F: p float32[T, read],
// p[t][k] = |X_t[k]|^2 * scale for 0 < k < read, p[t][0] = 0; read in
// [1, n1 n2 + 1], else cudaErrorInvalidValue and nothing launched.
extern "C" int erp_fft_r2c_power(int device, void* stream, float* x, float* p, const float* tw1,
                                 const float* tw2, const double* th, const double* tl, int T, int n1,
                                 int n2, int read, float scale) {
  if (read < 1 || static_cast<long long>(read) > static_cast<long long>(n1) * n2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_split(device, stream, x, PowerOut{p, read, scale}, tw1, tw2, th, tl, T, n1, n2);
}
