// Runs a CUDA source's kernels on the host, for tests on machines without
// nvcc or a card (tests/torch_cuda_emu.py builds a source against it): one
// std::thread a CUDA thread, the blocks of a launch one after another, over
// a grid of one or two dimensions; __syncthreads is a
// std::barrier of the block, __syncwarp one of the warp, and ballots and
// shuffles pass their values through an array of the warp.  `__shared__`
// arrays are statics (the blocks never overlap), the dynamic one a vector,
// filled anew for each block.
// It checks a kernel's logic, not its speed, its memory model or what nvcc
// makes of it.
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__
using std::max;
using std::min;

struct emu_dim3 {
  unsigned x, y, z;
  constexpr emu_dim3(unsigned x_ = 0, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
using dim3 = emu_dim3;
thread_local emu_dim3 threadIdx(0, 0, 0);
static emu_dim3 blockIdx(0, 0, 0), gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaDevAttrMultiProcessorCount = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 2
};
constexpr int kEmuSMs = 3;  // the SMs cudaDeviceGetAttribute reports
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = kEmuSMs;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

static std::barrier<>* emu_block_barrier;
thread_local std::barrier<>* emu_warp_barrier;
thread_local unsigned long long* emu_warp_slots;
static std::vector<unsigned long long> emu_dynamic_shared;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_barrier->arrive_and_wait(); }
inline unsigned emu_lane() { return threadIdx.x & 31; }

inline uint32_t __ballot_sync(unsigned, bool p) {
  emu_warp_slots[emu_lane()] = p;
  __syncwarp();
  uint32_t m = 0;
  for (int i = 0; i < 32; ++i) m |= (emu_warp_slots[i] ? 1u : 0u) << i;
  __syncwarp();
  return m;
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int off) {
  emu_warp_slots[emu_lane()] = v;
  __syncwarp();
  const uint32_t r = emu_lane() >= static_cast<unsigned>(off) ? emu_warp_slots[emu_lane() - off] : v;
  __syncwarp();
  return r;
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  emu_warp_slots[emu_lane()] = v;
  __syncwarp();
  const uint32_t r = emu_warp_slots[src];
  __syncwarp();
  return r;
}
inline int __popc(uint32_t v) { return __builtin_popcount(v); }
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// volatile: one float32 rounding each, as the intrinsics promise
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}

// cp.async through <cuda_pipeline.h>: the copy happens at once, so the
// commits and waits have nothing left to do
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) { std::memcpy(dst, src, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// kernel<<<grid, threads, smem, stream>>>(args...), rewritten by the test.
// The launch's threads are made once and run the blocks in turn: thread 0
// sets up each block between two barriers of all of them.
template <class K, class... A>
void emu_launch(emu_dim3 grid, int threads, int smem, K kernel, A... args) {
  gridDim = grid;
  const int warps = (threads + 31) / 32;
  std::vector<unsigned long long> slots(32 * warps);
  std::barrier<> block(threads);
  emu_block_barrier = &block;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  for (int i = 0; i < warps; ++i) warp.emplace_back(new std::barrier<>(std::min(32, threads - 32 * i)));
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      emu_warp_barrier = warp[t / 32].get();
      emu_warp_slots = &slots[32 * (t / 32)];
      for (unsigned b = 0; b < grid.x * grid.y; ++b) {
        if (t == 0) {
          blockIdx.x = b % grid.x;
          blockIdx.y = b / grid.x;
          emu_dynamic_shared.assign(smem / 8 + 1, 0xdeadbeefdeadbeefull);
        }
        block.arrive_and_wait();  // the block is set up
        kernel(args...);
        block.arrive_and_wait();  // every thread has left it
      }
    });
  for (auto& t : ts) t.join();
}
