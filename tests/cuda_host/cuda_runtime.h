// Host stand-in for the CUDA runtime, enough to compile the port's kernels
// as C++ and run one block at a time: one std::thread per GPU thread,
// __syncthreads as a block barrier, __syncwarp as a barrier of the warp's
// 32 threads, __shared__ as a static (one block runs at a time), and the
// dynamic shared memory a static buffer.  Used by
// tests/test_torch_kernels_on_host.py; it proves a kernel's algorithm and
// indexing on the CPU, not what nvcc makes of it.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
alignas(16) inline unsigned char host_dynamic_smem[256 * 1024];
inline std::barrier<>* host_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> host_warp_barriers;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp() {
  host_warp_barriers[(threadIdx.x + threadIdx.y * blockDim.x) / 32]->arrive_and_wait();
}
inline void sincos(double x, double* s, double* c) { *s = std::sin(x); *c = std::cos(x); }
inline void sincosf(float x, float* s, float* c) { *s = std::sin(x); *c = std::cos(x); }
inline float sqrtf(float x) { return std::sqrt(x); }
using std::sqrt;
typedef void* cudaStream_t;

// Run ``body`` as block ``bidx`` of ``bdim`` threads (x fastest, as on the
// card).
inline void host_run_block(dim3 bidx, dim3 bdim, const std::function<void()>& body) {
  const unsigned n = bdim.x * bdim.y;
  blockDim = bdim;
  std::barrier<> block(n);
  host_block_barrier = &block;
  host_warp_barriers.clear();
  for (unsigned w = 0; w < (n + 31) / 32; ++w)
    host_warp_barriers.emplace_back(new std::barrier<>(std::min(32u, n - 32 * w)));
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t % bdim.x;
      threadIdx.y = t / bdim.x;
      blockIdx = bidx;
      body();
    });
  for (auto& t : threads) t.join();
}
