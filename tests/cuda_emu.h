// A CPU emulation of the CUDA subset the repo's ssd_scan kernels use, for
// tests/test_torch_ssd_kernel_emu.py: blocks run one at a time, each
// thread of a block as a std::thread; __syncthreads is a barrier (a
// thread that returns drops out of it, as on the card), shuffles and
// mma.sync exchange through per-warp buffers, cp.async copies at once
// with its zero fill, cvt.rna.tf32 is bit arithmetic.  Shared memory
// starts as NaN, so a read of what no thread wrote shows.  It checks
// indexing, masks, barriers and the order of sums, never speed: an
// m16n8k8 product is modelled as its exact sum rounded once to float32.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x)

struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
using std::max;
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};

inline thread_local uint3 threadIdx;
inline uint3 blockIdx, blockDim;

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

constexpr int EMU_SMEM_FLOATS = 1 << 16;
constexpr int EMU_WARPS = 32;
alignas(16) inline float emu_smem[EMU_SMEM_FLOATS];
inline std::unique_ptr<std::barrier<>> emu_block;
inline std::unique_ptr<std::barrier<>> emu_warp[EMU_WARPS];
inline float emu_xch[EMU_WARPS][32];
inline unsigned emu_fa[EMU_WARPS][32][4], emu_fb[EMU_WARPS][32][2];

inline void __syncthreads() { emu_block->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_xch[w][l] = v;
  emu_warp[w]->arrive_and_wait();
  const float r = emu_xch[w][l ^ o];
  emu_warp[w]->arrive_and_wait();
  return r;
}

inline void emu_cp(float* dst, const float* src, int size, int bytes) {
  std::memset(dst, 0, size);
  std::memcpy(dst, src, bytes);
}

// cvt.rna.tf32.f32: to nearest on the sign-magnitude pattern, ties away
inline unsigned emu_tf32(float v) {
  unsigned u = __float_as_uint(v);
  if (std::isfinite(v)) u = (u + 0x1000u) & 0xffffe000u;
  return u;
}

// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: d += A B for the warp
inline void emu_mma(float d[4], const uint4& a, unsigned b0, unsigned b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_fa[w][l][0] = a.x;
  emu_fa[w][l][1] = a.y;
  emu_fa[w][l][2] = a.z;
  emu_fa[w][l][3] = a.w;
  emu_fb[w][l][0] = b0;
  emu_fb[w][l][1] = b1;
  emu_warp[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q >> 1), col = 2 * t + (q & 1);
    double s = d[q];
    for (int k = 0; k < 8; ++k) {
      const unsigned av =
          emu_fa[w][(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)];
      const unsigned bv = emu_fb[w][col * 4 + k % 4][k >= 4];
      s += (double)__uint_as_float(av & 0xffffe000u) *
           (double)__uint_as_float(bv & 0xffffe000u);
    }
    d[q] = (float)s;
  }
  emu_warp[w]->arrive_and_wait();
}

// One launch: `threads` std::threads walk the grid's blocks together,
// one block at a time (thread 0 sets each block up between two barriers).
template <class F>
void emu_launch(dim3 grid, int threads, F body) {
  const long long n = (long long)grid.x * grid.y;
  std::barrier<> outer(threads);
  std::vector<std::thread> ts;
  for (int i = 0; i < threads; ++i)
    ts.emplace_back([&, i] {
      threadIdx = {(unsigned)i, 0, 0};
      for (long long k = 0; k < n; ++k) {
        if (i == 0) {
          blockIdx = {(unsigned)(k % grid.x), (unsigned)(k / grid.x), 0};
          blockDim = {(unsigned)threads, 1, 1};
          emu_block = std::make_unique<std::barrier<>>(threads);
          for (int w = 0; w < (threads + 31) / 32; ++w)
            emu_warp[w] = std::make_unique<std::barrier<>>(
                std::min(32, threads - 32 * w));
          std::fill(emu_smem, emu_smem + EMU_SMEM_FLOATS, std::nanf(""));
        }
        outer.arrive_and_wait();
        body();
        emu_block->arrive_and_drop();
        emu_warp[i / 32]->arrive_and_drop();
        outer.arrive_and_wait();
      }
    });
  for (auto& t : ts) t.join();
}
