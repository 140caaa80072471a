// A CPU emulation of the CUDA subset the repo's ssd_scan and rosa_fused
// kernels use, for tests/test_torch_ssd_kernel_emu.py and
// tests/test_torch_rosa_fused_emu.py: blocks run one at a time, each
// thread of a block as a std::thread; __syncthreads is a barrier (a
// thread that returns drops out of it, as on the card), shuffles and
// mma.sync exchange through per-warp buffers, cp.async copies at once
// with its zero fill, cvt.rna.tf32 is bit arithmetic.  Shared memory
// starts as NaN, so a read of what no thread wrote shows.  It checks
// indexing, masks, barriers and the order of sums, never speed: an
// m16n8k8 product is modelled as its exact sum rounded once to float32,
// an m16n8k32 s8 one as its exact integer sum.  A warp's tile of
// products over one step (emu_mma_*_tile) exchanges all its fragments at
// once and reads them back in the PTX fragment layouts.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
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
inline uint3 blockIdx, blockDim, gridDim;

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
template <class T>
inline T __ldg(const T* p) { return *p; }
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
inline unsigned emu_ta[EMU_WARPS][32][32], emu_tb[EMU_WARPS][32][16];

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

// Fragment element (row, k) of an m16n8k8 TF32 A operand held in words
// a[lane][base + reg]; (k, col) of its B operand in b[lane][base + reg].
inline float emu_a_tf32(const unsigned (*a)[32], int base, int row, int k) {
  return __uint_as_float(
      a[(row % 8) * 4 + k % 4][base + (row >= 8) + 2 * (k >= 4)] &
      0xffffe000u);
}
inline float emu_b_tf32(const unsigned (*b)[16], int base, int k, int col) {
  return __uint_as_float(b[col * 4 + k % 4][base + (k >= 4)] & 0xffffe000u);
}

// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 over a warp's MT x 4 tiles:
// acc[i][j] += A_i B_j, A_i in a[i] (rows g, g + 8; k 4t.., 16 + 4t..), B_j
// in b[j] (column g; k 4t.., 16 + 4t..), each word four bytes.
template <int MT>
void emu_mma_s8_tile(int (&acc)[MT][4][4], const unsigned (&a)[MT][4],
                     const unsigned (&b)[4][2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < MT; ++i)
    for (int e = 0; e < 4; ++e) emu_ta[w][l][4 * i + e] = a[i][e];
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 2; ++e) emu_tb[w][l][2 * j + e] = b[j][e];
  emu_warp[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  auto byte = [](unsigned word, int k) { return (int)(int8_t)(word >> (8 * (k % 4))); };
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < 4; ++j)
      for (int q = 0; q < 4; ++q) {
        const int row = g + 8 * (q >> 1), col = 2 * t + (q & 1);
        long long s = acc[i][j][q];
        for (int k = 0; k < 32; ++k) {
          const int tk = (k % 16) / 4;
          const int av = byte(emu_ta[w][(row % 8) * 4 + tk]
                                    [4 * i + (row >= 8) + 2 * (k >= 16)], k);
          const int bv = byte(emu_tb[w][col * 4 + tk][2 * j + (k >= 16)], k);
          s += (long long)av * bv;
        }
        acc[i][j][q] = (int)s;
      }
  emu_warp[w]->arrive_and_wait();
}

// mma.sync.m16n8k8 TF32 over a warp's MT x 4 tiles, the passes of a split
// in order (SPLIT_A: lo.hi, then hi.lo, hi.hi; else hi.lo, hi.hi), each
// 8-deep product added to acc as its exact sum rounded once.
template <int MT, bool SPLIT_A>
void emu_mma_tf32_tile(float (&acc)[MT][4][4], const unsigned (&ah)[MT][4],
                       const unsigned (&al)[MT][4],
                       const unsigned (&bh)[4][2],
                       const unsigned (&bl)[4][2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < MT; ++i)
    for (int e = 0; e < 4; ++e) {
      emu_ta[w][l][4 * i + e] = ah[i][e];
      emu_ta[w][l][16 + 4 * i + e] = al[i][e];
    }
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 2; ++e) {
      emu_tb[w][l][2 * j + e] = bh[j][e];
      emu_tb[w][l][8 + 2 * j + e] = bl[j][e];
    }
  emu_warp[w]->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  // (A base, B base) of each pass: hi at 0, lo at 16 (A) / 8 (B)
  const int passes[3][2] = {{16, 0}, {0, 8}, {0, 0}};
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < 4; ++j)
      for (int ps = SPLIT_A ? 0 : 1; ps < 3; ++ps)
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q >> 1), col = 2 * t + (q & 1);
          double s = acc[i][j][q];
          for (int k = 0; k < 8; ++k)
            s += (double)emu_a_tf32(emu_ta[w], passes[ps][0] + 4 * i, row,
                                    k) *
                 (double)emu_b_tf32(emu_tb[w], passes[ps][1] + 2 * j, k, col);
          acc[i][j][q] = (float)s;
        }
  emu_warp[w]->arrive_and_wait();
}

// One launch: `threads` std::threads walk the grid's blocks together,
// one block at a time (thread 0 sets each block up between two barriers).
template <class F>
void emu_launch(dim3 grid, int threads, F body) {
  const long long n = (long long)grid.x * grid.y * grid.z;
  std::barrier<> outer(threads);
  std::vector<std::thread> ts;
  for (int i = 0; i < threads; ++i)
    ts.emplace_back([&, i] {
      threadIdx = {(unsigned)i, 0, 0};
      for (long long k = 0; k < n; ++k) {
        if (i == 0) {
          blockIdx = {(unsigned)(k % grid.x),
                      (unsigned)(k / grid.x % grid.y),
                      (unsigned)(k / ((long long)grid.x * grid.y))};
          blockDim = {(unsigned)threads, 1, 1};
          gridDim = {grid.x, grid.y, grid.z};
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
