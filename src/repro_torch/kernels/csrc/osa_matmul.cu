// OSA bit-serial signed-digit matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/osa_matmul/osa_matmul.py
// (osa_matmul_pallas, body _kernel / _plane):
//
//     y[m, n] = sum_t g[t] * sum_k plane_t(q)[m, k] * w[k, n]
//     plane_t(q) = sign(q) * ((|q| >> t) & 1)
//
// q is (M, K) integer-valued float32, w is (K, N) float32, g is (T,).
//
// What bounds it on the H100: at the serving shapes M is 4..8, so every
// weight element is used M times; the kernel reads K*N*4 bytes of w once
// and is bound by memory bandwidth (3.35 TB/s), not by arithmetic.
// Design: a block owns a BM x BN output tile and loops over K in BK steps.
// Each step stages the q tile (digit planes recombined with the gains in
// shared memory, the "fused" mode: one contraction instead of T) and the
// w tile, loaded coalesced, then each thread accumulates a 4 x 1 column
// strip in registers with explicit fmaf.  When the (M, N) grid has too few
// blocks to fill the 132 SMs (the (25600, 5120) projection), K is split
// across blocks; each split writes its partial tile to a workspace and a
// second kernel sums the splits in a fixed order, so results are
// deterministic.  The per-plane mode keeps T partial sums per output and
// folds each K tile in as acc += g[t] * partial_t, the order of the TPU
// kernel.  wgmma, TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 8;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;      // 128 columns x 2 row groups of 4 rows
constexpr int MAX_PLANES = 8;

__device__ __forceinline__ float plane_of(float qf, int t) {
  // sign(q) * ((|q| >> t) & 1), as the TPU kernel's _plane
  float s = (qf > 0.f) ? 1.f : ((qf < 0.f) ? -1.f : 0.f);
  int mag = (int)fabsf(qf);
  return s * (float)((mag >> t) & 1);
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
osa_kernel(const float* __restrict__ q, const float* __restrict__ w,
           const float* __restrict__ gains, float* __restrict__ out,
           int m, int k, int n, int ldq, int ldw, int ldo, int n_planes,
           int k_per_split) {
  __shared__ float xs[MAX_PLANES][BM][BK];   // fused: plane 0 holds x_eff
  __shared__ float ws[BK][BN];
  __shared__ float g[MAX_PLANES];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int col = tid % BN;
  const int rg = tid / BN;                    // rows rg*4 .. rg*4+3
  if (tid < n_planes) g[tid] = gains[tid];

  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();
    // q tile: BM x BK values, conditioned once into shared memory
    for (int i = tid; i < BM * BK; i += THREADS) {
      int r = i / BK, c = i % BK;
      int gm = m0 + r, gk = kt + c;
      float qv = (gm < m && gk < k_end) ? q[(long long)gm * ldq + gk] : 0.f;
      if (FUSED) {
        float xe = 0.f;
        for (int t = 0; t < n_planes; ++t) xe = xe + g[t] * plane_of(qv, t);
        xs[0][r][c] = xe;
      } else {
        for (int t = 0; t < n_planes; ++t) xs[t][r][c] = plane_of(qv, t);
      }
    }
    // w tile: BK x BN, coalesced along N
    for (int i = tid; i < BK * BN; i += THREADS) {
      int r = i / BN, c = i % BN;
      int gk = kt + r, gn = n0 + c;
      ws[r][c] = (gk < k_end && gn < n) ? w[(long long)gk * ldw + gn] : 0.f;
    }
    __syncthreads();
    if (FUSED) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float wv = ws[kk][col];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = fmaf(xs[0][rg * 4 + r][kk], wv, acc[r]);
      }
    } else {
      for (int t = 0; t < n_planes; ++t) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          float wv = ws[kk][col];
#pragma unroll
          for (int r = 0; r < 4; ++r) p[r] = fmaf(xs[t][rg * 4 + r][kk], wv, p[r]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = acc[r] + g[t] * p[r];
      }
    }
  }
  const int gn = n0 + col;
  if (gn >= n) return;
  float* dst = out + (long long)blockIdx.z * m * ldo;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int gm = m0 + rg * 4 + r;
    if (gm < m) dst[(long long)gm * ldo + gn] = acc[r];
  }
}

__global__ void sum_splits(const float* __restrict__ ws, float* __restrict__ out,
                           int m, int n, int ldo, int splits) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)m * n) return;
  int r = (int)(i / n), c = (int)(i % n);
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s = s + ws[((long long)z * m + r) * n + c];
  out[(long long)r * ldo + c] = s;
}

}  // namespace

extern "C" {

// Number of K splits the launcher uses for an (m, k, n) problem; the
// wrapper sizes the workspace (splits * m * n floats when splits > 1).
int osa_matmul_splits(int m, int k, int n, int n_sm) {
  long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  long long want = (2LL * n_sm + tiles - 1) / tiles;
  long long max_split = (k + BK - 1) / BK;
  long long s = want < max_split ? want : max_split;
  return s < 1 ? 1 : (int)s;
}

int osa_matmul_launch(const float* q, const float* w, const float* gains,
                      float* out, float* workspace, int m, int k, int n,
                      int ldq, int ldw, int ldo, int n_planes, int fused,
                      int splits, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int k_per_split = ((k + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (k + k_per_split - 1) / k_per_split;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  float* dst = splits > 1 ? workspace : out;
  int ld = splits > 1 ? n : ldo;
  if (fused)
    osa_kernel<true><<<grid, THREADS, 0, st>>>(q, w, gains, dst, m, k, n, ldq,
                                              ldw, ld, n_planes, k_per_split);
  else
    osa_kernel<false><<<grid, THREADS, 0, st>>>(q, w, gains, dst, m, k, n, ldq,
                                               ldw, ld, n_planes, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  long long total = (long long)m * n;
  sum_splits<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(workspace, out, m,
                                                              n, ldo, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
