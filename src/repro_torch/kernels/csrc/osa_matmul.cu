// OSA bit-serial signed-digit matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/osa_matmul/osa_matmul.py
// (osa_matmul_pallas, body _kernel / _plane):
//
//     y[m, n] = sum_t g[t] * sum_k plane_t(q)[m, k] * w[k, n]
//     plane_t(q) = sign(q) * ((|q| >> t) & 1)
//
// q is (M, K) integer-valued float32, w is (K, N) float32, g is (T,).
// The fused mode folds the gains into one recombined operand
// x_eff = sum_t g[t] * plane_t(q) before one contraction; the per-plane
// mode sums one contraction per plane and folds the partial sums in with
// the gains.
//
// What bounds it on the H100: at the serving shapes M is 4..8 rows
// against a 5120 x 51200 or 25600 x 5120 weight read exactly once, so the
// fused mode is bound by HBM bandwidth (3.35 TB/s); the per-plane mode
// does 7x the multiply-adds on the same bytes.
//
// Decode path (M <= 16): a prologue kernel writes the activation operand
// once for the whole call (x_eff, or the T planes in the per-plane mode)
// into a small workspace laid out [K][planes][M rounded up to 4]; the
// weight then streams through skinny_stream.cuh: a 6-stage cp.async ring
// of 32 x 128 weight tiles (16-byte copies, 4-byte ones for an unaligned
// view or a ragged N), a kernel templated on M with M x 4 accumulators in
// registers per thread, split-K across blocks when N alone leaves fewer
// than 16 blocks per SM, partial tiles summed in split order by a second
// kernel (deterministic; no float atomics).  Tensor cores do not help
// (2*M flops per 4 weight bytes, far below their ridge; TF32 would break
// parity), so no wgmma.
//
// Tall path (M > 16; no ported path launches it): a block owns an 8 x 128
// output tile and loops over K in 32-deep steps through shared memory;
// row tiles past the 65535 that gridDim.y holds are taken in turn by the
// same blocks.

#include <cstdint>

#include <cuda_runtime.h>

#include "skinny_stream.cuh"

namespace {

constexpr int BM = 8;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;      // 128 columns x 2 row groups of 4 rows
constexpr int MAX_PLANES = 8;
constexpr int MAX_GRID_Y = 65535;   // CUDA's limit on gridDim.y

__device__ __forceinline__ float plane_of(float qf, int t) {
  // sign(q) * ((|q| >> t) & 1), as the TPU kernel's _plane
  float s = (qf > 0.f) ? 1.f : ((qf < 0.f) ? -1.f : 0.f);
  int mag = (int)fabsf(qf);
  return s * (float)((mag >> t) & 1);
}

// The weight needs no conditioning and a sum no scale.
struct Identity {
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ void condition(float (&)[4], int, int,
                                            int) const {}
  __device__ __forceinline__ float flush(float s, int) const { return s; }
};

// Decode prologue: xr[k][t][r] = plane_t(q[r, k]) (per-plane) or
// xr[k][0][r] = x_eff[r, k] (fused), rows r >= m zero.
__global__ void osa_operand(const float* __restrict__ q,
                            const float* __restrict__ gains,
                            float* __restrict__ xr, int m, int k, int ldq,
                            int n_planes, int fused, int mp) {
  const long long total = (long long)k * mp;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int kk = (int)(i / mp), r = (int)(i % mp);
    const float qv = r < m ? q[(long long)r * ldq + kk] : 0.f;
    if (fused) {
      float xe = 0.f;
      for (int t = 0; t < n_planes; ++t) xe = xe + gains[t] * plane_of(qv, t);
      xr[i] = xe;
    } else {
      for (int t = 0; t < n_planes; ++t)
        xr[((long long)kk * n_planes + t) * mp + r] = plane_of(qv, t);
    }
  }
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
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int col = tid % BN;
  const int rg = tid / BN;                    // rows rg*4 .. rg*4+3
  if (tid < n_planes) g[tid] = gains[tid];
  const int m_tiles = (m + BM - 1) / BM;

  // M tiles beyond the grid's y limit (65535) are taken in turn
  for (int mt = blockIdx.y; mt < m_tiles; mt += gridDim.y) {
    const int m0 = mt * BM;
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
          for (int r = 0; r < 4; ++r)
            acc[r] = fmaf(xs[0][rg * 4 + r][kk], wv, acc[r]);
        }
      } else {
        for (int t = 0; t < n_planes; ++t) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) {
            float wv = ws[kk][col];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              p[r] = fmaf(xs[t][rg * 4 + r][kk], wv, p[r]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r] = acc[r] + g[t] * p[r];
        }
      }
    }
    const int gn = n0 + col;
    if (gn < n) {
      float* dst = out + (long long)blockIdx.z * m * ldo;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int gm = m0 + rg * 4 + r;
        if (gm < m) dst[(long long)gm * ldo + gn] = acc[r];
      }
    }
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

// q (m, k), w (k, n), out (m, n) with row strides ldq, ldw, ldo.  The
// caller plans the launch (repro_torch.kernels.osa_matmul.ops.plan):
// splits and k_per_split, and two workspaces: xr (decode only, k *
// planes * pad4(m) floats) and part (splits * m * n floats when
// splits > 1).
int osa_matmul_launch(const float* q, const float* w, const float* gains,
                      float* out, float* xr, float* part, int m, int k, int n,
                      int ldq, int ldw, int ldo, int n_planes, int fused,
                      int splits, int k_per_split, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || m < 1 || splits < 1 ||
      k_per_split < 1 || (long long)k_per_split * splits < k ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* dst = splits > 1 ? part : out;
  cudaError_t err;
  if (m <= skinny::MAX_M) {
    if (xr == nullptr) return (int)cudaErrorInvalidValue;
    const int mp = skinny::pad4(m);
    const long long total = (long long)k * mp;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                          : 4096);
    osa_operand<<<blocks, 256, 0, st>>>(q, gains, xr, m, k, ldq, n_planes,
                                        fused, mp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int vec = ((uintptr_t)w % 16 == 0) && (ldw % 4 == 0);
    err = fused ? skinny::launch<false>(m, w, xr, gains, dst, k, n, ldw, ldo,
                                        n_planes, k_per_split, splits, vec,
                                        Identity{}, st)
                : skinny::launch<true>(m, w, xr, gains, dst, k, n, ldw, ldo,
                                       n_planes, k_per_split, splits, vec,
                                       Identity{}, st);
  } else {
    const int m_tiles = (m + BM - 1) / BM;
    dim3 grid((n + BN - 1) / BN, m_tiles < MAX_GRID_Y ? m_tiles : MAX_GRID_Y,
              splits);
    const int ld = splits > 1 ? n : ldo;
    if (fused)
      osa_kernel<true><<<grid, THREADS, 0, st>>>(
          q, w, gains, dst, m, k, n, ldq, ldw, ld, n_planes, k_per_split);
    else
      osa_kernel<false><<<grid, THREADS, 0, st>>>(
          q, w, gains, dst, m, k, n, ldq, ldw, ld, n_planes, k_per_split);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  long long total = (long long)m * n;
  sum_splits<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, out, m,
                                                              n, ldo, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
