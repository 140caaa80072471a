// Skinny-M streaming contraction for Hopper (sm_90a), shared by
// osa_matmul.cu and rosa_fused.cu.
//
//     out[m, n] = sum_k xr[k, m] * op(w[k, n]),   M <= 16
//
// At decode the activation operand is a few rows and the weight is
// 0.5-1 GB of float32 read exactly once, so the contraction is bound by
// HBM (3.35 TB/s): 2*M flops per 4 weight bytes is far below the ridge of
// any unit, tensor cores included, and TF32 would break parity, so the
// multiply-adds stay float32 fmaf on the CUDA cores and no wgmma is used.
// What the design does to stream the weight at that rate:
//
//   * a block owns BN = 128 columns (32 lanes x float4) of one K range and
//     streams its weight rows through a STAGES-deep ring in shared memory
//     with 16-byte cp.async.cg copies (4-byte copies for an unaligned view
//     or the ragged edge of N); each stage is BK = 32 rows (16 KB of
//     weight plus the activation slice).  Two blocks fit an SM in the
//     fused mode, so up to 10 stages (~180 KB) are in flight per SM;
//   * the activation operand was conditioned once for the whole call by
//     a prologue kernel into xr, laid out [K][planes][MP] (MP = M rounded
//     up to 4), and streams beside the weight in the same stage;
//   * the kernel is templated on M: each thread keeps M x 4 accumulators
//     in registers and no padded row is accumulated;
//   * the 8 warps of a block take interleaved rows of each stage; at the
//     end their partial sums meet in shared memory and are added in warp
//     order;
//   * K is split across blocks (grid y) when N alone leaves too few
//     blocks to fill the card; each split writes its partial tile to a
//     workspace that a second kernel sums in split order, so results are
//     run-to-run deterministic (no float atomics).
//
// `Op` conditions a staged float4 of weights in registers (osa_matmul:
// nothing; rosa_fused: codes, realization, blends) and scales a finished
// sum (`flush`).

#pragma once

#include <cuda_runtime.h>

namespace skinny {

constexpr int BN = 128;        // columns per block
constexpr int BK = 32;         // weight rows per ring stage
constexpr int THREADS = 256;   // 8 warps: 32 float4 lanes x 8 row groups
constexpr int LANES = BN / 4;
constexpr int KG = THREADS / LANES;
constexpr int RPT = BK / KG;   // rows a thread takes of each stage
constexpr int STAGES = 6;
constexpr int MAX_M = 16;

__host__ __device__ constexpr int pad4(int m) { return (m + 3) / 4 * 4; }

// floats of one ring stage: the weight tile and the activation slice
__host__ __device__ inline int stage_floats(int mp, int planes) {
  return BK * BN + BK * planes * mp;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of the stage whose first row is kt into buf.  Rows at
// or past k_end and columns past n are zero-filled with plain stores.
__device__ __forceinline__ void load_stage(
    float* buf, const float* __restrict__ w, int ldw, bool vec, int kt,
    int k_end, int n0, int n, const float* __restrict__ xr, int row_floats) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < BK * LANES / THREADS; ++j) {
    const int v = tid + j * THREADS;
    const int r = v / LANES, c = (v % LANES) * 4;
    const int gk = kt + r, gn = n0 + c;
    float* dst = buf + r * BN + c;
    const float* src = w + (long long)gk * ldw + gn;
    if (gk < k_end && vec && gn + 3 < n) {
      cp_async16(dst, src);
    } else if (gk < k_end && gn < n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gn + e < n) cp_async4(dst + e, src + e);
        else dst[e] = 0.f;
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float* xs = buf + BK * BN;
  const int vecs = BK * row_floats / 4;
  for (int v = tid; v < vecs; v += THREADS) {
    const int r = (v * 4) / row_floats;
    if (kt + r < k_end)
      cp_async16(xs + v * 4, xr + (long long)kt * row_floats + v * 4);
    else
      *reinterpret_cast<float4*>(xs + v * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One block: columns [blockIdx.x * BN, +BN), rows [blockIdx.y *
// k_per_split, +k_per_split).  PLANES: xr holds n_planes binary planes per
// row and the block sums one contraction per plane, folding each stage's
// partial sums in with the gains (the per-plane mode); otherwise xr holds
// one recombined operand.  direct: write op.flush(sum) to out (ldo);
// otherwise the raw partial sum to out[(split * M + m) * n + col].
template <int M, bool PLANES, class Op>
__global__ void __launch_bounds__(THREADS, PLANES ? 1 : 2)
skinny_kernel(const float* __restrict__ w, const float* __restrict__ xr,
              const float* __restrict__ gains, float* __restrict__ out,
              int k, int n, int ldw, int ldo, int n_planes, int k_per_split,
              int vec, int direct, Op op) {
  extern __shared__ __align__(16) float smem[];
  constexpr int MP = pad4(M);
  const int planes = PLANES ? n_planes : 1;
  const int row_floats = planes * MP;
  const int sf = stage_floats(MP, planes);
  const int tid = threadIdx.x, lane = tid % LANES, kg = tid / LANES;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int steps = (k_end - k_begin + BK - 1) / BK;
  const int gn = n0 + lane * 4;
  op.init();

  float acc[M][4];
#pragma unroll
  for (int mm = 0; mm < M; ++mm)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mm][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage(smem + s * sf, w, ldw, vec, k_begin + s * BK, k_end, n0, n,
                 xr, row_floats);
    cp_commit();
  }

  for (int i = 0; i < steps; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();           // stage i landed; stage i - 1 is consumed
    const int nxt = i + STAGES - 1;
    if (nxt < steps)
      load_stage(smem + (nxt % STAGES) * sf, w, ldw, vec,
                 k_begin + nxt * BK, k_end, n0, n, xr, row_floats);
    cp_commit();

    const float* ws = smem + (i % STAGES) * sf;
    const float* xs = ws + BK * BN;
    const int kt = k_begin + i * BK;
    const int rows = min(BK, k_end - kt);
    if (!PLANES) {
      for (int kk = kg; kk < rows; kk += KG) {
        float4 w4 = *reinterpret_cast<const float4*>(ws + kk * BN + lane * 4);
        float v[4] = {w4.x, w4.y, w4.z, w4.w};
        op.condition(v, kt + kk, gn, n);
        const float* xp = xs + kk * MP;
#pragma unroll
        for (int g4 = 0; g4 < MP / 4; ++g4) {
          float4 x4 = *reinterpret_cast<const float4*>(xp + 4 * g4);
          float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * g4 + e < M) {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[4 * g4 + e][c] = fmaf(xv[e], v[c], acc[4 * g4 + e][c]);
            }
          }
        }
      }
    } else {
      // the thread's rows of this stage, conditioned once
      float v[RPT][4];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int kk = kg + j * KG;
        float4 w4 = *reinterpret_cast<const float4*>(ws + kk * BN + lane * 4);
        v[j][0] = w4.x; v[j][1] = w4.y; v[j][2] = w4.z; v[j][3] = w4.w;
        if (kk < rows) op.condition(v[j], kt + kk, gn, n);
      }
      for (int t = 0; t < planes; ++t) {
        float p[M][4];
#pragma unroll
        for (int mm = 0; mm < M; ++mm)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[mm][c] = 0.f;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int kk = kg + j * KG;
          if (kk >= rows) break;
          const float* xp = xs + (kk * planes + t) * MP;
#pragma unroll
          for (int g4 = 0; g4 < MP / 4; ++g4) {
            float4 x4 = *reinterpret_cast<const float4*>(xp + 4 * g4);
            float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (4 * g4 + e < M) {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  p[4 * g4 + e][c] = fmaf(xv[e], v[j][c], p[4 * g4 + e][c]);
              }
            }
          }
        }
        const float gt = gains[t];
#pragma unroll
        for (int mm = 0; mm < M; ++mm)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mm][c] = acc[mm][c] + gt * p[mm][c];
      }
    }
  }

  // the row groups' partial sums meet in shared memory (the ring is
  // drained) and are added in row-group order
  cp_wait<0>();
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int mm = 0; mm < M; ++mm)
    *reinterpret_cast<float4*>(red + (kg * M + mm) * BN + lane * 4) =
        make_float4(acc[mm][0], acc[mm][1], acc[mm][2], acc[mm][3]);
  __syncthreads();
  for (int o = tid; o < M * BN; o += THREADS) {
    const int mm = o / BN, col = n0 + o % BN;
    if (col >= n) continue;
    float s = red[o];
#pragma unroll
    for (int g = 1; g < KG; ++g) s = s + red[g * M * BN + o];
    if (direct)
      out[(long long)mm * ldo + col] = op.flush(s, mm);
    else
      out[((long long)blockIdx.y * M + mm) * n + col] = s;
  }
}

// Dynamic shared memory of one block: the ring (the final reduction
// reuses it).
inline size_t smem_bytes(int m, int planes) {
  return sizeof(float) * STAGES * (size_t)stage_floats(pad4(m), planes);
}

template <int M, bool PLANES, class Op>
cudaError_t launch_m(const float* w, const float* xr, const float* gains,
                     float* out, int k, int n, int ldw, int ldo, int n_planes,
                     int k_per_split, int splits, int vec, const Op& op,
                     cudaStream_t st) {
  if (k_per_split % BK != 0) return cudaErrorInvalidValue;
  auto kern = skinny_kernel<M, PLANES, Op>;
  // the shared-memory limit is raised once per device, to the most any
  // plane count needs
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(raised & (1u << dev))) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(M, PLANES ? 8 : 1));
    if (err != cudaSuccess) return err;
    if (dev < 32) raised |= 1u << dev;
  }
  dim3 grid((n + BN - 1) / BN, splits);
  kern<<<grid, THREADS, smem_bytes(M, PLANES ? n_planes : 1), st>>>(
      w, xr, gains, out, k, n, ldw, ldo, n_planes, k_per_split, vec,
      splits == 1, op);
  return cudaGetLastError();
}

// Dispatch on the runtime row count to the kernel templated on it.
template <bool PLANES, class Op>
cudaError_t launch(int m, const float* w, const float* xr,
                   const float* gains, float* out, int k, int n, int ldw,
                   int ldo, int n_planes, int k_per_split, int splits,
                   int vec, const Op& op, cudaStream_t st) {
#define SKINNY_CASE(MM)                                                     \
  case MM:                                                                  \
    return launch_m<MM, PLANES, Op>(w, xr, gains, out, k, n, ldw, ldo,      \
                                    n_planes, k_per_split, splits, vec, op, \
                                    st);
  switch (m) {
    SKINNY_CASE(1) SKINNY_CASE(2) SKINNY_CASE(3) SKINNY_CASE(4)
    SKINNY_CASE(5) SKINNY_CASE(6) SKINNY_CASE(7) SKINNY_CASE(8)
    SKINNY_CASE(9) SKINNY_CASE(10) SKINNY_CASE(11) SKINNY_CASE(12)
    SKINNY_CASE(13) SKINNY_CASE(14) SKINNY_CASE(15) SKINNY_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef SKINNY_CASE
}

}  // namespace skinny
