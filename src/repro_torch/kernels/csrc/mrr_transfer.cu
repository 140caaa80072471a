// Noisy MRR voltage -> weight realization (paper Eqs. 3-8) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mrr_transfer/mrr_transfer.py
// (mrr_transfer_pallas, body _chain).  Elementwise over a flat stream of
// target weights:
//
//   w --inverse chain--> programming voltage V, clipped to [v_min, v_max]
//     V + sigma_dac * eps_dac  (+ dv)          per-shot DAC noise, chip offset
//     dT(V) + sigma_th * eps_th  (+ ddt)       thermal crosstalk, chip bias
//     d_lambda(dT)  (+ dlam)                   fab mismatch
//     -> Lorentzian drop-port transmission -> T_diff -> realized weight
//
// The chain is the folded form of repro_torch.core.mrr (Chain): it adds the
// small detuning to the precomputed difference of the two ~1538 nm
// wavelengths instead of subtracting them in float32, as the device
// function `realize` of rosa_fused.cu does.  The additions come in
// realize_weights' order (noise, then variation, on each of V, dT and the
// shift), and the file is built with --fmad=false with IEEE division and
// square root, so the kernel equals its plain version bit for bit.
//
// Operands: w, out and the optional draws eps_dac / eps_th are flat float
// streams of n elements (no tile padding: the kernel bounds-checks).  The
// draws are null for a variation-only realization, which then moves two
// streams fewer.  The optional static variation (dv, ddt, dlam) is read
// through (row, column) element strides against w viewed as (n / cols,
// cols): a per-lane (K,) field against a (K, N) weight is a stride-0 view
// and is never materialized.
//
// What bounds it on the H100: each element reads 4 bytes of w and 8 of
// draws and writes 4, against about 45 float operations (two divisions and
// two square roots among them), so it is bound by memory bandwidth:
// 16 B/element over 3.35 TB/s.  Design: a grid-stride loop, each thread
// taking four consecutive elements with 16-byte loads and stores when every
// stream is 16-byte aligned, and a scalar tail.  Making it fast (draws
// generated in-kernel by Philox instead of read from memory, which would
// cut the bytes by half) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// Float32 constants of the realization chain in its folded form, in the
// field order of repro_torch.core.mrr.Chain (see there for what each is).
struct Chain {
  float q_min, q_max, a_td, b_td, gamma, c_dl, d_u, d_neff, beta, e_v2, v_min,
      v_max, f_dt, g_lam, n_eff, h_det, g2, i_td, j_w;
};

struct Variation {        // dv, ddt, dlam: element (r, c) at p[r*s0 + c*s1]
  const float* p[3];
  long long s0[3], s1[3];
  __device__ __forceinline__ float at(int s, long long r, long long c) const {
    return p[s][r * s0[s] + c * s1[s]];
  }
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// op for op as repro_torch.core.mrr.realize_weights: voltage_of_chain, then
// weight_of_voltage with the draws and the variation added one at a time
template <bool NOISE, bool VAR>
__device__ __forceinline__ float realize(float w, float ed, float et, float dv,
                                         float ddt, float dlam, float sd,
                                         float st, const Chain& c) {
  float wq = clampf(w, c.q_min, c.q_max);
  float tdrop = ((wq - c.q_min) * c.a_td + c.b_td) * 0.5f;
  float det = sqrtf(fmaxf(1.0f / tdrop - 1.0f, 0.0f)) * c.gamma;
  float dl = det + c.c_dl;
  float dt = (dl * c.d_neff) / ((1.0f - dl * c.d_u) * c.beta);
  float v2 = fmaxf(dt, 0.0f) * c.e_v2;
  float v = clampf(sqrtf(fmaxf(v2, 0.0f)), c.v_min, c.v_max);
  if (NOISE) v = v + sd * ed;
  if (VAR) v = v + dv;
  float heat = (v * v) * c.f_dt;
  if (NOISE) heat = heat + st * et;
  if (VAR) heat = heat + ddt;
  float shift = (heat * c.g_lam) / (heat * c.beta + c.n_eff);
  if (VAR) shift = shift + dlam;
  float d2 = shift + c.h_det;          // detuning from the probe wavelength
  float t = c.g2 / (d2 * d2 + c.g2);
  return (2.0f * t + c.i_td) * c.j_w + c.q_min;
}

// elements [i0, i0 + width) of the stream; width 4 uses 16-byte accesses
template <bool NOISE, bool VAR, int WIDTH>
__device__ __forceinline__ void transfer_at(
    long long i0, const float* __restrict__ w, const float* __restrict__ ed,
    const float* __restrict__ et, const Variation& var,
    float* __restrict__ out, long long cols, float sd, float st,
    const Chain& c) {
  float wv[WIDTH], ev[WIDTH], tv[WIDTH], o[WIDTH];
  if (WIDTH == 4) {
    float4 a = *reinterpret_cast<const float4*>(w + i0);
    wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
    if (NOISE) {
      float4 d = *reinterpret_cast<const float4*>(ed + i0);
      float4 h = *reinterpret_cast<const float4*>(et + i0);
      ev[0] = d.x; ev[1] = d.y; ev[2] = d.z; ev[3] = d.w;
      tv[0] = h.x; tv[1] = h.y; tv[2] = h.z; tv[3] = h.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
      wv[j] = w[i0 + j];
      if (NOISE) { ev[j] = ed[i0 + j]; tv[j] = et[i0 + j]; }
    }
  }
  long long r = 0, cc = 0;
  if (VAR) { r = i0 / cols; cc = i0 - r * cols; }
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    float dv = 0.f, ddt = 0.f, dlam = 0.f;
    if (VAR) {
      dv = var.at(0, r, cc); ddt = var.at(1, r, cc); dlam = var.at(2, r, cc);
      if (++cc == cols) { cc = 0; ++r; }
    }
    o[j] = realize<NOISE, VAR>(wv[j], NOISE ? ev[j] : 0.f, NOISE ? tv[j] : 0.f,
                               dv, ddt, dlam, sd, st, c);
  }
  if (WIDTH == 4) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) out[i0 + j] = o[j];
  }
}

template <bool NOISE, bool VAR, int WIDTH>
__global__ void __launch_bounds__(THREADS)
transfer_kernel(const float* __restrict__ w, const float* __restrict__ ed,
                const float* __restrict__ et, Variation var,
                float* __restrict__ out, long long n, long long cols, float sd,
                float st, Chain c) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long groups = n / WIDTH;
  for (long long g = tid; g < groups; g += step)
    transfer_at<NOISE, VAR, WIDTH>(g * WIDTH, w, ed, et, var, out, cols, sd,
                                   st, c);
  const long long i = groups * WIDTH + tid;     // ragged tail, < WIDTH long
  if (WIDTH > 1 && i < n)
    transfer_at<NOISE, VAR, 1>(i, w, ed, et, var, out, cols, sd, st, c);
}

template <bool NOISE, bool VAR>
void launch_width(int vec, unsigned blocks, cudaStream_t st, const float* w,
                  const float* ed, const float* et, const Variation& var,
                  float* out, long long n, long long cols, float sd, float sth,
                  const Chain& c) {
  if (vec)
    transfer_kernel<NOISE, VAR, 4><<<blocks, THREADS, 0, st>>>(
        w, ed, et, var, out, n, cols, sd, sth, c);
  else
    transfer_kernel<NOISE, VAR, 1><<<blocks, THREADS, 0, st>>>(
        w, ed, et, var, out, n, cols, sd, sth, c);
}

// blocks of the grid-stride launch for n elements (vec: 4 per thread)
long long grid_blocks(long long n, int vec, int n_sm) {
  long long per_thread = vec ? 4 : 1;
  long long want = (n / per_thread + THREADS - 1) / THREADS;
  long long cap = (long long)n_sm * BLOCKS_PER_SM;
  if (want < 1) want = 1;
  return want < cap ? want : cap;
}

}  // namespace

extern "C" {

// eps_dac / eps_th: both device pointers or both null (no per-shot noise).
// var: three device pointers or null; var_strides: (row, column) element
// strides of each field against w viewed as (n / cols, cols).
// chain: the 19 float32 constants of struct Chain, in order (host memory).
// vec: every stream 16-byte aligned (4 elements per thread).
int mrr_transfer_launch(const float* w, const float* eps_dac,
                        const float* eps_th, const float* const* var,
                        const long long* var_strides, float* out, long long n,
                        long long cols, float sigma_dac, float sigma_th,
                        const float* chain, int vec, int n_sm, void* stream) {
  if ((eps_dac == nullptr) != (eps_th == nullptr) || n < 0 || cols < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Chain c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int i = 0; i < (int)(sizeof(Chain) / sizeof(float)); ++i) dst[i] = chain[i];
  Variation v;
  for (int s = 0; s < 3; ++s) {
    v.p[s] = var ? var[s] : nullptr;
    v.s0[s] = var ? var_strides[2 * s] : 0;
    v.s1[s] = var ? var_strides[2 * s + 1] : 0;
  }
  const bool noise = eps_dac != nullptr, has_var = var != nullptr;
  unsigned blocks = (unsigned)grid_blocks(n, vec, n_sm);
  cudaStream_t st = (cudaStream_t)stream;
  if (noise && has_var)
    launch_width<true, true>(vec, blocks, st, w, eps_dac, eps_th, v, out, n,
                             cols, sigma_dac, sigma_th, c);
  else if (noise)
    launch_width<true, false>(vec, blocks, st, w, eps_dac, eps_th, v, out, n,
                              cols, sigma_dac, sigma_th, c);
  else if (has_var)
    launch_width<false, true>(vec, blocks, st, w, eps_dac, eps_th, v, out, n,
                              cols, sigma_dac, sigma_th, c);
  else
    launch_width<false, false>(vec, blocks, st, w, eps_dac, eps_th, v, out, n,
                               cols, sigma_dac, sigma_th, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
