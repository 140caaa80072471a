// Noisy MRR voltage -> weight realization (paper Eqs. 3-8) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mrr_transfer/mrr_transfer.py
// (mrr_transfer_pallas, body _chain).  Elementwise over target weights:
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
// Operands: w, out and the optional draws eps_dac / eps_th are float
// streams of n elements, viewed as a (rows, cols) sheet (the wrapper picks
// the view).  The draws are null for a variation-only realization, which
// then moves two streams fewer.  The optional static variation (dv, ddt,
// dlam) comes in one of three layouts: per row (a per-lane (K,) field
// against a (K, N) weight: element r at p[r * s0]), per column (against
// (M, K) activations: element c at p[c * s1]), or any broadcast view
// (element (r, c) at p[r * s0 + c * s1]); none is materialized.
//
// What bounds it on the H100: each element reads 4 bytes of w and 8 of
// draws and writes 4, so by bytes 16 B/element over 3.35 TB/s (8 B without
// draws).  But the chain is four IEEE divisions and two IEEE square roots
// among ~40 float operations, each division and root a multi-instruction
// sequence, so on a chip-only sheet the instruction issue rate is the
// floor (PERF.md states it from the SASS).  A grid-stride walk of the
// flat index adds to that, per group of four elements, a 64-bit integer
// division (the row of a flat index), 64-bit address arithmetic for each
// of three fields and a per-element row-wrap check, and reloads all three
// fields for every element; this kernel does none of that.
//
// Design: without a chip the elements are one stream, each block taking
// `groups` x 256 segments of 4 (16-byte accesses when every stream is
// 16-byte aligned, else segments of 1), with no index math beyond a
// 64-bit block base and 32-bit offsets.  With a chip, blocks walk 2-D
// tiles of the (rows, cols) sheet, 8 warps x rpt rows by 32 lanes x V
// columns (V = 4 when rows also start aligned), so each thread knows its
// row and column without a division; the row base is 64-bit once per row.
// A per-row field is read once per row and a per-column field once per
// thread, into registers.  Row tiles sit on grid y (<= 65535, taken in
// turn past it), column tiles on x; `groups` and `rpt` shrink for small
// tensors so that every SM gets blocks.  Draws made in the kernel
// (Philox) would halve the noisy sheet's bytes but change which numbers a
// key-driven call consumes; parity is by injected draws (ROADMAP), so
// they are read.
//
// Backward (mrr_transfer_backward_launch): dq = g * d realize / d w,
// elementwise.  The reference has no Pallas backward: JAX differentiates
// the jnp chain of src/repro/core/mrr.py:265 (realize_weights).  The
// kernel walks the same plan and lane layouts as the forward, reads g
// beside w (and the draws), recomputes the forward chain in registers
// (nothing is saved by the forward, which would cost every evaluation a
// second output stream), and writes the chain's derivative out once, from
// the output back, op for op as its plain version
// repro_torch.kernels.mrr_transfer.ref.mrr_transfer_grad_ref.  A clip
// passes the whole gradient at a tie, as torch.clamp does.  Bytes: 12 per
// element (w, g, dq), 20 with draws.  Each IEEE division is a
// multi-instruction sequence with a branch to its slow path, so the
// chain and its derivative take one division per distinct denominator
// (five, where a division per quotient took ten) and reuse the
// reciprocal; with the two square roots they still set the kernel's
// instruction floor near its bytes (PERF.md states it from the SASS, as
// for the forward).

#include <cuda_runtime.h>

// A chip's dv, ddt, dlam: element (r, c) at p[r * s0 + c * s1] (VAR_ROW
// reads p[r * s0], VAR_COL p[c * s1]).  Outside the anonymous namespace:
// the C interface takes it.
struct Fields {
  const float* p[3];
  long long s0[3], s1[3];
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Blocks an SM each kernel is built for (__launch_bounds__ then caps its
// registers at 65536 / (THREADS x this); 0 sets no minimum).  Chosen on
// the H100 with tools/mrr_bwd_blocks.py (PERF.md): the backward's kernels
// of single-element lanes (V 1) at 8, so 32 registers and 64 warps an SM
// (the conv_stem sheet's per-column backward 15 % faster than without a
// minimum); the backward's 16-byte ones (V 4) at none (38-80 registers: a
// minimum of 6 or 8 slowed the noisy sheet by 2-16 % and the full-shape
// field by 70-140 %), and the forward's at none, as they were built.
template <bool BWD, int V>
constexpr int BLOCKS_PER_SM = BWD && V == 1 ? 8 : 0;
enum { VAR_NONE = 0, VAR_ROW = 1, VAR_COL = 2, VAR_ANY = 3 };

// Float32 constants of the realization chain in its folded form, in the
// field order of repro_torch.core.mrr.Chain (see there for what each is).
struct Chain {
  float q_min, q_max, a_td, b_td, gamma, c_dl, d_u, d_neff, beta, e_v2, v_min,
      v_max, f_dt, g_lam, n_eff, h_det, g2, i_td, j_w;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

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

// g * d realize / d w: the forward chain recomputed, then its derivative
// from the output back (ref.mrr_transfer_grad_ref op for op).  Each
// distinct denominator is divided into 1 once and the reciprocal serves
// every quotient by it: five IEEE divisions where a quotient apiece took
// ten (1 / (s sq) gives 1 / s as sq times it and 1 / sq as s times it).
// w stays inside [q_min, q_max] after the clip, so tdrop, r, sq and s are
// positive: no division by zero is reached.
template <bool NOISE, bool VAR>
__device__ __forceinline__ float realize_grad(float w, float g, float ed,
                                              float et, float dv, float ddt,
                                              float dlam, float sd, float st,
                                              const Chain& c) {
  float wq = clampf(w, c.q_min, c.q_max);
  float tdrop = ((wq - c.q_min) * c.a_td + c.b_td) * 0.5f;
  float it = 1.0f / tdrop;
  float r = it - 1.0f;
  float sq = sqrtf(fmaxf(r, 0.0f));
  float dl = sq * c.gamma + c.c_dl;
  float iden = 1.0f / ((1.0f - dl * c.d_u) * c.beta);
  float dt = (dl * c.d_neff) * iden;
  float v2 = fmaxf(dt, 0.0f) * c.e_v2;
  float s = sqrtf(fmaxf(v2, 0.0f));
  float v = clampf(s, c.v_min, c.v_max);
  if (NOISE) v = v + sd * ed;
  if (VAR) v = v + dv;
  float heat = (v * v) * c.f_dt;
  if (NOISE) heat = heat + st * et;
  if (VAR) heat = heat + ddt;
  float ihd = 1.0f / (heat * c.beta + c.n_eff);
  float shift = (heat * c.g_lam) * ihd;
  if (VAR) shift = shift + dlam;
  float d2 = shift + c.h_det;
  float iden2 = 1.0f / (d2 * d2 + c.g2);
  float t = iden2 * c.g2;
  float iss = 1.0f / (s * sq);
  // derivative, from the output back
  float gt = (g * c.j_w) * 2.0f;                        // d/dt (2t + i) j
  float gd2 = -((gt * t) * ((d2 + d2) * iden2));        // t = g2 / den2
  float gheat = ((gd2 * c.g_lam) * c.n_eff) * (ihd * ihd);  // shift(heat)
  float gv = (gheat * (v + v)) * c.f_dt;                // heat = v^2 f
  float gs = (s >= c.v_min && s <= c.v_max) ? gv : 0.0f;
  float gv2 = v2 >= 0.0f ? (gs * 0.5f) * (sq * iss) : 0.0f;  // s = sqrt(v2)
  float gdt = dt >= 0.0f ? gv2 * c.e_v2 : 0.0f;
  float gdl = (gdt * ((dt * c.d_u) * c.beta + c.d_neff)) * iden;  // dt(dl)
  float gr = r >= 0.0f ? ((gdl * c.gamma) * 0.5f) * (s * iss) : 0.0f;
  float gwq = ((-gr * (it * it)) * 0.5f) * c.a_td;      // 1/tdrop(wq)
  return (w >= c.q_min && w <= c.q_max) ? gwq : 0.0f;
}

// nc <= V consecutive elements at flat offset i (16-byte accesses when V
// is 4 and all 4 are there); field(s, j) gives element j's chip field s.
// BWD: read the gradient gr beside w and write d realize / d w times it.
template <bool NOISE, bool VAR, bool BWD, int V, class Field>
__device__ __forceinline__ void segment(
    const float* __restrict__ w, const float* __restrict__ gr,
    const float* __restrict__ ed, const float* __restrict__ et,
    float* __restrict__ out, long long i, int nc, Field field, float sd,
    float st, const Chain& ch) {
  float wv[V], gv[V], ev[V], tv[V], o[V];
  const bool full = V == 4 && nc == 4;
  if (full) {
    const float4 a = *reinterpret_cast<const float4*>(w + i);
    wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
    if (BWD) {
      const float4 b = *reinterpret_cast<const float4*>(gr + i);
      gv[0] = b.x; gv[1] = b.y; gv[2] = b.z; gv[3] = b.w;
    }
    if (NOISE) {
      const float4 d = *reinterpret_cast<const float4*>(ed + i);
      const float4 h = *reinterpret_cast<const float4*>(et + i);
      ev[0] = d.x; ev[1] = d.y; ev[2] = d.z; ev[3] = d.w;
      tv[0] = h.x; tv[1] = h.y; tv[2] = h.z; tv[3] = h.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      wv[j] = j < nc ? w[i + j] : 0.f;
      gv[j] = BWD && j < nc ? gr[i + j] : 0.f;
      ev[j] = NOISE && j < nc ? ed[i + j] : 0.f;
      tv[j] = NOISE && j < nc ? et[i + j] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float dv = VAR ? field(0, j) : 0.f, ddt = VAR ? field(1, j) : 0.f,
                dlam = VAR ? field(2, j) : 0.f;
    if constexpr (BWD)
      o[j] = realize_grad<NOISE, VAR>(wv[j], gv[j], ev[j], tv[j], dv, ddt,
                                      dlam, sd, st, ch);
    else
      o[j] = realize<NOISE, VAR>(wv[j], ev[j], tv[j], dv, ddt, dlam, sd, st,
                                 ch);
  }
  if (full) {
    *reinterpret_cast<float4*>(out + i) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < nc) out[i + j] = o[j];
  }
}

// Without a chip: the n elements as one stream, each block taking
// `groups` x THREADS segments of V (32-bit offsets from its 64-bit base).
template <bool NOISE, bool BWD, int V>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM<BWD, V>)
transfer_kernel_flat(const float* __restrict__ w,
                     const float* __restrict__ gr,
                     const float* __restrict__ ed,
                     const float* __restrict__ et, float* __restrict__ out,
                     long long n, int groups, float sd, float st, Chain ch) {
  const long long base = (long long)blockIdx.x * groups * THREADS * V;
  for (int k = 0; k < groups; ++k) {
    const long long i = base + (k * THREADS + (int)threadIdx.x) * V;
    if (i >= n) return;
    segment<NOISE, false, BWD, V>(w, gr, ed, et, out, i,
                                  (int)min((long long)V, n - i),
                                  [](int, int) { return 0.f; }, sd, st, ch);
  }
}

// With a chip: 2-D tiles of the (rows, cols) sheet, WARPS x rpt rows by
// 32 x V columns; warp-rows walk the tile's rows, lanes its columns.
// Column tiles sit on grid x, row tiles on grid y (taken in turn past its
// limit).
template <bool NOISE, int VAR, bool BWD, int V>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM<BWD, V>)
transfer_kernel_tiles(const float* __restrict__ w,
                      const float* __restrict__ gr,
                      const float* __restrict__ ed,
                      const float* __restrict__ et, Fields f,
                      float* __restrict__ out, long long rows, int cols,
                      int rpt, float sd, float st, Chain ch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (blockIdx.x * 32 + lane) * V;
  if (c >= cols) return;
  const int nc = min(V, cols - c);      // V, or fewer at a ragged row end
  float fc[3][V];                       // per-column fields, read once
  if (VAR == VAR_COL) {
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int j = 0; j < V; ++j)
        fc[s][j] = j < nc ? f.p[s][(long long)(c + j) * f.s1[s]] : 0.f;
  }
  const int tile_rows = WARPS * rpt;
  for (long long t0 = (long long)blockIdx.y * tile_rows; t0 < rows;
       t0 += (long long)gridDim.y * tile_rows) {
    for (int k = 0; k < rpt; ++k) {
      const long long r = t0 + warp + WARPS * k;
      if (r >= rows) break;
      float fr[3] = {0.f, 0.f, 0.f};    // per-row fields, read once a row
      const float* fa[3] = {};          // any layout: the row's fields
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if (VAR == VAR_ROW) fr[s] = f.p[s][r * f.s0[s]];
        if (VAR == VAR_ANY) fa[s] = f.p[s] + r * f.s0[s];
      }
      segment<NOISE, true, BWD, V>(
          w, gr, ed, et, out, r * cols + c, nc,
          [&](int s, int j) {
            return VAR == VAR_ROW   ? fr[s]
                   : VAR == VAR_COL ? fc[s][j]
                   : j < nc         ? fa[s][(long long)(c + j) * f.s1[s]]
                                    : 0.f;
          },
          sd, st, ch);
    }
  }
}

// The operands of one launch (gr null in the forward).
struct Args {
  const float *w, *gr, *ed, *et;
  Fields f;
  float* out;
  long long rows;
  int cols, per;
  float sd, st;
  Chain c;
};

template <bool NOISE, int VAR, bool BWD, int V>
void launch_one(dim3 grid, cudaStream_t s, const Args& a) {
  if constexpr (VAR == VAR_NONE)
    transfer_kernel_flat<NOISE, BWD, V><<<grid, THREADS, 0, s>>>(
        a.w, a.gr, a.ed, a.et, a.out, a.rows * a.cols, a.per, a.sd, a.st,
        a.c);
  else
    transfer_kernel_tiles<NOISE, VAR, BWD, V><<<grid, THREADS, 0, s>>>(
        a.w, a.gr, a.ed, a.et, a.f, a.out, a.rows, a.cols, a.per, a.sd,
        a.st, a.c);
}

template <bool NOISE, int VAR, bool BWD>
void launch_width(int vec, dim3 grid, cudaStream_t s, const Args& a) {
  if (vec)
    launch_one<NOISE, VAR, BWD, 4>(grid, s, a);
  else
    launch_one<NOISE, VAR, BWD, 1>(grid, s, a);
}

template <bool NOISE, bool BWD>
void launch_var(int var_mode, int vec, dim3 grid, cudaStream_t s,
                const Args& a) {
  switch (var_mode) {
    case VAR_ROW:
      return launch_width<NOISE, VAR_ROW, BWD>(vec, grid, s, a);
    case VAR_COL:
      return launch_width<NOISE, VAR_COL, BWD>(vec, grid, s, a);
    case VAR_ANY:
      return launch_width<NOISE, VAR_ANY, BWD>(vec, grid, s, a);
    default:
      return launch_width<NOISE, VAR_NONE, BWD>(vec, grid, s, a);
  }
}

template <bool BWD>
int launch_checked(const float* gr, const float* w, const float* eps_dac,
                   const float* eps_th, const Fields* fields, int var_mode,
                   float* out, long long rows, int cols, float sigma_dac,
                   float sigma_th, const float* chain, int vec, int grid_x,
                   int grid_y, int per, void* stream) {
  if ((eps_dac == nullptr) != (eps_th == nullptr) || rows < 0 || cols < 1 ||
      var_mode < 0 || var_mode > 3 || (var_mode != 0) != (fields != nullptr) ||
      grid_x < 1 || grid_y < 1 || grid_y > 65535 || per < 1 ||
      (BWD && gr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  Args a{w, gr, eps_dac, eps_th, fields ? *fields : Fields{}, out, rows,
         cols, per, sigma_dac, sigma_th, {}};
  float* dst = reinterpret_cast<float*>(&a.c);
  for (int i = 0; i < (int)(sizeof(Chain) / sizeof(float)); ++i)
    dst[i] = chain[i];
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t s = (cudaStream_t)stream;
  if (eps_dac != nullptr)
    launch_var<true, BWD>(var_mode, vec, grid, s, a);
  else
    launch_var<false, BWD>(var_mode, vec, grid, s, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// eps_dac / eps_th: both device pointers or both null (no per-shot noise).
// fields: the chip's three fields in layout var_mode (0 none, 1 per row,
// 2 per column, 3 any broadcast), or null with var_mode 0.
// chain: the 19 float32 constants of struct Chain, in order (host memory).
// The sheet is (rows, cols); vec: 16-byte accesses (every stream 16-byte
// aligned, and, with a chip, cols % 4 == 0 or rows == 1).  grid_x, grid_y
// and per (segments a thread without a chip, rows a thread per tile with
// one) as repro_torch.kernels.mrr_transfer.ops.plan computes them.
int mrr_transfer_launch(const float* w, const float* eps_dac,
                        const float* eps_th, const Fields* fields,
                        int var_mode, float* out, long long rows, int cols,
                        float sigma_dac, float sigma_th, const float* chain,
                        int vec, int grid_x, int grid_y, int per,
                        void* stream) {
  return launch_checked<false>(nullptr, w, eps_dac, eps_th, fields, var_mode,
                               out, rows, cols, sigma_dac, sigma_th, chain,
                               vec, grid_x, grid_y, per, stream);
}

// The backward: dq = g * d realize(w) / d w into `dq`, g a float stream
// of w's n elements; every other argument as mrr_transfer_launch's (the
// same plan).
int mrr_transfer_backward_launch(const float* g, const float* w,
                                 const float* eps_dac, const float* eps_th,
                                 const Fields* fields, int var_mode,
                                 float* dq, long long rows, int cols,
                                 float sigma_dac, float sigma_th,
                                 const float* chain, int vec, int grid_x,
                                 int grid_y, int per, void* stream) {
  return launch_checked<true>(g, w, eps_dac, eps_th, fields, var_mode, dq,
                              rows, cols, sigma_dac, sigma_th, chain, vec,
                              grid_x, grid_y, per, stream);
}

}  // extern "C"
