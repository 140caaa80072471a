// Fused ROSA analog matmul for Hopper (sm_90a).
//
// Replaces the TPU megakernel src/repro/kernels/rosa_fused/rosa_fused.py
// (rosa_fused_pallas; body _kernel, realization chain _realize).  It does
// what the composed pipeline does in four passes over device memory:
//
//   weight codes wn = clip(rint(w / sw * qmax)) / qmax
//     -> optional MRR realization of wn (inverse chain to a programming
//        voltage, then the forward chain with three additive offsets:
//        v_off = DAC noise + dv, t_off = thermal noise + ddt, l_off = dlam)
//     -> gate / mgate blends
//   activations: digital x_dig at the digital full-scale sxd, optional
//     realization at the per-row analog full-scale sxa, blends
//     -> MIXED: requantize by s2, radix-2^pam digits recombined with the
//        slot gains; ANALOG: x_eff / s2
//   -> f32 accumulation -> flush scale s2 * sw (/ qmax in MIXED)
//
// gg = [gate, mgate, sw] and the (M, 3) scale columns sx = [sxd, sxa, s2]
// are device tensors read here, so a gate sweep neither re-specializes nor
// syncs the host.  Each side's three offset streams come as pointer plus
// (row, column) strides: a per-lane StaticVariation is a stride-0 view and
// is never materialized.
//
// What bounds it on the H100, and what each path does about it:
//
// * Decode (M <= 16: the serving shapes, M = 4..8 rows against a
//   5120 x 51200 or 25600 x 5120 weight).  The kernel must read K*N*4
//   bytes of weight once: bound by HBM bandwidth (3.35 TB/s), unless the
//   weight is realized (WS), where the chain's ~46 float operations, two
//   IEEE divisions and two square roots per weight element bound it.  A
//   prologue kernel conditions the activations once for the whole call
//   (realization, requantization, digit recombination) into a small
//   [K][M rounded up to 4] workspace; the weight streams through
//   skinny_stream.cuh (a 6-stage cp.async ring of 32 x 128 tiles, the
//   kernel templated on M, split-K with a fixed-order reduce), and each
//   thread conditions its staged float4 of weights in registers, one
//   index computation per vector, before the multiply-adds.  Tensor cores
//   do not help (2*M flops per 4 weight bytes; TF32 would break parity).
// * Tall (M > 16: the paper CNNs' im2col sheets, up to 524,288 rows with
//   K 16..96 and N 10..96 in the Table 4 evaluations).  Bound by the bytes
//   of x and its offset streams.  A prologue conditions the (small)
//   weight once into a K x N workspace; a block owns 128 rows and an
//   N tile that follows N (16, 32, 64 or 128 columns), conditions each of
//   its activations once into shared memory per 32-deep K step, and each
//   thread accumulates an 8 x N/16 strip.  Row tiles go on gridDim.x, so
//   any M launches.
//
// Numerics: the file is built with --fmad=false, so the chain runs op by
// op with IEEE division and sqrt, in the order of the plain version
// (repro_torch.core.mrr's folded chain, fed fake_quant's straight-through
// residue t + (t_q - t)): a noise-free realization equals the plain
// version's bit for bit.  rintf rounds half to even like jnp.round and
// torch.round.  Only the contraction's summation order differs from the
// plain version's.  Ragged edges are masked: lanes k >= K contribute
// nothing on either side (the chain maps a zero target to a nonzero
// weight, so they must not be realized and summed).

#include <cstdint>

#include <cuda_runtime.h>

#include "skinny_stream.cuh"

namespace {

constexpr int MAX_PLANES = 8;

enum Flags {
  ANALOG = 1, REALIZE_X = 2, REALIZE_W = 4, USE_GATE = 8, USE_MGATE = 16
};

// Float32 constants of the realization chain in its folded form, in the
// field order of repro_torch.core.mrr.Chain (see there for what each is).
struct Chain {
  float q_min, q_max, a_td, b_td, gamma, c_dl, d_u, d_neff, beta, e_v2, v_min,
      v_max, f_dt, g_lam, n_eff, h_det, g2, i_td, j_w;
};

struct Offsets {           // three streams of one side, element (i, j)
  const float* p[3];
  long long s0[3], s1[3];
  __device__ __forceinline__ float at(int s, long long i, long long j) const {
    return __ldg(p[s] + i * s0[s] + j * s1[s]);
  }
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// normalized target -> programming voltage -> forward chain with the three
// offsets, op for op as repro_torch.core.mrr.realize_offsets
__device__ float realize(float wn, float v_off, float t_off, float l_off,
                         const Chain& c) {
  float wq = clampf(wn, c.q_min, c.q_max);
  float tdrop = ((wq - c.q_min) * c.a_td + c.b_td) * 0.5f;
  float det = sqrtf(fmaxf(1.0f / tdrop - 1.0f, 0.0f)) * c.gamma;
  float dl = det + c.c_dl;
  float dt = (dl * c.d_neff) / ((1.0f - dl * c.d_u) * c.beta);
  float v2 = fmaxf(dt, 0.0f) * c.e_v2;
  float v = clampf(sqrtf(fmaxf(v2, 0.0f)), c.v_min, c.v_max) + v_off;
  float dtn = (v * v) * c.f_dt + t_off;
  float shift = (dtn * c.g_lam) / (dtn * c.beta + c.n_eff) + l_off;
  float d2 = shift + c.h_det;          // detuning from the probe wavelength
  float t = c.g2 / (d2 * d2 + c.g2);
  return (2.0f * t + c.i_td) * c.j_w + c.q_min;
}

// Everything both sides' conditioning reads.
struct Operands {
  const float* x;
  const float* sx;
  const float* gains;
  const float* gg;
  Offsets xo, wo;
  Chain chain;
  int ldx, ld_sx, n_planes, radix_bits, flags;
  float qf;
};

// The slot gains, in registers (zero past n_planes).
__device__ __forceinline__ void load_gains(const Operands& o,
                                           float (&g)[MAX_PLANES]) {
#pragma unroll
  for (int t = 0; t < MAX_PLANES; ++t)
    g[t] = t < o.n_planes ? __ldg(o.gains + t) : 0.f;
}

// What conditioning the activation (gm, gk) reads from its streams: the
// value and, when the activations are realized, its three offsets.  The
// row's three scales (cached: a row shares them) are read with the
// arithmetic.
struct XIn {
  float xv, v_off, t_off, l_off;
};

__device__ __forceinline__ XIn load_x(const Operands& o, int gm, int gk) {
  XIn in;
  in.xv = __ldg(o.x + (long long)gm * o.ldx + gk);
  in.v_off = in.t_off = in.l_off = 0.f;
  if (o.flags & REALIZE_X) {
    in.v_off = o.xo.at(0, gm, gk);
    in.t_off = o.xo.at(1, gm, gk);
    in.l_off = o.xo.at(2, gm, gk);
  }
  return in;
}

// The activation as the contraction consumes it: the requantized code's
// digits recombined with the slot gains (MIXED) or x_eff / s2 (ANALOG).
// inv_q = 1.0f / qmax, computed once by the caller.
__device__ float condition_x(const Operands& o, const float (&g)[MAX_PLANES],
                             float gate, float mgate, float inv_q, int gm,
                             const XIn& in) {
  const bool analog = o.flags & ANALOG, realize_x = o.flags & REALIZE_X,
             use_gate = o.flags & USE_GATE, use_mgate = o.flags & USE_MGATE;
  const float qf = o.qf;
  const int dmask = (1 << o.radix_bits) - 1;
  const float xv = in.xv;
  const float sxd = __ldg(o.sx + (long long)gm * o.ld_sx + 0);
  const float sxa = __ldg(o.sx + (long long)gm * o.ld_sx + 1);
  const float s2 = __ldg(o.sx + (long long)gm * o.ld_sx + 2);
  // straight-through residue t + (t_q - t), as fake_quant leaves it
  float xd = clampf(rintf(xv / sxd * qf), -qf, qf) * (sxd / qf);
  float x_dig = xv + (xd - xv);
  float x_is = x_dig;
  if (realize_x) {
    float xa = xv / sxa;
    float xq = clampf(rintf(xa * qf), -qf, qf) * inv_q;
    float x_an = realize(xa + (xq - xa), in.v_off, in.t_off, in.l_off,
                         o.chain) * sxa;
    x_is = use_gate ? x_dig + gate * (x_an - x_dig) : x_an;
  }
  float x_eff = use_mgate ? (1.0f - mgate) * x_dig + mgate * x_is : x_is;
  if (analog) return x_eff * (1.0f / s2);
  float q2 = clampf(rintf(x_eff / s2 * qf), -qf, qf);
  float sgn = (q2 > 0.f) ? 1.f : ((q2 < 0.f) ? -1.f : 0.f);
  int mag = (int)fabsf(q2);
  float rec = 0.f;
#pragma unroll
  for (int t = 0; t < MAX_PLANES; ++t)
    if (t < o.n_planes)
      rec = rec + g[t] * (sgn * (float)((mag >> (o.radix_bits * t)) & dmask));
  return rec;
}

// The weight's 8-bit code in normalized units.
__device__ __forceinline__ float code_w(float wa, float qf, float inv_q) {
  return clampf(rintf(wa * qf), -qf, qf) * inv_q;
}

// The weight (gk, gn) in normalized units: codes, realization, blends.
__device__ __forceinline__ float condition_w(const Operands& o, float wv,
                                             float sw, float inv_q,
                                             float gate, float mgate, int gk,
                                             int gn) {
  const bool realize_w = o.flags & REALIZE_W, use_gate = o.flags & USE_GATE,
             use_mgate = o.flags & USE_MGATE;
  float wa = wv / sw;
  float wn = code_w(wa, o.qf, inv_q);
  float w_ws = wn;
  if (realize_w) {
    float w_an = realize(wa + (wn - wa), o.wo.at(0, gk, gn),
                         o.wo.at(1, gk, gn), o.wo.at(2, gk, gn), o.chain);
    w_ws = use_gate ? wn + gate * (w_an - wn) : w_an;
  }
  return use_mgate ? (1.0f - mgate) * w_ws + mgate * wn : w_ws;
}

__device__ __forceinline__ float flush_scale(const Operands& o, float sw,
                                             int gm) {
  const float s2 = __ldg(o.sx + (long long)gm * o.ld_sx + 2);
  return (o.flags & ANALOG) ? s2 * sw : s2 * (sw / o.qf);
}

// skinny_stream.cuh's weight operation: condition a staged float4 in
// registers, scale a finished sum.  A float4 of codes alone (no
// realization, no mgate blend, inside N) takes a branch-free path.
struct WeightOp {
  Operands o;
  float gate, mgate, sw, inv_q;
  __device__ __forceinline__ void init() {
    gate = __ldg(o.gg + 0);
    mgate = __ldg(o.gg + 1);
    sw = __ldg(o.gg + 2);
    inv_q = 1.0f / o.qf;
  }
  __device__ __forceinline__ void condition(float (&v)[4], int gk, int gn,
                                            int n) const {
    if (!(o.flags & (REALIZE_W | USE_MGATE)) && gn + 3 < n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = code_w(v[e] / sw, o.qf, inv_q);
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (gn + e < n)
        v[e] = condition_w(o, v[e], sw, inv_q, gate, mgate, gk, gn + e);
  }
  __device__ __forceinline__ float flush(float s, int gm) const {
    return s * flush_scale(o, sw, gm);
  }
};

// Decode prologue: xr[k][r] = the conditioned activation (r, k), rows
// r >= m zero.
__global__ void x_operand(Operands o, float* __restrict__ xr, int m, int k,
                          int mp) {
  const float gate = __ldg(o.gg + 0), mgate = __ldg(o.gg + 1);
  const float inv_q = 1.0f / o.qf;
  float g[MAX_PLANES];
  load_gains(o, g);
  const long long total = (long long)k * mp;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int kk = (int)(i / mp), r = (int)(i % mp);
    xr[i] = r < m ? condition_x(o, g, gate, mgate, inv_q, r, load_x(o, r, kk))
                  : 0.f;
  }
}

// Tall prologue: weff[k][n] = the conditioned weight (k, n).
__global__ void w_operand(Operands o, const float* __restrict__ w,
                          float* __restrict__ weff, int k, int n, int ldw) {
  const float gate = __ldg(o.gg + 0), mgate = __ldg(o.gg + 1),
              sw = __ldg(o.gg + 2);
  const float inv_q = 1.0f / o.qf;
  const long long total = (long long)k * n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int gk = (int)(i / n), gn = (int)(i % n);
    weff[i] = condition_w(o, __ldg(w + (long long)gk * ldw + gn), sw, inv_q,
                          gate, mgate, gk, gn);
  }
}

constexpr int TALL_BM = 128;      // rows per block
constexpr int TALL_BK = 32;       // lanes per step
constexpr int TALL_THREADS = 256; // 16 column groups x 16 row groups
constexpr int TALL_TM = 8;        // rows per thread
constexpr int TALL_BATCH = 4;     // activations conditioned per batch

// Tall path: a block owns TALL_BM rows x BNT columns (BNT in 16..128, the
// N tile following N), every activation conditioned once per N tile.
template <int BNT>
__global__ void __launch_bounds__(TALL_THREADS)
fused_kernel_tall(Operands o, const float* __restrict__ weff,
                  float* __restrict__ out, int m, int k, int n, int ldo) {
  constexpr int TN = BNT / 16;
  __shared__ float xs[TALL_BM][TALL_BK + 1];
  __shared__ __align__(16) float ws[TALL_BK][BNT];
  const int tid = threadIdx.x, cg = tid % 16, rg = tid / 16;
  const int m0 = blockIdx.x * TALL_BM, n0 = blockIdx.y * BNT;
  const float gate = __ldg(o.gg + 0), mgate = __ldg(o.gg + 1),
              sw = __ldg(o.gg + 2);
  const float inv_q = 1.0f / o.qf;
  const float sw_q = (o.flags & ANALOG) ? sw : sw / o.qf;   // flush factor
  float g[MAX_PLANES];
  load_gains(o, g);
  float acc[TALL_TM][TN];
#pragma unroll
  for (int j = 0; j < TALL_TM; ++j)
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[j][t] = 0.f;

  for (int kt = 0; kt < k; kt += TALL_BK) {
    const int kc = min(TALL_BK, k - kt);
    const int total = TALL_BM * kc;
    __syncthreads();
    // activations: consecutive threads take consecutive (row, lane)
    // elements of the block's rows, so a contiguous x is read coalesced
    for (int base = 0; base < total; base += TALL_THREADS * TALL_BATCH) {
#pragma unroll
      for (int j = 0; j < TALL_BATCH; ++j) {
        const int i = base + j * TALL_THREADS + tid;
        if (i < total) {
          const int r = i / kc, c = i - r * kc;
          const int gm = m0 + r;
          xs[r][c] = gm < m ? condition_x(o, g, gate, mgate, inv_q, gm,
                                          load_x(o, gm, kt + c))
                            : 0.f;
        }
      }
    }
    for (int i = tid; i < kc * BNT; i += TALL_THREADS) {
      const int c = i / BNT, col = i % BNT, gn = n0 + col;
      ws[c][col] = gn < n ? __ldg(weff + (long long)(kt + c) * n + gn) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float xv[TALL_TM], wv[TN];
#pragma unroll
      for (int j = 0; j < TALL_TM; ++j) xv[j] = xs[rg * TALL_TM + j][kk];
      if constexpr (TN % 4 == 0) {
#pragma unroll
        for (int t = 0; t < TN; t += 4) {
          float4 w4 = *reinterpret_cast<const float4*>(&ws[kk][cg * TN + t]);
          wv[t] = w4.x; wv[t + 1] = w4.y; wv[t + 2] = w4.z; wv[t + 3] = w4.w;
        }
      } else {
#pragma unroll
        for (int t = 0; t < TN; ++t) wv[t] = ws[kk][cg * TN + t];
      }
#pragma unroll
      for (int j = 0; j < TALL_TM; ++j)
#pragma unroll
        for (int t = 0; t < TN; ++t) acc[j][t] = fmaf(xv[j], wv[t], acc[j][t]);
    }
  }

#pragma unroll
  for (int j = 0; j < TALL_TM; ++j) {
    const int gm = m0 + rg * TALL_TM + j;
    if (gm >= m) continue;
    const float scale = __ldg(o.sx + (long long)gm * o.ld_sx + 2) * sw_q;
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int gn = n0 + cg * TN + t;
      if (gn < n) out[(long long)gm * ldo + gn] = acc[j][t] * scale;
    }
  }
}

__global__ void flush_splits(const float* __restrict__ part,
                             const float* __restrict__ sx,
                             const float* __restrict__ gg,
                             float* __restrict__ out, int m, int n, int ldo,
                             int ld_sx, int splits, float qf, int analog) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)m * n) return;
  int r = (int)(i / n), c = (int)(i % n);
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s = s + part[((long long)z * m + r) * n + c];
  float s2 = sx[(long long)r * ld_sx + 2], sw = gg[2];
  out[(long long)r * ldo + c] = s * (analog ? s2 * sw : s2 * (sw / qf));
}

Offsets make_offsets(const float* const* p, const long long* strides) {
  Offsets o;
  for (int s = 0; s < 3; ++s) {
    o.p[s] = p ? p[s] : nullptr;
    o.s0[s] = p ? strides[2 * s] : 0;
    o.s1[s] = p ? strides[2 * s + 1] : 0;
  }
  return o;
}

int grid_stride_blocks(long long total) {
  long long b = (total + 255) / 256;
  return (int)(b < 4096 ? (b < 1 ? 1 : b) : 4096);
}

}  // namespace

extern "C" {

// x_off / w_off: three device pointers each (or null when that side does
// not realize); *_strides: (row, column) element strides per stream.
// chain: the 19 float32 constants of struct Chain, in order (host memory).
// The caller plans the launch (repro_torch.kernels.rosa_fused.ops.plan):
// m <= 16 takes the decode path with splits / k_per_split, the operand
// workspace holding k * pad4(m) floats and part splits * m * n floats
// when splits > 1; m > 16 takes the tall path with N tile n_tile (16, 32,
// 64 or 128) and an operand workspace of k * n floats.
int rosa_fused_launch(const float* x, const float* w, const float* gains,
                      const float* sx, const float* gg,
                      const float* const* x_off, const long long* x_strides,
                      const float* const* w_off, const long long* w_strides,
                      float* out, float* operand, float* part, int m, int k,
                      int n, int ldx, int ldw, int ldo, int ld_sx,
                      int n_planes, int radix_bits, float qmax, int flags,
                      const float* chain, int splits, int k_per_split,
                      int n_tile, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || m < 1 || operand == nullptr)
    return (int)cudaErrorInvalidValue;
  if (((flags & REALIZE_X) != 0) != (x_off != nullptr) ||
      ((flags & REALIZE_W) != 0) != (w_off != nullptr))
    return (int)cudaErrorInvalidValue;
  Operands o;
  float* dst = reinterpret_cast<float*>(&o.chain);
  for (int i = 0; i < (int)(sizeof(Chain) / sizeof(float)); ++i) dst[i] = chain[i];
  o.x = x; o.sx = sx; o.gains = gains; o.gg = gg;
  o.xo = make_offsets(x_off, x_strides);
  o.wo = make_offsets(w_off, w_strides);
  o.ldx = ldx; o.ld_sx = ld_sx; o.n_planes = n_planes;
  o.radix_bits = radix_bits; o.flags = flags; o.qf = qmax;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;

  if (m > skinny::MAX_M) {
    const long long kn = (long long)k * n;
    w_operand<<<grid_stride_blocks(kn), 256, 0, st>>>(o, w, operand, k, n,
                                                      ldw);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dim3 grid((m + TALL_BM - 1) / TALL_BM, (n + n_tile - 1) / n_tile);
    switch (n_tile) {
      case 16: fused_kernel_tall<16><<<grid, TALL_THREADS, 0, st>>>(o, operand, out, m, k, n, ldo); break;
      case 32: fused_kernel_tall<32><<<grid, TALL_THREADS, 0, st>>>(o, operand, out, m, k, n, ldo); break;
      case 64: fused_kernel_tall<64><<<grid, TALL_THREADS, 0, st>>>(o, operand, out, m, k, n, ldo); break;
      case 128: fused_kernel_tall<128><<<grid, TALL_THREADS, 0, st>>>(o, operand, out, m, k, n, ldo); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }

  if (splits < 1 || k_per_split < 1 ||
      (long long)k_per_split * splits < k || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int mp = skinny::pad4(m);
  x_operand<<<grid_stride_blocks((long long)k * mp), 256, 0, st>>>(
      o, operand, m, k, mp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int vec = ((uintptr_t)w % 16 == 0) && (ldw % 4 == 0);
  WeightOp op;
  op.o = o;
  err = skinny::launch<false>(m, w, operand, gains, splits > 1 ? part : out,
                              k, n, ldw, ldo, n_planes, k_per_split, splits,
                              vec, op, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  long long total = (long long)m * n;
  flush_splits<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, sx, gg, out, m, n, ldo, ld_sx, splits, qmax,
      (flags & ANALOG) != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
