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
// * Tall (M > 16): the optical train step's 2048 rows against qwen3-32b's
//   MLPs (K x N 5120 x 51200, 25600 x 5120, a model rank's half of each),
//   gemma3-12b's 64-row prefill chunk (3840 x 30720, 15360 x 3840), the
//   drift probes' 64 rows, and the paper CNNs' im2col sheets (up to
//   524,288 rows, K 16..216, N 10..96).  At the LM shapes the product
//   dominates (2 M K N operations against K N weight bytes: 2048 rows put
//   it far above the ridge of every unit), so the contraction runs on the
//   tensor cores with mma.sync, on one of three routes that operands()
//   fixes per call from what it knows on the host (no device value read):
//     - codes: MIXED mode, ideal OSA gains, qmax <= 127, an unrealized
//       and unblended weight.  Both sides are 8-bit integer codes (x_rec
//       is the requantized code, the weight's code is wn * qmax), so the
//       product is m16n8k32 s8 x s8 with int32 accumulators, exact where
//       the plain version's float32 sums round above 2^24; the flush
//       multiplies by 1/qmax, then s2 * (sw / qmax) as the plain version
//       does.  K qmax^2 < 2^31 keeps the int32 sums from overflowing;
//     - tf32x2: the activation is an integer code (|x_rec| < 2048, exact
//       in TF32) and the weight an arbitrary float32 (realized, blended):
//       m16n8k8 TF32 products x w_lo + x w_hi with w_hi = tf32(w), w_lo =
//       tf32(w - w_hi), each product to 2^-22 relative;
//     - tf32x3: both sides float (ANALOG, non-ideal gains): x_lo w_hi +
//       x_hi w_lo + x_hi w_hi, ssd_scan.cu's 3xTF32 split.
//   The tensor cores add inside an mma with truncation, so on the TF32
//   routes a 32-lane stage's products go to accumulators of their own,
//   which are then added to the float32 sums with rounding: the error
//   stays that of a float32 sum over K / 32 stages, not one that grows
//   with K (a build that accumulated all of K in the mma was 34x farther
//   from the plain version at 2048 x 12800 x 5120: 3.6e-2 against 1.1e-3
//   max abs, chip_smoke.py phase 2 on an H100).
//   Each operand is conditioned once per call: a prologue writes the
//   weight's operand transposed to N x K (K contiguous: mma's col-major B,
//   4 codes a 32-bit fragment word), another the activations' M x K; rows
//   and lanes padded to whole tiles with zeros, so the main kernel copies
//   16-byte chunks unmasked through a 4-stage cp.async ring (rows padded
//   by 16 bytes: fragment loads are free of bank conflicts).  A block
//   owns 128 rows (64 when M <= 64: the chunk and probes take no
//   half-empty tile) by 128 columns, 8 warps of (BM / 2) x 32; where the
//   row and column tiles leave SMs idle (the 64-row chunk at N 3840), K is
//   split across blocks (grid z) and the partial tiles summed in split
//   order by a second kernel: int32 sums are exact in any order, float
//   ones are fixed, so two launches give equal bits on every route.
//   The CNN sheets have one column tile and K of a few stages; there the
//   bound is the bytes of x and its offset streams and their
//   conditioning, so the activations are conditioned in the tile (2-stage
//   ring; consecutive threads take consecutive (row, lane) elements, a
//   contiguous x is read coalesced) and only the small weight goes
//   through a workspace; the N tile follows N (32, 64 or 128 columns).
// Numerics: the file is built with --fmad=false, so the chain runs op by
// op with IEEE division and sqrt, in the order of the plain version
// (repro_torch.core.mrr's folded chain, fed fake_quant's straight-through
// residue t + (t_q - t)): a noise-free realization equals the plain
// version's bit for bit, and so do the 8-bit codes on every route.  rintf
// rounds half to even like jnp.round and torch.round.  The contraction
// differs from the plain version's float32 product only in its sums: on
// the decode path their order, on the tall path exact integer sums
// (codes) or split-TF32 products (each to 2^-22) summed in float32.
// Ragged edges are masked: lanes k >= K contribute nothing on either side
// (the chain maps a zero target to a nonzero weight, so they must not be
// realized and summed).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "skinny_stream.cuh"

namespace {

constexpr int MAX_PLANES = 8;

enum Flags {
  ANALOG = 1, REALIZE_X = 2, REALIZE_W = 4, USE_GATE = 8, USE_MGATE = 16
};

// The tall path's routes (ops.ROUTES; see the note above).
enum Route { CODES = 0, TF32X2 = 1, TF32X3 = 2 };

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
  int code_mask;   // the magnitude bits the slots carry
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

// The activation (gm, gk) before the requantization: the digital code's
// straight-through value, realized and blended as the flags say.  inv_q =
// 1.0f / qmax, computed once by the caller.
__device__ __forceinline__ float eff_x(const Operands& o, float gate,
                                       float mgate, float inv_q, int gm,
                                       const XIn& in) {
  const bool realize_x = o.flags & REALIZE_X, use_gate = o.flags & USE_GATE,
             use_mgate = o.flags & USE_MGATE;
  const float qf = o.qf;
  const float xv = in.xv;
  const float sxd = __ldg(o.sx + (long long)gm * o.ld_sx + 0);
  const float sxa = __ldg(o.sx + (long long)gm * o.ld_sx + 1);
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
  return use_mgate ? (1.0f - mgate) * x_dig + mgate * x_is : x_is;
}

__device__ __forceinline__ float row_s2(const Operands& o, int gm) {
  return __ldg(o.sx + (long long)gm * o.ld_sx + 2);
}

// The activation as the contraction consumes it: the requantized code's
// digits recombined with the slot gains (MIXED) or x_eff / s2 (ANALOG).
__device__ float condition_x(const Operands& o, const float (&g)[MAX_PLANES],
                             float gate, float mgate, float inv_q, int gm,
                             const XIn& in) {
  const float x_eff = eff_x(o, gate, mgate, inv_q, gm, in);
  const float s2 = row_s2(o, gm), qf = o.qf;
  if (o.flags & ANALOG) return x_eff * (1.0f / s2);
  const int dmask = (1 << o.radix_bits) - 1;
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

// The same under ideal gains 2^(radix_bits t), as the integer it is: the
// requantized code with the magnitude bits the n_planes slots carry.
__device__ __forceinline__ float code_x(const Operands& o, float gate,
                                        float mgate, float inv_q, int gm,
                                        const XIn& in) {
  const float x_eff = eff_x(o, gate, mgate, inv_q, gm, in);
  const float qf = o.qf;
  const float q2 = clampf(rintf(x_eff / row_s2(o, gm) * qf), -qf, qf);
  const int mag = (int)fabsf(q2) & o.code_mask;
  return q2 < 0.f ? -(float)mag : (float)mag;
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
  const float s2 = row_s2(o, gm);
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

// ---- the tall path (M > 16) ------------------------------------------------
constexpr int TALL_THREADS = 256;   // 8 warps
constexpr int TALL_PAD = 16;        // bytes after each staged row
constexpr int W_TILE = 64;          // the weight prologue's square tile

// What a route stages: its element, accumulator, lanes a stage (32 bytes
// of codes make one m16n8k32 step, 8 floats one m16n8k8) and bytes a
// staged row.
template <int R>
struct RouteOf {
  using T = std::conditional_t<R == CODES, int8_t, float>;
  using Acc = std::conditional_t<R == CODES, int, float>;
  static constexpr int BK = R == CODES ? 64 : 32;
  static constexpr int ROW = BK * (int)sizeof(T) + TALL_PAD;
};

// Ring depth: four stages of copies in flight, two where the activations
// are conditioned in the tile (their loads are synchronous).
template <bool XT>
__host__ __device__ constexpr int tall_stages() { return XT ? 2 : 4; }

struct TallArgs {
  void* xw;        // (mp, kp) activation operand; null: conditioned in tile
  void* wt;        // (np, kp) weight operand, K contiguous
  float* out;
  void* part;      // splits x m x n partial tiles (Acc) when splits > 1
  int m, k, n, kp, ldo, k_per_split, splits;
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// hi = tf32(a), lo = tf32(a - hi): a - hi is exact in float32
__device__ __forceinline__ void split_tf32(float a, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a b, m16n8k32, 8-bit integer operands, int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's MT x 4 tiles of m16n8 over one 32-deep step of codes.
template <int MT>
__device__ __forceinline__ void mma_s8_tile(int (&acc)[MT][4][4],
                                            const unsigned (&a)[MT][4],
                                            const unsigned (&b)[4][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
}

// The same over one 8-deep step of TF32 splits, small terms first:
// x_lo w_hi (SPLIT_A only), x_hi w_lo, x_hi w_hi.
template <int MT, bool SPLIT_A>
__device__ __forceinline__ void mma_tf32_tile(float (&acc)[MT][4][4],
                                              const unsigned (&ah)[MT][4],
                                              const unsigned (&al)[MT][4],
                                              const unsigned (&bh)[4][2],
                                              const unsigned (&bl)[4][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (SPLIT_A) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
      mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
      mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
    }
}

// The activation as a route consumes it: codes and tf32x2 run under
// ideal gains (ops.route_of), where x_rec is the code itself.
template <int R>
__device__ __forceinline__ float x_value(const Operands& o,
                                         const float (&g)[MAX_PLANES],
                                         float gate, float mgate, float inv_q,
                                         int gm, const XIn& in) {
  if constexpr (R == TF32X3)
    return condition_x(o, g, gate, mgate, inv_q, gm, in);
  else
    return code_x(o, gate, mgate, inv_q, gm, in);
}

__device__ __forceinline__ void store4(int8_t* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<unsigned*>(p) =
      (unsigned)(uint8_t)(int8_t)(int)a |
      (unsigned)(uint8_t)(int8_t)(int)b << 8 |
      (unsigned)(uint8_t)(int8_t)(int)c << 16 |
      (unsigned)(uint8_t)(int8_t)(int)d << 24;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Tall prologue: wt[n][k] = the weight (k, n) as the route takes it (its
// integer code, or conditioned in normalized units), through a 64 x 64
// tile in shared memory so that the read (along N, four columns and four
// rows a thread, all loads issued first) and the write (along K, 16-byte
// stores) are both coalesced; zero past K and N, nothing past kp and np.
template <int R>
__global__ void __launch_bounds__(256)
tall_w_operand(Operands o, const float* __restrict__ w, void* wt_, int k,
               int n, int ldw, int kp, int np) {
  using T = typename RouteOf<R>::T;
  constexpr int EPC = 16 / (int)sizeof(T);       // elements a 16-byte store
  __shared__ float tile[W_TILE][W_TILE + 1];
  const float gate = __ldg(o.gg + 0), mgate = __ldg(o.gg + 1),
              sw = __ldg(o.gg + 2);
  const float inv_q = 1.0f / o.qf;
  const int tid = threadIdx.x, n4 = 4 * (tid % 16), kr = tid / 16;
  const long long tk = (kp + W_TILE - 1) / W_TILE;
  const long long tiles = tk * ((np + W_TILE - 1) / W_TILE);
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int k0 = (int)(tl % tk) * W_TILE, n0 = (int)(tl / tk) * W_TILE;
    float v[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + kr + 16 * j, gn = n0 + n4 + e;
        v[j][e] = gk < k && gn < n ? __ldg(w + (long long)gk * ldw + gn)
                                   : 0.f;
      }
    __syncthreads();             // the previous tile is written out
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + kr + 16 * j, gn = n0 + n4 + e;
        float c = 0.f;
        if (gk < k && gn < n) {
          if constexpr (R == CODES)
            c = clampf(rintf(v[j][e] / sw * o.qf), -o.qf, o.qf);
          else
            c = condition_w(o, v[j][e], sw, inv_q, gate, mgate, gk, gn);
        }
        tile[n4 + e][kr + 16 * j] = c;
      }
    __syncthreads();
    for (int i = tid; i < W_TILE * (W_TILE / EPC); i += 256) {
      const int nn = i / (W_TILE / EPC), q = EPC * (i % (W_TILE / EPC));
      if (n0 + nn >= np || k0 + q >= kp) continue;
      T* dst = static_cast<T*>(wt_) + (long long)(n0 + nn) * kp + k0 + q;
      const float* src = &tile[nn][q];
      if constexpr (R == CODES) {
        unsigned u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store4(reinterpret_cast<int8_t*>(&u[e]), src[4 * e],
                 src[4 * e + 1], src[4 * e + 2], src[4 * e + 3]);
        *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
      } else {
        store4(dst, src[0], src[1], src[2], src[3]);
      }
    }
  }
}

// Tall prologue: xw[r][k] = the activation (r, k) as the route takes it,
// four lanes a thread; zero past M and K.
template <int R>
__global__ void tall_x_operand(Operands o, void* xw_, int m, int k, int kp,
                               int mp) {
  using T = typename RouteOf<R>::T;
  const float gate = __ldg(o.gg + 0), mgate = __ldg(o.gg + 1);
  const float inv_q = 1.0f / o.qf;
  float g[MAX_PLANES];
  load_gains(o, g);
  const int q4 = kp / 4;
  const long long total = (long long)mp * q4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / q4), c = 4 * (int)(i % q4);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = r < m && c + e < k
                 ? x_value<R>(o, g, gate, mgate, inv_q, r,
                              load_x(o, r, c + e))
                 : 0.f;
    store4(static_cast<T*>(xw_) + (long long)r * kp + c, v[0], v[1], v[2],
           v[3]);
  }
}

// Stage the lanes [kt, kt + BK) of the block's BN weight rows (cp.async)
// and BM activation rows (cp.async from the workspace, or conditioned
// here: consecutive threads take consecutive (row, lane) elements, so a
// contiguous x is read coalesced; lanes past K are zero).
template <int R, int BM, int BN, bool XT>
__device__ __forceinline__ void tall_stage(unsigned char* slot,
                                           const Operands& o,
                                           const TallArgs& a,
                                           const float (&g)[MAX_PLANES],
                                           float gate, float mgate,
                                           float inv_q, int m0, int n0,
                                           int kt) {
  using T = typename RouteOf<R>::T;
  constexpr int BK = RouteOf<R>::BK, ROW = RouteOf<R>::ROW;
  constexpr int CH = BK * (int)sizeof(T) / 16, EPC = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  const T* wt = static_cast<const T*>(a.wt) + kt;
  for (int v = tid; v < BN * CH; v += TALL_THREADS) {
    const int r = v / CH, c = v % CH;
    cp16(slot + (BM + r) * ROW + 16 * c,
         wt + (long long)(n0 + r) * a.kp + c * EPC);
  }
  if constexpr (!XT) {
    const T* xw = static_cast<const T*>(a.xw) + kt;
    for (int v = tid; v < BM * CH; v += TALL_THREADS) {
      const int r = v / CH, c = v % CH;
      cp16(slot + r * ROW + 16 * c,
           xw + (long long)(m0 + r) * a.kp + c * EPC);
    }
  } else {
    constexpr int LD = ROW / (int)sizeof(T), BATCH = 4;
    T* xs = reinterpret_cast<T*>(slot);
    const int kc = min(BK, a.k - kt), total = BM * kc;
    for (int base = tid; base < total; base += TALL_THREADS * BATCH) {
      XIn in[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = base + j * TALL_THREADS, r = i / kc;
        in[j] = i < total && m0 + r < a.m
                    ? load_x(o, m0 + r, kt + i - r * kc)
                    : XIn{0.f, 0.f, 0.f, 0.f};
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = base + j * TALL_THREADS, r = i / kc;
        if (i < total)
          xs[r * LD + i - r * kc] =
              (T)(m0 + r < a.m ? x_value<R>(o, g, gate, mgate, inv_q, m0 + r,
                                            in[j])
                               : 0.f);
      }
    }
    for (int i = tid; i < BM * (BK - kc); i += TALL_THREADS) {
      const int r = i / (BK - kc);
      xs[r * LD + kc + i % (BK - kc)] = (T)0;
    }
  }
}

// The warp's (16 MT) x 32 tile of the product over one staged slot: rows
// r0 + 16 i + g (+ 8), columns c0 + 8 j + g of B; g = lane / 4, t = lane
// % 4 (the PTX fragment layouts of m16n8k32 s8 and m16n8k8 tf32).
template <int R, int BM, int MT>
__device__ __forceinline__ void tall_mma(
    const unsigned char* slot, typename RouteOf<R>::Acc (&acc)[MT][4][4],
    int r0, int c0, int g, int t) {
  constexpr int BK = RouteOf<R>::BK, RW = RouteOf<R>::ROW / 4;
  if constexpr (R == CODES) {
    const unsigned* as = reinterpret_cast<const unsigned*>(slot);
    const unsigned* bs = as + BM * RW;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned af[MT][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned* p = as + (r0 + 16 * i + g) * RW + 8 * ks + t;
        af[i][0] = p[0];
        af[i][1] = p[8 * RW];
        af[i][2] = p[4];
        af[i][3] = p[8 * RW + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned* p = bs + (c0 + 8 * j + g) * RW + 8 * ks + t;
        bf[j][0] = p[0];
        bf[j][1] = p[4];
      }
      mma_s8_tile<MT>(acc, af, bf);
    }
  } else {
    const float* as = reinterpret_cast<const float*>(slot);
    const float* bs = as + BM * RW;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      unsigned ah[MT][4], al[MT][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = as + (r0 + 16 * i + g) * RW + 8 * ks + t;
        const float v[4] = {p[0], p[8 * RW], p[4], p[8 * RW + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (R == TF32X3) {
            split_tf32(v[e], ah[i][e], al[i][e]);
          } else {               // an integer code: exact in TF32
            ah[i][e] = tf32_rna(v[e]);
            al[i][e] = 0u;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bs + (c0 + 8 * j + g) * RW + 8 * ks + t;
        split_tf32(p[0], bh[j][0], bl[j][0]);
        split_tf32(p[4], bh[j][1], bl[j][1]);
      }
      mma_tf32_tile<MT, R == TF32X3>(acc, ah, al, bh, bl);
    }
  }
}

// Tall path: a block owns BM rows x BN columns over the lanes of split
// blockIdx.z; 8 warps, each (BM / WARPS_M) x 32.  Blocks an SM: the
// narrowest sheets (BN 32) are bound by their activations' loads and
// conditioning, four (64 registers a thread) hide their latency; the
// codes route keeps two (128 registers; at one, the train rows took 25 %
// longer); the TF32 routes' ring (147 KB at 128 x 128) holds one.
template <int R, int BM, int BN, bool XT>
__global__ void __launch_bounds__(TALL_THREADS,
                                  XT && BN == 32 ? 4 : (R == CODES ? 2 : 1))
fused_kernel_tall(Operands o, TallArgs a) {
  using Acc = typename RouteOf<R>::Acc;
  constexpr int BK = RouteOf<R>::BK, STAGES = tall_stages<XT>();
  constexpr int SLOT = (BM + BN) * RouteOf<R>::ROW;
  constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
  constexpr int WM = BM / WARPS_M, MT = WM / 16;
  static_assert(WARPS_M * WARPS_N == 8 && MT >= 1 && WM % 16 == 0,
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp / WARPS_N) * WM, c0 = (warp % WARPS_N) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * a.k_per_split;
  const int steps = (min(a.kp, kb + a.k_per_split) - kb) / BK;
  const float gate = __ldg(o.gg + 0), mgate = __ldg(o.gg + 1);
  const float inv_q = 1.0f / o.qf;
  float gains[MAX_PLANES];
  load_gains(o, gains);
  Acc acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      tall_stage<R, BM, BN, XT>(ring + s * SLOT, o, a, gains, gate, mgate,
                                inv_q, m0, n0, kb + s * BK);
    cp_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();             // stage i landed; stage i - 1 is consumed
    const int nxt = i + STAGES - 1;
    if (nxt < steps)
      tall_stage<R, BM, BN, XT>(ring + (nxt % STAGES) * SLOT, o, a, gains,
                                gate, mgate, inv_q, m0, n0, kb + nxt * BK);
    cp_commit();
    if constexpr (R == CODES) {
      tall_mma<R, BM, MT>(ring + (i % STAGES) * SLOT, acc, r0, c0, g, t);
    } else {
      // a stage's TF32 products in their own accumulators, added to the
      // sum with float32 rounding: the tensor cores' accumulation
      // truncates, and over all of K that error would grow with K
      float part[MT][4][4];
#pragma unroll
      for (int i2 = 0; i2 < MT; ++i2)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i2][j][q] = 0.f;
      tall_mma<R, BM, MT>(ring + (i % STAGES) * SLOT, part, r0, c0, g, t);
#pragma unroll
      for (int i2 = 0; i2 < MT; ++i2)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[i2][j][q] = acc[i2][j][q] + part[i2][j][q];
    }
  }

  // acc[i][j][q]: row r0 + 16 i + g + 8 (q / 2), column c0 + 8 j + 2 t +
  // q % 2; the flush multiplies a code sum by 1/qmax first
  const float sw = __ldg(o.gg + 2);
  const float sw_q = (o.flags & ANALOG) ? sw : sw / o.qf;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 16 * i + g + 8 * h;
      if (row >= a.m) continue;
      const float scale = a.splits == 1 ? row_s2(o, row) * sw_q : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + c0 + 8 * j + 2 * t + e;
          if (col >= a.n) continue;
          const Acc v = acc[i][j][2 * h + e];
          if (a.splits == 1) {
            const float s = R == CODES ? (float)v * inv_q : (float)v;
            a.out[(long long)row * a.ldo + col] = s * scale;
          } else {
            static_cast<Acc*>(a.part)[((long long)blockIdx.z * a.m + row) *
                                          a.n + col] = v;
          }
        }
    }
}

// out = the K split's partial tiles summed in split order, then flushed
// (a code sum times 1/qmax first).  The decode path's float partials too.
template <class T>
__global__ void flush_splits(const T* __restrict__ part,
                             const float* __restrict__ sx,
                             const float* __restrict__ gg,
                             float* __restrict__ out, int m, int n, int ldo,
                             int ld_sx, int splits, float qf, int analog) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)m * n) return;
  int r = (int)(i / n), c = (int)(i % n);
  T s = 0;
  for (int z = 0; z < splits; ++z) s = s + part[((long long)z * m + r) * n + c];
  float v = (float)s;
  if (std::is_same<T, int>::value) v = v * (1.0f / qf);
  float s2 = sx[(long long)r * ld_sx + 2], sw = gg[2];
  out[(long long)r * ldo + c] = v * (analog ? s2 * sw : s2 * (sw / qf));
}

int grid_stride_blocks(long long total) {
  long long b = (total + 255) / 256;
  return (int)(b < 4096 ? (b < 1 ? 1 : b) : 4096);
}

template <int R, int BM, int BN, bool XT>
cudaError_t tall_main(const Operands& o, const TallArgs& a, cudaStream_t st) {
  using RT = RouteOf<R>;
  auto kern = fused_kernel_tall<R, BM, BN, XT>;
  const int slot = (BM + BN) * RT::ROW;
  // the ring holds no more stages than a split has
  const int stages = min(tall_stages<XT>(), a.k_per_split / RT::BK);
  // the shared-memory limit is raised once per device, to the whole ring
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(raised & (1u << dev))) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tall_stages<XT>() * slot);
    if (err != cudaSuccess) return err;
    if (dev < 32) raised |= 1u << dev;
  }
  dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN, a.splits);
  kern<<<grid, TALL_THREADS, (size_t)stages * slot, st>>>(o, a);
  return cudaGetLastError();
}

// The tall path of one route: the prologues, the product, the flush of a
// K split.  bm / bn / xt as ops.plan chose them.
template <int R>
cudaError_t tall_route(const Operands& o, const TallArgs& a, const float* w,
                       int ldw, int bm, int bn, int xt, cudaStream_t st) {
  using Acc = typename RouteOf<R>::Acc;
  const int np = (a.n + bn - 1) / bn * bn, mp = (a.m + bm - 1) / bm * bm;
  const long long wtiles = (long long)((a.kp + W_TILE - 1) / W_TILE) *
                          ((np + W_TILE - 1) / W_TILE);
  tall_w_operand<R><<<(unsigned)(wtiles < 8192 ? wtiles : 8192), 256, 0,
                      st>>>(o, w, a.wt, a.k, a.n, ldw, a.kp, np);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!xt) {
    tall_x_operand<R><<<grid_stride_blocks((long long)mp * (a.kp / 4)), 256,
                        0, st>>>(o, a.xw, a.m, a.k, a.kp, mp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (xt && bm == 128 && bn == 32) err = tall_main<R, 128, 32, true>(o, a, st);
  else if (xt && bm == 128 && bn == 64) err = tall_main<R, 128, 64, true>(o, a, st);
  else if (xt && bm == 128 && bn == 128) err = tall_main<R, 128, 128, true>(o, a, st);
  else if (!xt && bm == 64 && bn == 128) err = tall_main<R, 64, 128, false>(o, a, st);
  else if (!xt && bm == 128 && bn == 128) err = tall_main<R, 128, 128, false>(o, a, st);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long total = (long long)a.m * a.n;
  flush_splits<Acc><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const Acc*>(a.part), o.sx, o.gg, a.out, a.m, a.n, a.ldo,
      o.ld_sx, a.splits, o.qf, (o.flags & ANALOG) != 0);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// x_off / w_off: three device pointers each (or null when that side does
// not realize); *_strides: (row, column) element strides per stream.
// chain: the 19 float32 constants of struct Chain, in order (host memory).
// The caller plans the launch (repro_torch.kernels.rosa_fused.ops.plan):
// m <= 16 takes the decode path with splits / k_per_split, the operand
// workspace holding k * pad4(m) floats and part splits * m * n floats
// when splits > 1.  m > 16 takes the tall path on `route` (enum Route)
// with m_tile x n_tile blocks, K split `splits` ways in k_per_split lanes
// (a multiple of the route's stage, covering K rounded up to it: kp); the
// operand workspace holds the weight's (np, kp) operand and x_work the
// activations' (mp, kp) (np, mp: N, M rounded up to their tiles; int8 on
// the codes route, else float), or x_tile conditions them in the tile
// (x_work may be null); part holds splits * m * n int32 (codes) or
// floats when splits > 1.
int rosa_fused_launch(const float* x, const float* w, const float* gains,
                      const float* sx, const float* gg,
                      const float* const* x_off, const long long* x_strides,
                      const float* const* w_off, const long long* w_strides,
                      float* out, void* operand, void* x_work, void* part,
                      int m, int k, int n, int ldx, int ldw, int ldo,
                      int ld_sx, int n_planes, int radix_bits, float qmax,
                      int flags, const float* chain, int splits,
                      int k_per_split, int n_tile, int route, int m_tile,
                      int x_tile, void* stream) {
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
  const int bits = radix_bits * n_planes;
  o.code_mask = bits >= 31 ? 0x7fffffff : (1 << bits) - 1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;

  if (m > skinny::MAX_M) {
    const int bk = route == CODES ? RouteOf<CODES>::BK : RouteOf<TF32X3>::BK;
    TallArgs a;
    a.xw = x_work; a.wt = operand; a.out = out; a.part = part;
    a.m = m; a.k = k; a.n = n; a.kp = (k + bk - 1) / bk * bk; a.ldo = ldo;
    a.k_per_split = k_per_split; a.splits = splits;
    if (splits < 1 || splits > 65535 || k_per_split < bk ||
        k_per_split % bk != 0 || (long long)k_per_split * splits < a.kp ||
        (long long)k_per_split * (splits - 1) >= a.kp ||
        (splits > 1 && part == nullptr) || (!x_tile && x_work == nullptr))
      return (int)cudaErrorInvalidValue;
    // the codes route takes integer codes on both sides (ops.route_of)
    if (route == CODES &&
        ((flags & (ANALOG | REALIZE_W | USE_MGATE)) || qmax > 127.f))
      return (int)cudaErrorInvalidValue;
    if (route == TF32X2 && ((flags & ANALOG) || qmax >= 2048.f))
      return (int)cudaErrorInvalidValue;
    switch (route) {
      case CODES: return (int)tall_route<CODES>(o, a, w, ldw, m_tile, n_tile, x_tile, st);
      case TF32X2: return (int)tall_route<TF32X2>(o, a, w, ldw, m_tile, n_tile, x_tile, st);
      case TF32X3: return (int)tall_route<TF32X3>(o, a, w, ldw, m_tile, n_tile, x_tile, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }

  if (splits < 1 || k_per_split < 1 ||
      (long long)k_per_split * splits < k || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  float* xr = static_cast<float*>(operand);
  float* partial = static_cast<float*>(part);
  const int mp = skinny::pad4(m);
  x_operand<<<grid_stride_blocks((long long)k * mp), 256, 0, st>>>(
      o, xr, m, k, mp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int vec = ((uintptr_t)w % 16 == 0) && (ldw % 4 == 0);
  WeightOp op;
  op.o = o;
  err = skinny::launch<false>(m, w, xr, gains, splits > 1 ? partial : out,
                              k, n, ldw, ldo, n_planes, k_per_split, splits,
                              vec, op, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  long long total = (long long)m * n;
  flush_splits<float><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      partial, sx, gg, out, m, n, ldo, ld_sx, splits, qmax,
      (flags & ANALOG) != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
