// Mamba-2 SSD chunked scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// (ssd_scan_pallas, body _kernel) together with its wrapper's group
// broadcast and tail padding (src/repro/kernels/ssd_scan/ops.py).  Per
// (batch b, head h) the sequence is cut into chunks of Q steps and, with
// l_i the inclusive prefix sum of log a over the chunk,
//
//     att = (C B^T) . tril(exp(l_i - l_j))              (Q, Q)
//     Y   = att X + exp(l_i) . (C S_in)                 (Q, P)
//     S_c = (B . w)^T X,  w_j = exp(l_Q - l_j)          (S, P)
//     S_in(c + 1) = exp(l_Q) S_in(c) + S_c,  S_in(0) = 0
//
// x is (B, L, H, P), loga (B, L, H), b and c (B, L, G, S) with G head
// groups (head h reads group h / (H / G)); y is (B, L, H, P) and the final
// state (B, H, S, P) = S_in after the last chunk, all float32, contiguous.
//
// What bounds it on the H100: at the served shape (L 512, H 64, P 64, G 1,
// S 128, Q 128) the chunked form needs 1.23 GFLOP against 17 MB moved,
// so float32 arithmetic on the CUDA cores bounds it (no TF32: parity).
// A kernel with one block per (b, h, 32 columns of P) looping over the
// chunks executes 3.05x that work, recomputing the group's C B^T on the
// full square in all 128 blocks, on a grid of one 8-warp block per SM.
//
// Design: the TPU grid's sequential chunk axis carried the state in VMEM;
// here only the (S x P) recurrence stays sequential.  Three launches on
// one stream, no host synchronization, a workspace the wrapper allocates:
//
//   1. ssd_chunk_state  C B^T once per (b, group, chunk), 32 x 32 tiles of
//                       the causal triangle only, into (B, G, NC, Q, Q),
//                       which every head of the group reads from L2; and,
//                       in the other blocks, per (b, h, chunk) the prefix
//                       sums of log a in step order and S_c on 64 x 64
//                       tiles of S x P;
//   2. ssd_state_pass   S_in in chunk order, over (b, h, s, p), in place
//                       over S_c, keeping fmaf(dq, S, S_c);
//   3. ssd_chunk_out    Y per (b, h, chunk, 64 rows, 64 columns of P).
//
// The contractions are 64 x 64 register tiles, 4 x 4 per thread (32 x 32
// and 2 x 2 for C B^T), over 32-deep strips staged through shared memory
// by cp.async (16-byte copies when the rows are 16-byte aligned,
// zero-filled past every edge) in a ring of STAGES slots; each sum runs in
// step or state order with fmaf.  Offsets inside a block are 32-bit from
// a 64-bit block base; every grid keeps chunks, heads and tiles on x and
// the batch on y (<= 65535).  The decay is exp(l_i - l_j), never
// exp(l_i) / exp(l_j) (l reaches about -90 within a chunk and exp(l)
// leaves float32's normal range); the causal mask is a select, so the
// overflowing exp(l_i - l_j), j > i, is never taken.
// Ragged tails are identity steps (log a 0, b = c = x = 0) by zero-filled
// loads, with no padded copies; B and C are read by group index.  Built
// without fast math: expf is the accurate one and keeps denormals.
// Blocks of the output launch start longest first (the last chunk's
// last row tile), so the second wave's tail is short.  What bounds it now
// (per-block timer traces on the H100): each 32-deep strip takes about
// 3 us in a block, well above its multiply-adds' issue time; 8 x 8 and
// 8 x 4 thread tiles, 128 x 64 block tiles, deeper rings, 64-deep strips
// and a third resident block all measured slower or equal, so the two
// contractions run at about a third of the float32 peak.  Tensor cores
// (3xTF32) are later work: the backward's tc_mma is the routine to adopt.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int QMAX = 128;   // longest chunk
constexpr int MT = 256;     // threads of a block (the state pass's too)
constexpr int KS = 32;      // depth of a staged strip
constexpr int LDK = KS + 4; // row of a [rows][KS] strip (16-byte aligned)
constexpr int CT = 32;      // C B^T tile
constexpr int BT = 64;      // state and output tiles (BT x BT)
constexpr int LDT = BT + 4; // row of a [KS][BT] strip
constexpr int TM = 4, TN = 4;     // a thread's rows and columns of a tile
constexpr int MT_BLOCKS = 2;      // resident blocks per SM, at least
static_assert((BT / TM) * (BT / TN) == MT, "one BT x BT tile a block");
static_assert((CT / 2) * (CT / 2) == MT, "one C B^T tile a block");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (0..16) from src, zero-filling the rest of 16 bytes
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A ROWS x COLS tile into dst (leading dimension LD): element (r, k) from
// src[r * stride + k] for r < nr and k < nk, zero elsewhere.  vec: src and
// stride are 16-byte aligned, so 4 elements go in one copy.  Row 0 of src
// is in bounds whenever nr > 0; with nr <= 0 src is not touched.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int stride, int nr, int nk,
                                          bool vec) {
  if (nr <= 0) {
    for (int e = threadIdx.x; e < ROWS * COLS; e += MT)
      dst[(e / COLS) * LD + e % COLS] = 0.f;
  } else if (vec) {
    constexpr int G4 = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * G4; e += MT) {
      const int r = e / G4, k = (e % G4) * 4;
      const int n = r < nr ? min(max(nk - k, 0), 4) : 0;
      cp16(dst + r * LD + k, n ? src + r * stride + k : src, 4 * n);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += MT) {
      const int r = e / COLS, k = e % COLS;
      const bool ok = r < nr && k < nk;
      cp4(dst + r * LD + k, ok ? src + r * stride + k : src, ok ? 4 : 0);
    }
  }
}

// A thread's outputs in a BT x BT tile: rows ty * TM + r, columns
// tx * TN + c, so a quarter-warp reads consecutive float4 of a B row (no
// bank conflict) and one A address; a warp's rows are WROWS consecutive
// rows.
constexpr int WROWS = 32 / (BT / TN) * TM;

__device__ __forceinline__ int tile_row(int ty, int r) { return ty * TM + r; }

__device__ __forceinline__ int tile_col(int tx, int c) { return tx * TN + c; }

// acc[r][c] += sum_k A[row r][k] B[k][col c] over the first kq (a
// multiple of 4) of a strip's KS columns, k in order; A is [BT][LDK]
// (row-major) or, with AK, [KS][LDT] (k-major); B is [KS][LDT].
template <bool AK>
__device__ __forceinline__ void strip_mma(const float* A, const float* B,
                                          float acc[TM][TN], int ty, int tx,
                                          int kq = KS) {
#pragma unroll
  for (int k = 0; k < KS; k += 4) {
    if (k >= kq) break;
    float a[4][TM];                    // a[kk][r]
    if (AK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < TM; r += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              A + (k + kk) * LDT + tile_row(ty, r));
          a[kk][r] = v.x; a[kk][r + 1] = v.y;
          a[kk][r + 2] = v.z; a[kk][r + 3] = v.w;
        }
    } else {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(
            A + tile_row(ty, r) * LDK + k);
        a[0][r] = v.x; a[1][r] = v.y; a[2][r] = v.z; a[3][r] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[TN];
#pragma unroll
      for (int c = 0; c < TN; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            B + (k + kk) * LDT + tile_col(tx, c));
        b[c] = v.x; b[c + 1] = v.y; b[c + 2] = v.z; b[c + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          acc[r][c] = fmaf(a[kk][r], b[c], acc[r][c]);
    }
  }
}

// A ring of STAGES strips in shared memory: load(s, slot) issues strip s's
// copies into a slot, compute(s, slot) consumes it.  ring_fill puts the
// first STAGES - 1 strips in flight; ring_run keeps strip s + STAGES - 1
// in flight while strip s is computed, one barrier a strip.
constexpr int STAGES = 3;

template <class Load>
__device__ __forceinline__ void ring_fill(int n, Load load) {
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_commit();
  }
}

template <class Load, class Compute>
__device__ __forceinline__ void ring_run(int n, Load load, Compute compute) {
  for (int s = 0; s < n; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();              // strip s landed; slot s - 1 is free
    const int next = s + STAGES - 1;
    if (next < n) load(next, next % STAGES);
    cp_commit();
    compute(s, s % STAGES);
  }
}

struct Dims {
  int L, H, P, G, S, Q, NC;
  int tri, ns, np, nm;      // tiles: C B^T triangle, S and P of a
                            // state, rows of an output
  int vec_x, vec_bc, vec_q; // 16-byte copies for x, b/c, a Q-row
  int tq = 0;               // the backward's: C B^T tiles along Q, and
  int vec_ws = 0;           // 16-byte copies for a state row (P % 4 == 0)
};

// acc[r][c] = <row ty * 2 + r of a, row tx * 2 + c of b> over `depth`
// columns, for a CT x CT tile: nra / nrb valid rows (zero past them),
// rows `stride` floats apart, strips of KS columns staged by the ring
// (smem: STAGES slots of two [CT][LDK] strips), sums in column order.
__device__ __forceinline__ void rowdot_tile(const float* a, const float* b,
                                            int stride, int nra, int nrb,
                                            int depth, bool vec, float* smem,
                                            float acc[2][2]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int strips = (depth + KS - 1) / KS;
  auto load = [&](int s, int slot) {
    const int k0 = s * KS;
    float* p = smem + slot * 2 * CT * LDK;
    load_tile<CT, KS, LDK>(p, a + k0, stride, nra, depth - k0, vec);
    load_tile<CT, KS, LDK>(p + CT * LDK, b + k0, stride, nrb, depth - k0,
                           vec);
  };
  ring_fill(strips, load);
  ring_run(strips, load, [&](int, int slot) {
    const float* A = smem + slot * 2 * CT * LDK;
    const float* B = A + CT * LDK;
#pragma unroll
    for (int k = 0; k < KS; k += 4) {
      float4 av[2], bv[2];
      for (int r = 0; r < 2; ++r)
        av[r] = *reinterpret_cast<const float4*>(A + (ty * 2 + r) * LDK + k);
      for (int c = 0; c < 2; ++c)
        bv[c] = *reinterpret_cast<const float4*>(B + (tx * 2 + c) * LDK + k);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 2; ++c) {
          acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
          acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
          acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
          acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
        }
    }
  });
}

// C B^T of one (b, group, chunk) on one 32 x 32 tile of the causal
// triangle (diagonal tiles whole), t counting (chunk, group) and then the
// triangle's tiles row by row.  cbt is (B, G, NC, Q, Q); tiles above the
// diagonal, and rows past a ragged tail, are never written: the output's
// causal select and its row mask never take them.  smem: STAGES slots of
// a C strip and a B strip, [CT][LDK] each.
__device__ __forceinline__ void cbt_tile(const float* __restrict__ bm,
                                         const float* __restrict__ cm,
                                         float* __restrict__ cbt, int t,
                                         const Dims& d, float* smem) {
  int tile = t % d.tri;
  t /= d.tri;
  const int ch = t % d.NC, g = t / d.NC, b = blockIdx.y;
  int ti = 0;
  while (tile > ti) tile -= ++ti;
  const int i0 = ti * CT, j0 = tile * CT;
  const int t0 = ch * d.Q, nv = min(d.Q, d.L - t0);
  if (i0 >= nv) return;   // rows past a ragged tail: no output reads them
  const int row = d.G * d.S;
  const long long base = ((long long)b * d.L + t0) * row + (long long)g * d.S;
  const float* cb = cm + base + (long long)i0 * row;
  const float* bb = bm + base + (long long)j0 * row;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  rowdot_tile(cb, bb, row, min(CT, nv - i0), min(CT, nv - j0), d.S,
              d.vec_bc, smem, acc);
  float* out = cbt + (((long long)b * d.G + g) * d.NC + ch) * d.Q * d.Q;
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + ty * 2 + r;
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + tx * 2 + c;
      if (i < d.Q && j < d.Q) out[i * d.Q + j] = acc[r][c];
    }
  }
}

// 1. One launch, two kinds of block.  The last tri * NC * G blocks each
// compute a C B^T tile (cbt_tile; short, they fill the last wave).  The
// others each take one (b, h, chunk) and a 64 x 64 tile of S x P: l_i,
// the inclusive prefix sum of log a over the chunk, in step order as the
// plain version's cumsum sums it (a tree scan drifted the logits 7x the
// float-order floor over 48 layers), run on past the chunk's valid steps
// with log a = 0 up to QMAX, so its tail holds l_Q; the block of the first
// tile writes l to lc (B, H, NC, Q) for the later launches; then
// S_c = (B . w)^T X, w_j = exp(l_Q - l_j), into st (B, H, NC, S, P).
// Dynamic shared memory: STAGES slots of a B strip [j][s] and an X strip
// [j][p], then l and w.
constexpr int STATE_SLOT = 2 * KS * LDT;
constexpr int STATE_SMEM = 4 * (STAGES * STATE_SLOT + 2 * QMAX);
static_assert(2 * CT * LDK <= STATE_SLOT,
              "a C B^T slot fits a state slot's shared memory");

__global__ void __launch_bounds__(MT, MT_BLOCKS)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ loga,
                const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ lc, float* __restrict__ cbt,
                float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int n_state = d.ns * d.np * d.NC * d.H;
  if ((int)blockIdx.x >= n_state) {
    cbt_tile(bm, cm, cbt, blockIdx.x - n_state, d, smem);
    return;
  }
  float* l = smem + STAGES * STATE_SLOT;   // 16-byte aligned
  float* w = l + QMAX;
  int t = blockIdx.x;
  const int tile = t % (d.ns * d.np);
  t /= d.ns * d.np;
  const int ch = t % d.NC, h = t / d.NC, b = blockIdx.y;
  const int g = h / (d.H / d.G);
  const int s0 = (tile / d.np) * BT, p0 = (tile % d.np) * BT;
  const int t0 = ch * d.Q, nv = min(d.Q, d.L - t0);
  const int brow = d.G * d.S, xrow = d.H * d.P;
  const float* bb =
      bm + ((long long)b * d.L + t0) * brow + (long long)g * d.S + s0;
  const float* xb =
      x + ((long long)b * d.L + t0) * xrow + (long long)h * d.P + p0;
  const int tid = threadIdx.x, ty = tid / (BT / TN), tx = tid % (BT / TN);
  const int strips = (nv + KS - 1) / KS;
  auto load = [&](int s, int slot) {
    const int j0 = s * KS;
    float* a = smem + slot * STATE_SLOT;
    load_tile<KS, BT, LDT>(a, bb + j0 * brow, brow, nv - j0, d.S - s0,
                           d.vec_bc);
    load_tile<KS, BT, LDT>(a + KS * LDT, xb + j0 * xrow, xrow, nv - j0,
                           d.P - p0, d.vec_x);
  };
  ring_fill(strips, load);
  const float* la = loga + ((long long)b * d.L + t0) * d.H + h;
  for (int j = tid; j < QMAX; j += MT) l[j] = j < nv ? la[j * d.H] : 0.f;
  __syncthreads();
  if (tid == 0) {   // one chain of adds; 16 values a time in registers
    float run = 0.f;
    for (int j = 0; j < QMAX / 4; j += 4) {
      float4 v[4];
      for (int q = 0; q < 4; ++q) v[q] = reinterpret_cast<float4*>(l)[j + q];
      float* f = reinterpret_cast<float*>(v);
      for (int q = 0; q < 16; ++q) {
        run += f[q];
        f[q] = run;
      }
      for (int q = 0; q < 4; ++q) reinterpret_cast<float4*>(l)[j + q] = v[q];
    }
  }
  __syncthreads();
  if (tile == 0) {
    float* lo = lc + (((long long)b * d.H + h) * d.NC + ch) * d.Q;
    for (int j = tid; j < d.Q; j += MT) lo[j] = l[j];
  }
  const float lq = l[QMAX - 1];
  for (int j = tid; j < QMAX; j += MT) w[j] = expf(lq - l[j]);
  float acc[TM][TN] = {};
  ring_run(strips, load, [&](int s, int slot) {
    float* a = smem + slot * STATE_SLOT;
    // B . w in place, once per element: row j of the strip times w_j
    for (int e = tid; e < KS * BT; e += MT) {
      const int j = e / BT, k = e % BT;
      a[j * LDT + k] *= w[s * KS + j];
    }
    __syncthreads();
    strip_mma<true>(a, a + KS * LDT, acc, ty, tx);
  });
  float* out = st + ((((long long)b * d.H + h) * d.NC + ch) * d.S) * d.P;
  for (int r = 0; r < TM; ++r) {
    const int sr = s0 + tile_row(ty, r);
    if (sr >= d.S) continue;
    for (int c = 0; c < TN; ++c) {
      const int p = p0 + tile_col(tx, c);
      if (p < d.P) out[sr * d.P + p] = acc[r][c];
    }
  }
}

// 2. In chunk order, per (b, h, s, p): st[c] <- S_in(c) and
// S_in(c + 1) = fmaf(exp(l_Q), S_in(c), S_c); the final state is S_in
// after the last chunk.  A thread takes V consecutive (s, p) of one head
// (V = 4 when S P is a multiple of 4) and loads the next chunk's S_c
// before it stores the current one's S_in.
template <int V>
__global__ void __launch_bounds__(MT, MT_BLOCKS)
ssd_state_pass(const float* __restrict__ lc, float* __restrict__ st,
               float* __restrict__ state, Dims d) {
  using vec = typename std::conditional<V == 4, float4, float>::type;
  const int sp = d.S * d.P;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= d.H * sp) return;
  const int h = e / sp, r = e - h * sp;
  const long long bh = (long long)blockIdx.y * d.H + h;
  vec* s_c = reinterpret_cast<vec*>(st + bh * d.NC * sp + r);
  const long long step = sp / V;
  const float* lq = lc + bh * d.NC * d.Q + d.Q - 1;
  float s[V] = {};
  vec own = s_c[0];
  for (int ch = 0; ch < d.NC; ++ch) {
    const vec next = ch + 1 < d.NC ? s_c[(ch + 1) * step] : own;
    const float dq = expf(lq[(long long)ch * d.Q]);
    const float* o = reinterpret_cast<const float*>(&own);
    vec in;
    float* io = reinterpret_cast<float*>(&in);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      io[k] = s[k];
      s[k] = fmaf(dq, s[k], o[k]);
    }
    s_c[ch * step] = in;
    own = next;
  }
  vec out;
  float* oo = reinterpret_cast<float*>(&out);
#pragma unroll
  for (int k = 0; k < V; ++k) oo[k] = s[k];
  *reinterpret_cast<vec*>(state + bh * sp + r) = out;
}

// 3. Y of one (b, h, chunk) on 64 rows x 64 columns of P:
// (C B^T . tril(exp(l_i - l_j))) X + exp(l_i) (C S_in).  One ring of
// strips: first the intra-chunk ones (decayed C B^T [i][j] against X
// [j][p], columns j < i0 + 64 and < nv), then the inter-chunk ones (C
// [i][s] against S_in [s][p]; none for the first chunk, whose S_in is 0).
// Dynamic shared memory: STAGES slots of an A strip [i][k] and a B strip
// [k][p], then l.
constexpr int OUT_SLOT = BT * LDK + KS * LDT;
constexpr int OUT_SMEM = 4 * (STAGES * OUT_SLOT + QMAX);

__global__ void __launch_bounds__(MT, MT_BLOCKS)
ssd_chunk_out(const float* __restrict__ x, const float* __restrict__ cm,
              const float* __restrict__ lc, const float* __restrict__ cbt,
              const float* __restrict__ st, float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* l = smem + STAGES * OUT_SLOT;
  // longest blocks first: the last row tile (most intra-chunk strips) of
  // the last chunk (an incoming state) leads, the first chunk comes last
  int t = blockIdx.x;
  const int p0 = (t % d.np) * BT;
  t /= d.np;
  const int h = t % d.H;
  t /= d.H;
  const int ch = d.NC - 1 - t % d.NC, b = blockIdx.y;
  const int i0 = (d.nm - 1 - t / d.NC) * BT;
  const int g = h / (d.H / d.G);
  const int t0 = ch * d.Q, nv = min(d.Q, d.L - t0);
  if (i0 >= nv) return;   // no valid row in this tile
  const int tid = threadIdx.x, ty = tid / (BT / TN), tx = tid % (BT / TN);
  const long long bh = (long long)b * d.H + h;
  const int xrow = d.H * d.P, crow = d.G * d.S;
  const float* xb =
      x + ((long long)b * d.L + t0) * xrow + (long long)h * d.P + p0;
  const float* ab = cbt + (((long long)b * d.G + g) * d.NC + ch) * d.Q * d.Q +
                    (long long)i0 * d.Q;
  const float* cb =
      cm + ((long long)b * d.L + t0 + i0) * crow + (long long)g * d.S;
  const float* sb = st + (((bh * d.NC + ch) * d.S) * d.P) + p0;
  const int nr = min(BT, nv - i0);   // valid rows of the tile
  const int jend = min(nv, i0 + BT);
  const int n_intra = (jend + KS - 1) / KS;
  const int n_inter = ch > 0 ? (d.S + KS - 1) / KS : 0;
  auto load = [&](int s, int slot) {
    float* a = smem + slot * OUT_SLOT;
    float* bs = a + BT * LDK;
    if (s < n_intra) {
      const int j0 = s * KS;
      load_tile<BT, KS, LDK>(a, ab + j0, d.Q, min(BT, d.Q - i0), jend - j0,
                             d.vec_q);
      load_tile<KS, BT, LDT>(bs, xb + j0 * xrow, xrow, jend - j0, d.P - p0,
                             d.vec_x);
    } else {
      const int k0 = (s - n_intra) * KS;
      load_tile<BT, KS, LDK>(a, cb + k0, crow, nr, d.S - k0, d.vec_bc);
      load_tile<KS, BT, LDT>(bs, sb + k0 * d.P, d.P, d.S - k0, d.P - p0,
                             d.vec_x);
    }
  };
  ring_fill(n_intra + n_inter, load);
  // l of the chunk, continued past Q with l_Q (identity steps to QMAX)
  const float* lb = lc + (bh * d.NC + ch) * d.Q;
  for (int i = tid; i < QMAX; i += MT) l[i] = lb[min(i, d.Q - 1)];
  float ya[TM][TN] = {}, yi[TM][TN] = {};
  ring_run(n_intra + n_inter, load, [&](int s, int slot) {
    float* a = smem + slot * OUT_SLOT;
    if (s < n_intra) {
      const int j0 = s * KS;
      for (int e = tid; e < BT * KS; e += MT) {
        const int r = e / KS, k = e % KS;
        const int i = i0 + r, j = j0 + k;
        float* v = a + r * LDK + k;
        // a select, not a multiply: exp(l_i - l_j) overflows for j > i
        *v = (j <= i) ? *v * expf(l[i] - l[j]) : 0.f;
      }
      __syncthreads();
      // causal skip: columns past the warp's last row are zero for the
      // whole warp (adding them would change nothing)
      const int last = i0 + (tid / 32) * WROWS + WROWS - 1;
      const int kq = min(KS, (max(last - j0 + 1, 0) + 3) & ~3);
      strip_mma<false>(a, a + BT * LDK, ya, ty, tx, kq);
    } else {
      strip_mma<false>(a, a + BT * LDK, yi, ty, tx);
    }
  });

  float* yb = y + ((long long)b * d.L + t0) * xrow + (long long)h * d.P + p0;
  for (int r = 0; r < TM; ++r) {
    const int i = tile_row(ty, r);
    if (i >= nr) continue;
    const float el = expf(l[i0 + i]);
    for (int c = 0; c < TN; ++c) {
      const int p = tile_col(tx, c);
      if (p0 + p < d.P)
        yb[(i0 + i) * xrow + p] = fmaf(el, yi[r][c], ya[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// The backward.  Per (b, h, chunk), with G = dL/dS_out of the chunk,
// M = (C B^T) . decay, D = (dY X^T) . decay, A = M . (dY X^T):
//
//   dX = M^T dY + diag(w) B G          dB = D^T C + diag(w) X G^T
//   dC = D B + diag(exp l) dY S_in^T   dS_in = exp(l_Q) G + C^T diag(exp l) dY
//   dl_i = sum_j A_ij - sum_i' A_i'i + <C_i, exp(l_i) (dY S_in^T)_i>
//          - w_i <x_i, (B G)_i>,   dl_Q += sum_j w_j <x_j, (B G)_j>
//                                          + exp(l_Q) <S_in, G>
//   d loga = the reverse cumulative sum of dl within the chunk
//
// (kernels/ssd_scan/ref.py::ssd_chunked_backward).  Four launches on one
// stream after the forward's, which the autograd Function keeps: its
// workspace holds l, C B^T and every chunk's S_in, so nothing of the
// forward is recomputed (under recomputation the forward has just run):
//
//   1. ssd_bwd_chunk    per (b, h, chunk) and 64 x 64 tile of S x P,
//                       dS_c = (C . exp l)^T dY; and in the other blocks,
//                       per 64 x 64 tile of the causal triangle, T = dY
//                       X^T, D = T . decay (into the workspace, zero above
//                       the diagonal) and the row and column sums of A on
//                       each of its 32 x 32 quarters;
//   2. ssd_bwd_state    G in reverse chunk order, in place over dS_c,
//                       keeping fmaf(exp(l_Q), G, dS_c);
//   3. ssd_bwd_grads    dX, and each head's dB and dC, on 64-row tiles
//                       (dX's dot products of the carry, dC's of the
//                       incoming state, per row, beside them);
//   4. ssd_bwd_finish   dl from the partial sums in a fixed order and its
//                       reverse cumulative sum in step order; and, when
//                       heads share a group, dB and dC summed over the
//                       group's heads in head order.
//
// It replaces no TPU kernel: the reference trains through jax.grad of
// its jnp chunking (src/repro/models/ssm.py, ssd_chunked).  No float
// atomics anywhere: every sum has one order, so two runs give equal bits.
//
// Where the time went (chip_smoke.py phase 19(a) times each launch
// alone; NVIDIA H100 80GB HBM3, 700 W): at mamba2-1.3b's train shape (B
// 8, L 256, H 64, P 64, S 128) launches 3 and 1 took 0.726 and 0.280 of
// 1.108 ms when they ran the forward's 4 x 4 CUDA-core thread tiles,
// about 12 TFLOP/s against 1.3e10 float32 operations, 98 % of them
// matrix products.  Their products now run on the tensor cores in
// 3xTF32: each float32 operand value a is split into hi =
// cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi) (a - hi is exact; hi +
// lo is a to 2^-22 relative, 22 of its 24 bits), and each 8-deep step
// adds lo.hi, hi.lo and hi.hi, small terms first, to float32
// accumulators (lo.lo, about 2^-22 of the product, is dropped).  Each
// product then stays within (2^-20 + 3 ceil(K/8) 2^-24) sum |a||b|
// (ref.matmul_3xtf32 models it), but where its terms cancel its error can
// exceed 4x the float32 FMA chain's (a causal triangle's, on a quarter
// of the inputs).  Phase 19(a) holds every gradient, whose sums mix many
// products, to 4x the float32 plain backward's distance from float64 plus
// 1e-6 of its max.  At L 1 dc is one product a head summed over the heads,
// and one order of that sum can leave the float32 plain far closer to
// float64 than another: there phase 19(a) takes the largest distance over
// four orders of the heads as the floor (on 16 more inputs).
//
// The route is mma.sync m16n8k8, not wgmma: wgmma takes TF32 operands
// only K-major (the transpose is allowed for 16-bit types alone), and
// half of these products read an operand transposed (M^T dY, D^T C, X
// G^T, (C exp l)^T dY, C B^T read as M^T).  With mma.sync each lane
// loads its own fragment values, so every operand is copied by cp.async
// as it lies in memory (rows padded to 36 or 72 floats: the fragment
// loads are free of bank conflicts in either orientation) into the
// forward's ring of three strips, and read transposed where it must be.
// The split happens as a lane loads a value, not once when a strip is
// staged: a version that split each strip once into hi / lo buffers in
// fragment order moved 144 KB of shared memory a strip against 48 KB
// read raw, and came out slower on the card.  A block keeps 256 threads
// and a 64 x 64 output tile; each warp takes a 32 x 32 quarter over half
// of each strip's four 8-deep steps (16 values loaded and split for 24
// mma, against 12 for 12 with 16 x 32 warp tiles, which came out slower
// on the card), and the two halves are summed in a fixed order into a
// tile in shared memory, from which the epilogues write rows with
// 16-byte stores.  The decay of M^T is formed
// in place in kind 0's strips, once per element of the block (P 64: once
// per element and head); writing M from launch 1 beside D instead would
// add B H NC Q^2 floats (67 MB at the train shape) written and read
// again.  D is written with zeros above the diagonal, so kinds 1 and 2
// read it unmasked; warps skip the 8-deep steps the causal triangle
// zeroes for all their rows.  d loga's row and column sums of A stay
// float32 on the CUDA cores in the order they had (2 x 2 a thread, a
// butterfly over the half warp, 16 row partials in order, on 32 x 32
// quarters), as does launch 4.  What bounds it now: launch 3 takes two
// thirds of the time (phase 19(a) times each launch), and builds of it
// with its mma.sync steps, or its strips' copies, or both left out showed
// the three parts (products, copies, the blocks' barriers and epilogues)
// adding up to nearly the whole: they overlap little at two resident
// blocks an SM.  That launch bound caps ssd_bwd_grads at 128 registers,
// and it spills 20 bytes a thread (the CUDA-core version 16); at one
// block an SM it takes 185 and spills none, with half the warps.  The
// whole backward runs at about a tenth of its 3xTF32 bound.

struct BwdPtrs {
  const float *x, *b, *c, *dy, *dstate;   // operands (dstate may be null)
  const float *lc, *cbt, *st;             // the forward's workspace
  float *dx, *dloga, *db, *dc;            // gradients
  // workspace: G (B, H, NC, S, P), D (B, H, NC, Q, Q), A's row and column
  // sums (B, H, NC, TQ, Q) each, the dot products of dC's incoming state
  // (B, H, NC, NS, Q) and of dX's carry (B, H, NC, NP, Q); each head's dB
  // and dC (B, L, H, S) when heads share a group (else null)
  float *g, *d, *prow, *pcol, *pint, *pcar, *pdb, *pdc;
};

// sum of v over the 16 lanes of a half warp (one row of a 2 x 2 thread
// tile), in a fixed butterfly order; every lane gets the sum
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- 3xTF32 tensor-core tiles ----------------------------------------------
// A raw strip of an operand: 64 rows of KS (leading dimension RLD_R) or KS
// rows of 64 (RLD_K); both take RAW_STRIP floats.  The pads make every
// fragment load below free of bank conflicts in either orientation.
constexpr int RLD_R = KS + 4;            // rows of k: bank 4 g + t
constexpr int RLD_K = BT + 8;            // rows of m or n: bank 8 t + g
constexpr int RAW_STRIP = BT * RLD_R;
static_assert(KS * RLD_K == RAW_STRIP, "both orientations take one size");
constexpr int TC_RAW = 2 * RAW_STRIP;    // a ring slot: an A and a B strip
// dynamic shared memory of the two contraction launches: the forward's
// STAGES ring slots, a staged BT x (BT + 8) tile (tc_stage), l (or exp l)
constexpr int TC_SMEM = 4 * (STAGES * TC_RAW + BT * (BT + 8) + QMAX);

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

// d += a b, m16n8k8, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float d[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// element (m, k) of a raw strip whose rows are k (KM) or m
template <bool KM>
__device__ __forceinline__ float raw_at(const float* r, int m, int k) {
  return KM ? r[k * RLD_K + m] : r[m * RLD_R + k];
}

// acc += the warp's 32 x 32 quarter of A B over its half of a ring slot's
// 8-deep steps (A (64 x KS), then B (KS x 64)): warp w takes rows (w & 2)
// * 16 and columns (w & 1) * 32, and steps 2 (w >> 2) and 2 (w >> 2) + 1
// of the strip where they lie in [k0, k1).  Each lane loads its own
// fragments (A's rows are k when A_KM, B's rows are k when B_KN, so an
// operand read transposed is used as it was copied) and splits each value
// into TF32 hi and lo once; per step lo.hi, hi.lo, hi.hi.  acc[i][j][q]:
// row (w & 2) * 16 + 16 i + g + 8 (q >> 1), column (w & 1) * 32 + 8 j + 2
// t + (q & 1), with g = lane / 4, t = lane % 4.
template <bool A_KM, bool B_KN>
__device__ __forceinline__ void tc_mma(const float* slot,
                                       float acc[2][4][4], int k0 = 0,
                                       int k1 = KS / 8) {
  const float* ra = slot;
  const float* rb = slot + RAW_STRIP;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int m = (w & 2) * 16 + (lane >> 2), n = (w & 1) * 32 + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int ks = (w >> 2) * 2 + kk;
    if (ks < k0 || ks >= k1) continue;
    const int k = ks * 8 + (lane & 3);
    uint4 ah[2], al[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m + 16 * i;
      split_tf32(raw_at<A_KM>(ra, r, k), ah[i].x, al[i].x);
      split_tf32(raw_at<A_KM>(ra, r + 8, k), ah[i].y, al[i].y);
      split_tf32(raw_at<A_KM>(ra, r, k + 4), ah[i].z, al[i].z);
      split_tf32(raw_at<A_KM>(ra, r + 8, k + 4), ah[i].w, al[i].w);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(raw_at<B_KN>(rb, n + 8 * j, k), bh0, bl0);
      split_tf32(raw_at<B_KN>(rb, n + 8 * j, k + 4), bh1, bl1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_tf32(acc[i][j], al[i], bh0, bh1);
        mma_tf32(acc[i][j], ah[i], bl0, bl1);
        mma_tf32(acc[i][j], ah[i], bh0, bh1);
      }
    }
  }
}

// The block's 64 x 64 product into tile[r * LTT + c]: the first half of
// the steps' sums, then plus the second's (a fixed order); acc is zeroed.
// Barriers before (tile is free) and after (tile is whole).
constexpr int LTT = BT + 8;   // a staged tile's row: float2 stores without
                              // bank conflicts
__device__ __forceinline__ void tc_stage(float acc[2][4][4], float* tile) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = (w & 2) * 16 + (lane >> 2);
  const int c = (w & 1) * 32 + 2 * (lane & 3);
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
    if ((w >> 2) == half)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float2* p = reinterpret_cast<float2*>(
                tile + (r + 16 * i + 8 * hr) * LTT + c + 8 * j);
            float2 v = make_float2(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
            if (half) {
              const float2 u = *p;
              v = make_float2(u.x + v.x, u.y + v.y);
            }
            *p = v;
            acc[i][j][2 * hr] = acc[i][j][2 * hr + 1] = 0.f;
          }
  }
  __syncthreads();
}

// 1b. D and A's sums of one (b, h, chunk) on one 64 x 64 tile of the
// causal triangle (t counting (chunk, head), then the triangle's tiles
// row by row): T = dY X^T over P on the tensor cores, staged in shared
// memory; then on each 32 x 32 quarter that holds a valid row, D_ij =
// T_ij exp(l_i - l_j) for j <= i < nv, else 0 (a select), into d;
// A_ij = D_ij (C B^T)_ij; prow[tj][i] = sum over the quarter's columns j
// of A_ij, pcol[ti][j] = sum over its rows i (tj, ti the quarter's
// 32-tile indices).  A quarter above the diagonal writes zeros to d and
// no sums (launch 4 reads none).
__device__ __forceinline__ void dyx_tile(const BwdPtrs& a, int t,
                                         const Dims& d, float* smem) {
  int tile = t % d.tri;
  t /= d.tri;
  const int ch = t % d.NC, h = t / d.NC, b = blockIdx.y;
  int ti = 0;
  while (tile > ti) tile -= ++ti;
  const int tj = tile;
  const int i0 = ti * BT, j0 = tj * BT;
  const int t0 = ch * d.Q, nv = min(d.Q, d.L - t0);
  if (i0 >= nv) return;
  const int g = h / (d.H / d.G);
  const int xrow = d.H * d.P;
  const long long bh = (long long)b * d.H + h;
  const long long base = ((long long)b * d.L + t0) * xrow + (long long)h * d.P;
  const int tid = threadIdx.x;
  float* l = smem + STAGES * TC_RAW + BT * LTT;
  const float* lb = a.lc + (bh * d.NC + ch) * d.Q;
  for (int i = tid; i < QMAX; i += MT) l[i] = lb[min(i, d.Q - 1)];
  const float* yb = a.dy + base + (long long)i0 * xrow;
  const float* xb = a.x + base + (long long)j0 * xrow;
  const int strips = (d.P + KS - 1) / KS;
  auto load = [&](int s, int slot) {   // dY [i][p] as A, X [j][p] as B
    const int k0 = s * KS;
    float* r = smem + slot * TC_RAW;
    load_tile<BT, KS, RLD_R>(r, yb + k0, xrow, min(BT, nv - i0), d.P - k0,
                             d.vec_x);
    load_tile<BT, KS, RLD_R>(r + RAW_STRIP, xb + k0, xrow, min(BT, nv - j0),
                             d.P - k0, d.vec_x);
  };
  float acc[2][4][4] = {};
  ring_fill(strips, load);
  ring_run(strips, load, [&](int, int slot) {
    tc_mma<false, false>(smem + slot * TC_RAW, acc);
  });
  // T staged in shared memory past the ring, the column partials'
  // [16][CT] over the ring
  float* tt = smem + STAGES * TC_RAW;
  float* red = smem;
  tc_stage(acc, tt);
  const float* cb = a.cbt + (((long long)b * d.G + g) * d.NC + ch) * d.Q * d.Q;
  float* dout = a.d + (bh * d.NC + ch) * d.Q * d.Q;
  const long long pb = (bh * d.NC + ch) * d.tq;
  const int ty = tid >> 4, tx = tid & 15;
  for (int qi = 0; qi < 2; ++qi)
    for (int qj = 0; qj < 2; ++qj) {
      const int qi0 = i0 + qi * CT, qj0 = j0 + qj * CT;
      if (qi0 >= nv || qj0 >= d.Q) continue;
      if (qi0 < qj0) {   // above the diagonal: D is zero
        for (int e = tid; e < CT * CT; e += MT) {
          const int i = qi0 + e / CT, j = qj0 + e % CT;
          if (i < d.Q && j < d.Q) dout[i * d.Q + j] = 0.f;
        }
        continue;
      }
      float rs[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};
      for (int r = 0; r < 2; ++r) {
        const int i = qi0 + ty * 2 + r;
        for (int c = 0; c < 2; ++c) {
          const int j = qj0 + tx * 2 + c;
          const float tv = tt[(i - i0) * LTT + j - j0];
          const bool on = j <= i && i < nv;
          const float dv = on ? tv * expf(l[i] - l[j]) : 0.f;
          const float av = on ? dv * cb[i * d.Q + j] : 0.f;
          if (i < d.Q && j < d.Q) dout[i * d.Q + j] = dv;
          rs[r] += av;
          cs[c] += av;
        }
      }
      // rows: over the half warp; columns: over the 16 rows of threads
      __syncthreads();
      for (int c = 0; c < 2; ++c) red[ty * CT + tx * 2 + c] = cs[c];
      for (int r = 0; r < 2; ++r) rs[r] = row_sum16(rs[r]);
      if (tx == 0)
        for (int r = 0; r < 2; ++r) {
          const int i = qi0 + ty * 2 + r;
          if (i < d.Q) a.prow[(pb + qj0 / CT) * d.Q + i] = rs[r];
        }
      __syncthreads();
      if (tid < CT && qj0 + tid < d.Q) {
        float sum = 0.f;
        for (int y = 0; y < 16; ++y) sum += red[y * CT + tid];
        a.pcol[(pb + qi0 / CT) * d.Q + qj0 + tid] = sum;
      }
    }
}

// 1. One launch, two kinds of block.  The last tri * NC * H blocks each
// take a 64 x 64 tile of D (dyx_tile).  The others each take one (b, h,
// chunk) and a 64 x 64 tile of S x P: dS_c = (C . exp l)^T dY into g (B,
// H, NC, S, P), the state pass's input, C . exp l formed in place in
// each strip.
__global__ void __launch_bounds__(MT, MT_BLOCKS)
ssd_bwd_chunk(BwdPtrs a, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int n_state = d.ns * d.np * d.NC * d.H;
  if ((int)blockIdx.x >= n_state) {
    dyx_tile(a, blockIdx.x - n_state, d, smem);
    return;
  }
  float* el = smem + STAGES * TC_RAW + BT * LTT;
  int t = blockIdx.x;
  const int tile = t % (d.ns * d.np);
  t /= d.ns * d.np;
  const int ch = t % d.NC, h = t / d.NC, b = blockIdx.y;
  const int g = h / (d.H / d.G);
  const int s0 = (tile / d.np) * BT, p0 = (tile % d.np) * BT;
  const int t0 = ch * d.Q, nv = min(d.Q, d.L - t0);
  const int crow = d.G * d.S, xrow = d.H * d.P;
  const long long bh = (long long)b * d.H + h;
  const float* cb =
      a.c + ((long long)b * d.L + t0) * crow + (long long)g * d.S + s0;
  const float* yb =
      a.dy + ((long long)b * d.L + t0) * xrow + (long long)h * d.P + p0;
  const float* lb = a.lc + (bh * d.NC + ch) * d.Q;
  for (int i = threadIdx.x; i < QMAX; i += MT)
    el[i] = expf(lb[min(i, d.Q - 1)]);
  const int strips = (nv + KS - 1) / KS;
  auto load = [&](int s, int slot) {   // C [i][s] as A^T, dY [i][p] as B
    const int i0 = s * KS;
    float* r = smem + slot * TC_RAW;
    load_tile<KS, BT, RLD_K>(r, cb + i0 * crow, crow, nv - i0, d.S - s0,
                             d.vec_bc);
    load_tile<KS, BT, RLD_K>(r + RAW_STRIP, yb + i0 * xrow, xrow, nv - i0,
                             d.P - p0, d.vec_x);
  };
  float acc[2][4][4] = {};
  ring_fill(strips, load);
  ring_run(strips, load, [&](int s, int slot) {
    float* r = smem + slot * TC_RAW;
    // C . exp l in place: row i of the strip times exp(l_i)
    for (int e = threadIdx.x; e < KS * BT; e += MT) {
      const int i = e / BT, k = e % BT;
      r[i * RLD_K + k] *= el[s * KS + i];
    }
    __syncthreads();
    tc_mma<true, true>(r, acc);
  });
  float* tt = smem;
  tc_stage(acc, tt);
  float* out = a.g + ((bh * d.NC + ch) * d.S) * d.P;
  const int c4 = (threadIdx.x & 15) * 4;
  for (int u = 0; u < 4; ++u) {
    const int i = (threadIdx.x >> 4) + 16 * u, sr = s0 + i, p = p0 + c4;
    if (sr >= d.S) continue;
    const float4 v = *reinterpret_cast<const float4*>(tt + i * LTT + c4);
    if (d.vec_ws && p + 3 < d.P) {
      *reinterpret_cast<float4*>(out + sr * d.P + p) = v;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
      for (int q = 0; q < 4; ++q)
        if (p + q < d.P) out[sr * d.P + p + q] = f[q];
    }
  }
}

// 2. In reverse chunk order, per (b, h, s, p): g[c] <- G_c and
// G_{c-1} = fmaf(exp(l_Q(c)), G_c, dS_c), from G of the last chunk =
// dstate (zero when null).  V elements a thread, as the forward's pass.
template <int V>
__global__ void __launch_bounds__(MT, MT_BLOCKS)
ssd_bwd_state(BwdPtrs a, Dims d) {
  using vec = typename std::conditional<V == 4, float4, float>::type;
  const int sp = d.S * d.P;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= d.H * sp) return;
  const int h = e / sp, r = e - h * sp;
  const long long bh = (long long)blockIdx.y * d.H + h;
  vec* gc = reinterpret_cast<vec*>(a.g + bh * d.NC * sp + r);
  const long long step = sp / V;
  const float* lq = a.lc + bh * d.NC * d.Q + d.Q - 1;
  float s[V] = {};
  if (a.dstate) {
    const vec v = *reinterpret_cast<const vec*>(a.dstate + bh * sp + r);
    const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = f[k];
  }
  vec own = gc[(d.NC - 1) * step];
  for (int ch = d.NC - 1; ch >= 0; --ch) {
    const vec next = ch > 0 ? gc[(ch - 1) * step] : own;
    const float dq = expf(lq[(long long)ch * d.Q]);
    const float* o = reinterpret_cast<const float*>(&own);
    vec out;
    float* io = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      io[k] = s[k];
      s[k] = fmaf(dq, s[k], o[k]);
    }
    gc[ch * step] = out;
    own = next;
  }
}

// 3. One launch, three kinds of block, each one (b, h, chunk) and 64
// rows of the chunk, t counting (chunk, head) and then the tiles:
//   kind 0, dX on 64 columns of P: strips of M^T [j][i] (C B^T read
//     transposed, times the decay in place, a select above the
//     diagonal) against dY [i][p] for i >= j, then of B [j][s] against G
//     [s][p]; dX = M^T dY + w . (B G); pcar[np][j] = w_j <x_j, (B G)_j>
//     over the tile;
//   kind 1, the head's dB on 64 columns of S: strips of D^T [j][i]
//     against C [i][s] for i >= j, then of X [j][p] against G^T [p][s];
//     dB = D^T C + w . (X G^T);
//   kind 2, the head's dC on 64 columns of S: strips of D [i][j] against
//     B [j][s] for j <= i, then (from the second chunk on) of dY [i][p]
//     against S_in^T [p][s]; dC = D B + exp(l) . (dY S_in^T);
//     pint[ns][i] = <C_i, exp(l_i) (dY S_in^T)_i> over the tile.
// Operands read transposed are copied as they lie and read transposed
// by the tile routine.  The intra-chunk sum is staged after its last
// strip, the other after the ring.  dB and dC go to db / dc when a group
// has one head, else to pdb / pdc.
__global__ void __launch_bounds__(MT, MT_BLOCKS)
ssd_bwd_grads(BwdPtrs a, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* l = smem + STAGES * TC_RAW + BT * LTT;
  const int n_dx = d.np * d.nm * d.NC * d.H;
  const int n_s = d.ns * d.nm * d.NC * d.H;
  int t = blockIdx.x, kind = 0;
  if (t >= n_dx) {
    t -= n_dx;
    kind = 1 + t / n_s;
    t %= n_s;
  }
  const int ncol = kind == 0 ? d.np : d.ns;
  const int c0 = (t % ncol) * BT;
  t /= ncol;
  const int r0 = (t % d.nm) * BT;
  t /= d.nm;
  const int ch = t % d.NC, h = t / d.NC, b = blockIdx.y;
  const int g = h / (d.H / d.G);
  const int t0 = ch * d.Q, nv = min(d.Q, d.L - t0);
  if (r0 >= nv) return;
  const int tid = threadIdx.x, w = tid >> 5;
  const int xrow = d.H * d.P, brow = d.G * d.S;
  const long long bh = (long long)b * d.H + h;
  const long long xoff = ((long long)b * d.L + t0) * xrow + (long long)h * d.P;
  const long long boff = ((long long)b * d.L + t0) * brow + (long long)g * d.S;
  const float* cbt = a.cbt + (((long long)b * d.G + g) * d.NC + ch) * d.Q * d.Q;
  const float* dm = a.d + (bh * d.NC + ch) * d.Q * d.Q;
  const float* gs = a.g + (bh * d.NC + ch) * d.S * d.P;
  const float* sin = a.st + (bh * d.NC + ch) * d.S * d.P;
  const int nr = min(BT, nv - r0);   // valid rows of the tile
  // kinds 0 and 1 sum over i >= j: strips from r0 to nv; kind 2 over
  // j <= i: strips from 0 to the tile's end
  const int kbeg = kind == 2 ? 0 : r0;
  const int kend = kind == 2 ? min(nv, r0 + BT) : nv;
  const int n_intra = (kend - kbeg + KS - 1) / KS;
  const int n_second = kind == 0 ? (d.S + KS - 1) / KS
                       : kind == 1 ? (d.P + KS - 1) / KS
                       : ch > 0 ? (d.P + KS - 1) / KS : 0;
  auto load = [&](int s, int slot) {
    float* r = smem + slot * TC_RAW;
    float* q = r + RAW_STRIP;
    if (s < n_intra) {
      const int k0 = kbeg + s * KS;
      if (kind == 0) {
        load_tile<KS, BT, RLD_K>(r, cbt + (long long)k0 * d.Q + r0, d.Q,
                                 nv - k0, d.Q - r0, d.vec_q);
        load_tile<KS, BT, RLD_K>(q, a.dy + xoff + (long long)k0 * xrow + c0,
                                 xrow, nv - k0, d.P - c0, d.vec_x);
      } else if (kind == 1) {
        load_tile<KS, BT, RLD_K>(r, dm + (long long)k0 * d.Q + r0, d.Q,
                                 nv - k0, d.Q - r0, d.vec_q);
        load_tile<KS, BT, RLD_K>(q, a.c + boff + (long long)k0 * brow + c0,
                                 brow, nv - k0, d.S - c0, d.vec_bc);
      } else {
        load_tile<BT, KS, RLD_R>(r, dm + (long long)r0 * d.Q + k0, d.Q, nr,
                                 kend - k0, d.vec_q);
        load_tile<KS, BT, RLD_K>(q, a.b + boff + (long long)k0 * brow + c0,
                                 brow, kend - k0, d.S - c0, d.vec_bc);
      }
    } else {
      const int k0 = (s - n_intra) * KS;
      if (kind == 0) {
        load_tile<BT, KS, RLD_R>(r, a.b + boff + (long long)r0 * brow + k0,
                                 brow, nr, d.S - k0, d.vec_bc);
        load_tile<KS, BT, RLD_K>(q, gs + (long long)k0 * d.P + c0, d.P,
                                 d.S - k0, d.P - c0, d.vec_ws);
      } else {
        const float* src = kind == 1 ? a.x : a.dy;
        load_tile<BT, KS, RLD_R>(r, src + xoff + (long long)r0 * xrow + k0,
                                 xrow, nr, d.P - k0, d.vec_x);
        load_tile<BT, KS, RLD_R>(q, (kind == 1 ? gs : sin) +
                                        (long long)c0 * d.P + k0,
                                 d.P, d.S - c0, d.P - k0, d.vec_ws);
      }
    }
  };
  ring_fill(n_intra + n_second, load);
  const float* lb = a.lc + (bh * d.NC + ch) * d.Q;
  for (int i = tid; i < QMAX; i += MT) l[i] = lb[min(i, d.Q - 1)];
  // one accumulator: the intra-chunk products, staged into ya's tile
  // after their last strip, then the second products (yb)
  float acc[2][4][4] = {};
  float* ya = smem + STAGES * TC_RAW;
  // the warp's rows: the 8-deep steps that the causal triangle zeroes
  // for all of them add nothing and are skipped
  const int wr0 = r0 + (w & 2) * 16;
  ring_run(n_intra + n_second, load, [&](int s, int slot) {
    float* r = smem + slot * TC_RAW;
    if (s >= n_intra) {   // B [j][s] . G; X [j][p] . G^T; dY [i][p] . S_in^T
      if (kind == 0)
        tc_mma<false, true>(r, acc);
      else
        tc_mma<false, false>(r, acc);
      return;
    }
    const int k0 = kbeg + s * KS;
    if (kind == 2) {   // D [i][j]: j > i is zero past the warp's rows
      const int top = wr0 + 31 - k0;
      tc_mma<false, true>(r, acc, 0, top < 0 ? 0 : min(KS / 8, top / 8 + 1));
    } else {
      if (kind == 0) {   // M^T [j][i] in place from C B^T [i][j], i >= j
        for (int e = tid; e < KS * BT; e += MT) {
          const int k = e / BT, m = e % BT;
          const int i = k0 + k, j = r0 + m;
          float* v = r + k * RLD_K + m;
          // a select, not a multiply: exp(l_i - l_j) overflows for j > i
          *v = i >= j ? *v * expf(l[i] - l[j]) : 0.f;
        }
        __syncthreads();
      }
      // M^T or D^T [j][i] (D is zero above the diagonal as launch 1 wrote
      // it): i < j is zero before the warp's rows
      const int lo = wr0 - k0;
      tc_mma<true, true>(r, acc, lo > 0 ? lo / 8 : 0);
    }
    if (s == n_intra - 1) tc_stage(acc, ya);
  });
  float* yb = smem;   // over the ring, now done
  tc_stage(acc, yb);

  const float lq = l[QMAX - 1];
  const int rowlen = kind == 0 ? d.P : d.S;
  float* out;
  long long orow;
  if (kind == 0) {
    out = a.dx + xoff;
    orow = xrow;
  } else if (d.G == d.H) {
    out = (kind == 1 ? a.db : a.dc) + boff;
    orow = brow;
  } else {
    out = (kind == 1 ? a.pdb : a.pdc) +
          (((long long)b * d.L + t0) * d.H + h) * d.S;
    orow = (long long)d.H * d.S;
  }
  // 16 lanes a row, 4 columns each: 16-byte accesses where rows and
  // pointers allow; the dot products over the row's lanes in a fixed
  // butterfly
  const bool vec = kind == 0 ? d.vec_x : d.vec_bc;
  const float* dsrc = kind == 0 ? a.x + xoff : a.c + boff;
  const int drow = kind == 0 ? xrow : brow;
  const int c4 = (tid & 15) * 4, col = c0 + c4;
  const long long pb = (bh * d.NC + ch) * ncol + c0 / BT;
  for (int u = 0; u < 4; ++u) {
    const int i = (tid >> 4) + 16 * u, row = r0 + i;
    const float sc = kind == 2 ? expf(l[row]) : expf(lq - l[row]);
    float dot = 0.f;
    if (i < nr) {
      const float4 va = *reinterpret_cast<const float4*>(ya + i * LTT + c4);
      const float4 vb = *reinterpret_cast<const float4*>(yb + i * LTT + c4);
      const float fa[4] = {va.x, va.y, va.z, va.w};
      const float fb[4] = {vb.x, vb.y, vb.z, vb.w};
      float o[4];
      for (int q = 0; q < 4; ++q) o[q] = fmaf(sc, fb[q], fa[q]);
      float* op = out + row * orow + col;
      const float* dv = dsrc + (long long)row * drow + col;
      if (vec && col + 3 < rowlen) {
        *reinterpret_cast<float4*>(op) = make_float4(o[0], o[1], o[2], o[3]);
        if (kind != 1) {
          const float4 x4 = *reinterpret_cast<const float4*>(dv);
          const float fx[4] = {x4.x, x4.y, x4.z, x4.w};
          for (int q = 0; q < 4; ++q) dot = fmaf(fx[q], fb[q], dot);
        }
      } else {
        for (int q = 0; q < 4; ++q)
          if (col + q < rowlen) {
            op[q] = o[q];
            if (kind != 1) dot = fmaf(dv[q], fb[q], dot);
          }
      }
    }
    if (kind != 1) {
      for (int o = 1; o < 16; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if ((tid & 15) == 0 && i < nr)
        (kind == 0 ? a.pcar : a.pint)[pb * d.Q + row] = sc * dot;
    }
  }
}

// 4. One launch, two kinds of block.  The first NC * H take one (b, h,
// chunk): dl_i = sum_tj prow[tj][i] - sum_ti pcol[ti][i] + sum pint[.][i]
// - sum pcar[.][i] over the tiles that hold row / column i, in tile
// order; dl_{nv-1} += sum_j pcar_j + exp(l_Q) <S_in, G>; d loga its
// reverse cumulative sum in step order (one thread).  The others, when
// heads share a group, each sum MT elements of dB and dC over the group's
// heads in head order.
__global__ void __launch_bounds__(MT, MT_BLOCKS)
ssd_bwd_finish(BwdPtrs a, Dims d) {
  __shared__ float dl[QMAX], car[QMAX], red[MT];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int n_dl = d.NC * d.H;
  if ((int)blockIdx.x >= n_dl) {
    const long long e =
        (long long)(blockIdx.x - n_dl) * MT + tid;   // over (L, G, S)
    const long long n = (long long)d.L * d.G * d.S;
    if (e >= n) return;
    const int r = d.H / d.G;
    const int gs = (int)(e % (d.G * d.S));
    const long long t = e / (d.G * d.S);
    const int g = gs / d.S, s = gs % d.S;
    const long long src = (((long long)b * d.L + t) * d.H + g * r) * d.S + s;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < r; ++k) {
      sb += a.pdb[src + (long long)k * d.S];
      sc += a.pdc[src + (long long)k * d.S];
    }
    a.db[(long long)b * n + e] = sb;
    a.dc[(long long)b * n + e] = sc;
    return;
  }
  const int ch = blockIdx.x % d.NC, h = blockIdx.x / d.NC;
  const int t0 = ch * d.Q, nv = min(d.Q, d.L - t0);
  const long long bh = (long long)b * d.H + h, bc = bh * d.NC + ch;
  // <S_in, G>: a strided sum a thread, then a fixed tree
  float sg = 0.f;
  if (ch > 0) {
    const float* sin = a.st + bc * d.S * d.P;
    const float* gs = a.g + bc * d.S * d.P;
    for (int e = tid; e < d.S * d.P; e += MT) sg = fmaf(sin[e], gs[e], sg);
  }
  red[tid] = sg;
  __syncthreads();
  for (int o = MT / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  for (int i = tid; i < nv; i += MT) {
    const float* pr = a.prow + bc * d.tq * d.Q + i;
    const float* pc = a.pcol + bc * d.tq * d.Q + i;
    float rs = 0.f, cs = 0.f, in = 0.f, cr = 0.f;
    for (int k = 0; k <= i / CT; ++k) rs += pr[k * d.Q];
    for (int k = i / CT; k <= (nv - 1) / CT; ++k) cs += pc[k * d.Q];
    for (int k = 0; k < d.ns; ++k) in += a.pint[(bc * d.ns + k) * d.Q + i];
    for (int k = 0; k < d.np; ++k) cr += a.pcar[(bc * d.np + k) * d.Q + i];
    dl[i] = rs - cs + in - cr;
    car[i] = cr;
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < nv; ++i) total += car[i];
    const float lq = a.lc[bc * d.Q + d.Q - 1];
    float run = total + expf(lq) * red[0];
    float* out = a.dloga + ((long long)b * d.L + t0) * d.H + h;
    for (int i = nv - 1; i >= 0; --i) {
      run += dl[i];
      out[(long long)i * d.H] = run;
    }
  }
}

// Lets the ring kernels take their dynamic shared memory (past the
// 48 KB default) on the current device; once a device.
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(ssd_chunk_state,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STATE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_out,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               OUT_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TC_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_grads,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TC_SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// Shared memory of each launch's block (bytes), in launch order.
long long ssd_scan_smem_bytes(int which) {
  return which == 0 ? STATE_SMEM : which == 2 ? OUT_SMEM : 0;
}

// Resident blocks per SM of launch `which` (0..2; the state pass in its
// 4-wide form) on the current device.
int ssd_scan_occupancy(int which) {
  int n = 0;
  const void* fn[3] = {(const void*)ssd_chunk_state,
                       (const void*)ssd_state_pass<4>,
                       (const void*)ssd_chunk_out};
  if (which < 0 || which > 2 || allow_smem() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fn[which], MT, (size_t)ssd_scan_smem_bytes(which)) !=
          cudaSuccess)
    return -1;
  return n;
}

// plan: n_chunks, tri, ns, np, nm, then the x extent of the three grids,
// as repro_torch.kernels.ssd_scan.ops.plan computes them.  ws_l, ws_cbt,
// ws_st: the workspace's three parts.  vec: bit 0 x and y, bit 1 b and c,
// bit 2 the C B^T rows may take 16-byte copies.
int ssd_scan_launch(const float* x, const float* loga, const float* b,
                    const float* c, float* y, float* state, float* ws_l,
                    float* ws_cbt, float* ws_st, int B, int L, int H, int P,
                    int G, int S, int Q, const int* plan, int vec,
                    void* stream) {
  if (B < 1 || B > 65535 || L < 0 || H < 1 || P < 1 || G < 1 || S < 1 ||
      H % G != 0 || Q < 1 || Q > QMAX ||
      (long long)H * P * QMAX > 0x7fffffffLL ||
      (long long)G * S * QMAX > 0x7fffffffLL ||
      (long long)H * S * P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Dims d{L, H, P, G, S, Q, plan[0], plan[1], plan[2], plan[3], plan[4],
         vec & 1, (vec >> 1) & 1, (vec >> 2) & 1};
  if (d.NC == 0)
    return (int)cudaMemsetAsync(state, 0, sizeof(float) * B * H * S * P, st);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const unsigned by = (unsigned)B;
  ssd_chunk_state<<<dim3(plan[5], by), MT, STATE_SMEM, st>>>(
      x, loga, b, c, ws_l, ws_cbt, ws_st, d);
  if ((S * P) % 4 == 0)
    ssd_state_pass<4><<<dim3(plan[6], by), MT, 0, st>>>(ws_l, ws_st, state,
                                                       d);
  else
    ssd_state_pass<1><<<dim3(plan[6], by), MT, 0, st>>>(ws_l, ws_st, state,
                                                       d);
  ssd_chunk_out<<<dim3(plan[7], by), MT, OUT_SMEM, st>>>(
      x, c, ws_l, ws_cbt, ws_st, y, d);
  return (int)cudaGetLastError();
}


// Shared memory of each backward launch's block (bytes), in launch order.
long long ssd_scan_backward_smem_bytes(int which) {
  return which == 0 || which == 2 ? TC_SMEM : 0;
}

// Resident blocks per SM of backward launch `which` (0..3; the state pass
// in its 4-wide form) on the current device.
int ssd_scan_backward_occupancy(int which) {
  int n = 0;
  const void* fn[4] = {(const void*)ssd_bwd_chunk,
                       (const void*)ssd_bwd_state<4>,
                       (const void*)ssd_bwd_grads,
                       (const void*)ssd_bwd_finish};
  if (which < 0 || which > 3 || allow_smem() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fn[which], MT, (size_t)ssd_scan_backward_smem_bytes(which)) !=
          cudaSuccess)
    return -1;
  return n;
}

// The backward of one scan, after ssd_scan_launch on the same operands:
// ws_l, ws_cbt, ws_st are that launch's workspace (l, C B^T, S_in).  dy
// (B, L, H, P) and dstate (B, H, S, P; null: zero) are the cotangents;
// dx, dloga, db, dc the gradients, shaped as x, loga, b, c.  ws: the
// backward's workspace, in BwdPtrs order from g (pdb and pdc null when
// G == H).  plan: n_chunks, tri (64 x 64 tiles of the causal triangle),
// ns, np, nm, tq (its 32-row tiles), then the x extent of the four
// grids, as repro_torch.kernels.ssd_scan.ops.plan_backward computes
// them.  vec: bit 0 x and dy, bit 1 b and c, bit 2 a Q-row, bit 3 a state
// row (P % 4 == 0) may take 16-byte copies.  stages: a mask of the four
// launches to run (15: the backward; one bit: that launch alone, on a
// workspace an earlier whole backward filled, to time it).
int ssd_scan_backward_launch(const float* x, const float* b, const float* c,
                             const float* dy, const float* dstate,
                             const float* ws_l, const float* ws_cbt,
                             const float* ws_st, float* dx, float* dloga,
                             float* db, float* dc, float* const* ws, int B,
                             int L, int H, int P, int G, int S, int Q,
                             const int* plan, int vec, int stages,
                             void* stream) {
  if (B < 1 || B > 65535 || L < 0 || H < 1 || P < 1 || G < 1 || S < 1 ||
      H % G != 0 || Q < 1 || Q > QMAX ||
      (long long)H * P * QMAX > 0x7fffffffLL ||
      (long long)G * S * QMAX > 0x7fffffffLL ||
      (long long)H * S * P > 0x7fffffffLL ||
      (G != H && (ws[6] == nullptr || ws[7] == nullptr)) || stages < 1 ||
      stages > 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Dims d{L, H, P, G, S, Q, plan[0], plan[1], plan[2], plan[3], plan[4],
         vec & 1, (vec >> 1) & 1, (vec >> 2) & 1, plan[5], (vec >> 3) & 1};
  if (d.NC == 0) return 0;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  BwdPtrs a{x,  b,     c,  dy, dstate, ws_l,  ws_cbt, ws_st, dx,    dloga, db,
            dc, ws[0], ws[1], ws[2], ws[3], ws[4], ws[5], ws[6], ws[7]};
  const unsigned by = (unsigned)B;
  if (stages & 1)
    ssd_bwd_chunk<<<dim3(plan[6], by), MT, TC_SMEM, st>>>(a, d);
  if ((stages & 2) && (S * P) % 4 == 0)
    ssd_bwd_state<4><<<dim3(plan[7], by), MT, 0, st>>>(a, d);
  else if (stages & 2)
    ssd_bwd_state<1><<<dim3(plan[7], by), MT, 0, st>>>(a, d);
  if (stages & 4)
    ssd_bwd_grads<<<dim3(plan[8], by), MT, TC_SMEM, st>>>(a, d);
  if (stages & 8)
    ssd_bwd_finish<<<dim3(plan[9], by), MT, 0, st>>>(a, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
