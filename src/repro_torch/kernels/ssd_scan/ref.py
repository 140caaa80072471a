"""Plain PyTorch versions of the Mamba-2 SSD scan (port of the reference's
`kernels/ssd_scan/ref.py`, plus the batched chunked form of
`models/ssm.py::ssd_chunked`).

State-space duality (SSD) recurrence, per (batch, head):

    S_t = a_t * S_{t-1} + b_t x_t^T          S in R^{d_state x d_head}
    y_t = c_t @ S_t                          y in R^{d_head}

with a_t = exp(A * dt_t) in (0, 1] the scalar per-step decay.
`ssd_scan_ref` is the sequential ground truth, `ssd_scan_chunked_ref` the
chunked matmul form of one sequence, and `ssd_chunked` the batched chunked
form with head groups: the plain version of the CUDA kernel
(`csrc/ssd_scan.cu`), which the wrapper runs for CPU tensors.
`ssd_chunked_backward` is its gradient in explicit chunked formulas: the
plain version of the backward kernel in the same source.  Both compute in
float32, or in float64 for float64 operands.  `split_tf32` and
`matmul_3xtf32` model the backward kernel's tensor-core products (3xTF32)
on the CPU.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, s0: torch.Tensor | None = None):
    """Sequential oracle.

    x: (L, P) inputs; a: (L,) decays in (0, 1]; b, c: (L, S); s0: (S, P)
    initial state.  Returns (y: (L, P), s_f: (S, P))."""
    l, p = x.shape
    s = (torch.zeros((b.shape[-1], p), dtype=x.dtype, device=x.device)
         if s0 is None else s0)
    ys = []
    for t in range(l):
        s = a[t] * s + b[t][:, None] * x[t][None, :]
        ys.append(c[t] @ s)
    y = torch.stack(ys) if ys else x.new_zeros((0, p))
    return y, s


def ssd_scan_chunked_ref(x, a, b, c, chunk: int, s0=None):
    """Chunked matmul form of one sequence (what the kernel implements).

    Within a chunk (log-decay prefix sums l_i = sum_{j<=i} log a_j):
      intra:  Y[i] += sum_{j<=i} (c_i . b_j) * exp(l_i - l_j) * x_j
      inter:  Y[i] += exp(l_i) * c_i @ S_in
      carry:  S_out = exp(l_Q) * S_in + sum_j exp(l_Q - l_j) * b_j x_j^T
    L must be a multiple of `chunk`."""
    l, p = x.shape
    s_dim = b.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}")
    s = (torch.zeros((s_dim, p), dtype=torch.float32, device=x.device)
         if s0 is None else s0)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for lo in range(0, l, chunk):
        xq, aq, bq, cq = (t[lo:lo + chunk].float() for t in (x, a, b, c))
        lcum = torch.cumsum(torch.log(aq), 0)
        ltot = lcum[-1]
        dmat = torch.exp((lcum[:, None] - lcum[None, :])
                         .masked_fill(~mask, float("-inf")))
        y = ((cq @ bq.T) * dmat) @ xq
        y = y + torch.exp(lcum)[:, None] * (cq @ s)
        w = torch.exp(ltot - lcum)
        s = torch.exp(ltot) * s + (bq * w[:, None]).T @ xq
        ys.append(y)
    return torch.cat(ys) if ys else x.new_zeros((0, p)), s


def ssd_chunked(x: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                state0: torch.Tensor | None = None):
    """Batched chunked SSD scan with head groups.

    x: (B, L, H, P) (dt already folded in); loga: (B, L, H); b, c:
    (B, L, G, S) with G dividing H: head h reads group h // (H // G).  With
    G = H this is the reference's `ssd_chunked`.  A ragged L is padded with
    identity steps (log a = 0 keeps the state, b = c = 0 write and read
    nothing).  Returns (y: (B, L, H, P), state: (B, H, S, P))."""
    bsz, l, h, p = x.shape
    g, s_dim = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    r = h // g
    xs, ls, bs, cs = _chunks(chunk, g, x, loga, b, c)
    n = xs.shape[1]
    dt = xs.dtype
    s = (torch.zeros((bsz, g, r, s_dim, p), dtype=dt, device=x.device)
         if state0 is None else state0.to(dt).reshape(bsz, g, r, s_dim, p))
    ys = []
    for i in range(n):
        xq, lq, bq, cq = xs[:, i], ls[:, i], bs[:, i], cs[:, i]
        lcum = torch.cumsum(lq, dim=1)                     # (B, Q, G, R)
        ltot = lcum[:, -1]                                 # (B, G, R)
        dmat = _decay(lcum)
        att = torch.einsum("bigs,bjgs->bijg", cq, bq)[..., None] * dmat
        y = torch.einsum("bijgr,bjgrp->bigrp", att, xq)
        y = y + torch.exp(lcum)[..., None] * torch.einsum(
            "bigs,bgrsp->bigrp", cq, s)
        w = torch.exp(ltot[:, None] - lcum)                # (B, Q, G, R)
        bw = bq[:, :, :, None, :] * w[..., None]           # (B, Q, G, R, S)
        s = (torch.exp(ltot)[..., None, None] * s
             + torch.einsum("bjgrs,bjgrp->bgrsp", bw, xq))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, n * chunk, h, p)[:, :l]
    return y, s.reshape(bsz, h, s_dim, p)


def _chunks(chunk: int, g: int, *ts):
    """x, loga, b, c (and dy) padded with identity steps to a chunk
    multiple and cut into chunks: (B, N, Q, G, R[, P]) for the per-head
    operands, (B, N, Q, G, S) for b and c, in float32 (float64 operands
    stay float64)."""
    bsz, l, h = ts[0].shape[:3]
    pad = (-l) % chunk
    n = (l + pad) // chunk
    dt = torch.promote_types(ts[0].dtype, torch.float32)
    out = []
    for t in ts:
        if pad:
            t = torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        out.append(t.to(dt))
    xs = out[0].reshape(bsz, n, chunk, g, h // g, -1)
    ls = out[1].reshape(bsz, n, chunk, g, h // g)
    bs = out[2].reshape(bsz, n, chunk, g, -1)
    cs = out[3].reshape(bsz, n, chunk, g, -1)
    rest = [t.reshape(bsz, n, chunk, g, h // g, -1) for t in out[4:]]
    return (xs, ls, bs, cs, *rest)


def _decay(lcum: torch.Tensor) -> torch.Tensor:
    """exp(l_i - l_j) (B, Q, Q, G, R) on the causal triangle j <= i and 0
    above it: the difference is masked with -inf before the exp, so the
    overflowing exp(l_i - l_j), j > i, is never formed."""
    q = lcum.shape[1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=lcum.device))[None, :, :, None, None]
    return torch.exp((lcum[:, :, None] - lcum[:, None, :])
                     .masked_fill(~mask, float("-inf")))



def ssd_chunked_backward(x: torch.Tensor, loga: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                         dstate: torch.Tensor | None, chunk: int,
                         state0: torch.Tensor | None = None):
    """Gradients (dx, dloga, db, dc) of `ssd_chunked`'s (y, state) with
    cotangents dy (B, L, H, P) and dstate (B, H, S, P) (None: zero), in
    explicit chunked formulas (what the backward kernel computes).

    Per (batch, head) and chunk, with l the inclusive prefix sums of log a,
    S_in the chunk's incoming state, G = dL/dS_out (the last chunk's G is
    dstate, chunk c - 1's is dS_in of chunk c), w_j = exp(l_Q - l_j) and
    decay_ij = exp(l_i - l_j) for j <= i, else 0:

        M = (C B^T) . decay,  D = (dY X^T) . decay,  A = M . (dY X^T)
        dX = M^T dY + diag(w) B G
        dB = D^T C + diag(w) X G^T
        dC = D B + diag(exp l) dY S_in^T
        dS_in = exp(l_Q) G + C^T diag(exp l) dY
        dl_i = sum_j A_ij - sum_i' A_i'i + exp(l_i) <dY_i, (C S_in)_i>
               - w_i b_i^T G x_i
        dl_Q += sum_j w_j b_j^T G x_j + exp(l_Q) <S_in, G>

    and d loga is the reverse cumulative sum of dl within each chunk.  db
    and dc of a group sum over the group's heads.  A ragged tail is padded
    with identity steps, as in the forward, and its gradients dropped."""
    bsz, l, h, p = x.shape
    g, s_dim = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    r = h // g
    xs, ls, bs, cs, dys = _chunks(chunk, g, x, loga, b, c, dy)
    n = xs.shape[1]
    dt = xs.dtype
    s = (torch.zeros((bsz, g, r, s_dim, p), dtype=dt, device=x.device)
         if state0 is None else state0.to(dt).reshape(bsz, g, r, s_dim, p))
    # the forward's prefix sums and incoming states, chunk by chunk
    lcums, s_ins = [], []
    for i in range(n):
        lcum = torch.cumsum(ls[:, i], dim=1)               # (B, Q, G, R)
        ltot = lcum[:, -1]
        w = torch.exp(ltot[:, None] - lcum)
        lcums.append(lcum)
        s_ins.append(s)
        s = (torch.exp(ltot)[..., None, None] * s
             + torch.einsum("bjgs,bjgr,bjgrp->bgrsp", bs[:, i], w, xs[:, i]))
    gst = (torch.zeros_like(s) if dstate is None
           else dstate.to(dt).reshape(bsz, g, r, s_dim, p))
    dxs, dls, dbs, dcs = [], [], [], []
    for i in reversed(range(n)):
        xq, bq, cq, dyq = xs[:, i], bs[:, i], cs[:, i], dys[:, i]
        lcum, s_in = lcums[i], s_ins[i]
        ltot = lcum[:, -1]                                 # (B, G, R)
        dec = _decay(lcum)                                 # (B, Q, Q, G, R)
        cbt = torch.einsum("bigs,bjgs->bijg", cq, bq)[..., None]
        dyx = torch.einsum("bigrp,bjgrp->bijgr", dyq, xq)
        m, d = cbt * dec, dyx * dec
        a = m * dyx
        w = torch.exp(ltot[:, None] - lcum)                # (B, Q, G, R)
        el = torch.exp(lcum)
        bg = torch.einsum("bjgs,bgrsp->bjgrp", bq, gst)
        dxs.append(torch.einsum("bijgr,bigrp->bjgrp", m, dyq)
                   + w[..., None] * bg)
        dbs.append((torch.einsum("bijgr,bigs->bjgs", d, cq)
                    + torch.einsum("bjgr,bjgrp,bgrsp->bjgs", w, xq, gst)))
        dcs.append((torch.einsum("bijgr,bjgs->bigs", d, bq)
                    + torch.einsum("bigr,bigrp,bgrsp->bigs", el, dyq, s_in)))
        carry = w * (bg * xq).sum(-1)                      # w_j b_j^T G x_j
        inter = el * (dyq * torch.einsum("bigs,bgrsp->bigrp", cq, s_in)
                      ).sum(-1)
        dl = a.sum(2) - a.sum(1) + inter - carry           # (B, Q, G, R)
        last = carry.sum(1) + torch.exp(ltot) * (s_in * gst).sum((-2, -1))
        dl = torch.cat([dl[:, :-1], dl[:, -1:] + last[:, None]], dim=1)
        dls.append(torch.flip(torch.cumsum(torch.flip(dl, (1,)), 1), (1,)))
        gst = (torch.exp(ltot)[..., None, None] * gst
               + torch.einsum("bigs,bigr,bigrp->bgrsp", cq, el, dyq))
    lp = n * chunk

    def whole(parts, *shape):
        return torch.stack(parts[::-1], dim=1).reshape(bsz, lp, *shape)[:, :l]
    return (whole(dxs, h, p), whole(dls, h), whole(dbs, g, s_dim),
            whole(dcs, g, s_dim))


def split_tf32(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 `a` as the backward kernel splits its operands
    for the tensor cores: hi = cvt.rna.tf32.f32(a), lo = cvt.rna.tf32.f32(a
    - hi), each rounded to TF32 (the 10 leading mantissa bits kept, the
    low 13 zero) to nearest with ties away from zero, by bit arithmetic on
    the sign-magnitude pattern (adding half the dropped unit carries into
    the exponent where it must); infinities and NaNs pass as they are.
    a - hi is exact in float32, and hi + lo is a to about 2^-22."""
    if a.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, not {a.dtype}")

    def rna(v):
        u = v.contiguous().view(torch.int32)
        r = ((u + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(v), r, v)
    hi = rna(a)
    return hi, rna(a - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor,
                  step: int = 8) -> torch.Tensor:
    """a (M, K) @ b (K, N), float32, as the backward kernel's tensor-core
    tiles compute it: both operands split once (`split_tf32`), and per
    `step`-deep slice of K (one m16n8k8 instruction's depth) the three
    products lo.hi, hi.lo, hi.hi, small terms first, each added to a
    float32 accumulator (a TF32 product is exact in float32; each
    instruction is modelled as one float32 rounding of its sum); lo.lo is
    dropped."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], step):
        ks = slice(k0, k0 + step)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = (acc.double() + x[:, ks].double() @ y[ks].double()).float()
    return acc
