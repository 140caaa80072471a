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
    pad = (-l) % chunk
    if pad:
        x, loga, b, c = (torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, loga, b, c))
    n = (l + pad) // chunk
    xs = x.float().reshape(bsz, n, chunk, g, r, p)
    ls = loga.float().reshape(bsz, n, chunk, g, r)
    bs = b.float().reshape(bsz, n, chunk, g, s_dim)
    cs = c.float().reshape(bsz, n, chunk, g, s_dim)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None, None]
    s = (torch.zeros((bsz, g, r, s_dim, p), dtype=torch.float32,
                     device=x.device) if state0 is None
         else state0.float().reshape(bsz, g, r, s_dim, p))
    ys = []
    for i in range(n):
        xq, lq, bq, cq = xs[:, i], ls[:, i], bs[:, i], cs[:, i]
        lcum = torch.cumsum(lq, dim=1)                     # (B, Q, G, R)
        ltot = lcum[:, -1]                                 # (B, G, R)
        # exp(l_i - l_j) on the causal triangle; -inf elsewhere gives 0
        # without forming the overflowing exp(l_i - l_j), j > i
        dmat = torch.exp((lcum[:, :, None] - lcum[:, None, :])
                         .masked_fill(~mask, float("-inf")))
        att = torch.einsum("bigs,bjgs->bijg", cq, bq)[..., None] * dmat
        y = torch.einsum("bijgr,bjgrp->bigrp", att, xq)
        y = y + torch.exp(lcum)[..., None] * torch.einsum(
            "bigs,bgrsp->bigrp", cq, s)
        w = torch.exp(ltot[:, None] - lcum)                # (B, Q, G, R)
        bw = bq[:, :, :, None, :] * w[..., None]           # (B, Q, G, R, S)
        s = (torch.exp(ltot)[..., None, None] * s
             + torch.einsum("bjgrs,bjgrp->bgrsp", bw, xq))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, l + pad, h, p)[:, :l]
    return y, s.reshape(bsz, h, s_dim, p)
