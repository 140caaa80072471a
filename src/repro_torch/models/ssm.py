"""Mamba-2 block (state-space duality, arXiv:2405.21060): whole-sequence
forward and single-token decode (PyTorch port of `repro.models.ssm`).

Projections are separate weights (w_x, w_z, w_b, w_c, w_dt), as in the
reference.  The sequence mix is the SSD recurrence per head h (state
S x head dim P):

    H_t = a_t * H_{t-1} + dt_t * B_t x_t^T ,   y_t = C_t H_t + D x_t
    a_t = exp(-exp(A_log) * dt_t),  dt_t = softplus(dt_raw + dt_bias)

The whole-sequence scan goes through `kernels.ssd_scan.ops.ssd_scan`: the
CUDA kernel for CUDA tensors, its plain chunked version for CPU tensors.
When its operands need gradients (training on the card) the kernel runs
inside an autograd Function whose backward is the scan's backward kernel.
B/C are shared across the heads of `n_groups` groups and are passed to the
scan per group, not repeated to heads.  A causal depthwise conv (width 4)
precedes the scan on x/B/C; the output gate is RMSNorm(y * silu(z)), then
the out projection.  The decode step is plain PyTorch (the reference has
no kernel for it).

As in the reference's code, the five projections are plain contractions:
nothing in this block routes through the optical engine.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: F401
from repro_torch.models.layers import rmsnorm
from repro_torch.models.module import ParamDef


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_def(cfg: SSMConfig) -> dict:
    d, h, p_, g, s = (cfg.d_model, cfg.n_heads, cfg.head_dim,
                      cfg.n_groups, cfg.d_state)
    return {
        "w_x": ParamDef((d, h, p_), ("embed", "heads", "head_dim")),
        "w_z": ParamDef((d, h, p_), ("embed", "heads", "head_dim")),
        "w_b": ParamDef((d, g, s), ("embed", None, "state")),
        "w_c": ParamDef((d, g, s), ("embed", None, "state")),
        "w_dt": ParamDef((d, h), ("embed", "heads")),
        "dt_bias": ParamDef((h,), ("heads",), "zeros"),
        "a_log": ParamDef((h,), ("heads",), "zeros"),
        "d_skip": ParamDef((h,), ("heads",), "ones"),
        "conv_x": ParamDef((cfg.d_conv, h, p_), (None, "heads", "head_dim"),
                           scale=0.5),
        "conv_b": ParamDef((cfg.d_conv, g, s), (None, None, "state"),
                           scale=0.5),
        "conv_c": ParamDef((cfg.d_conv, g, s), (None, None, "state"),
                           scale=0.5),
        "gate_norm": ParamDef((h, p_), ("heads", "head_dim"), "ones"),
        "w_out": ParamDef((h, p_, d), ("heads", "head_dim", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1. x: (B, L, ...); w: (K, ...)."""
    k, l = w.shape[0], x.shape[1]
    out = x * w[k - 1]
    for i in range(1, k):
        shifted = torch.zeros_like(x)
        if i < l:
            shifted[:, i:] = x[:, :l - i]
        out = out + shifted * w[k - 1 - i]
    return F.silu(out)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + e^v) as the reference's `jax.nn.softplus` (logaddexp)."""
    return torch.logaddexp(v, torch.zeros_like(v))


def _decay(p: dict, dt_raw: torch.Tensor):
    """dt_raw: (..., H) -> (dt, loga) both (..., H)."""
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    loga = -torch.exp(p["a_log"]) * dt
    return dt, loga


def _gate_out(p: dict, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    """D skip, silu(z) gate, RMSNorm over (H, P) and the out projection.
    y, x, z: (..., H, P) -> (..., D)."""
    y = y + p["d_skip"][:, None] * x.float()
    y = y.to(dtype) * F.silu(z)
    y = rmsnorm(p["gate_norm"].reshape(-1), y.reshape(*y.shape[:-2], -1)
                ).reshape(y.shape)
    return torch.einsum("...hp,hpd->...d", y, p["w_out"])


def ssm_forward(p: dict, cfg: SSMConfig, u: torch.Tensor):
    """Whole-sequence block u (B, L, D) -> (out (B, L, D), final state
    (B, H, S, P), pre-conv (x, b, c) for the decode cache)."""
    x_pre = torch.einsum("bld,dhp->blhp", u, p["w_x"])
    b_pre = torch.einsum("bld,dgs->blgs", u, p["w_b"])
    c_pre = torch.einsum("bld,dgs->blgs", u, p["w_c"])
    x = _causal_conv(x_pre, p["conv_x"])
    b = _causal_conv(b_pre, p["conv_b"])
    c = _causal_conv(c_pre, p["conv_c"])
    z = torch.einsum("bld,dhp->blhp", u, p["w_z"])
    dt, loga = _decay(p, torch.einsum("bld,dh->blh", u, p["w_dt"]))
    y, state = ssd_scan((x.float() * dt[..., None]).contiguous(),
                        loga.contiguous(), b.float().contiguous(),
                        c.float().contiguous(), cfg.chunk)
    return _gate_out(p, y, x, z, u.dtype), state, (x_pre, b_pre, c_pre)


def ssm_apply(p: dict, cfg: SSMConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba-2 block. u: (B, L, D) -> (B, L, D)."""
    return ssm_forward(p, cfg, u)[0]


# ---------------------------------------------------------------------------
# Decode (single token, carried state)
# ---------------------------------------------------------------------------
def ssm_cache_def(cfg: SSMConfig, batch: int, dtype=torch.float32,
                  device=None) -> dict:
    k = cfg.d_conv - 1
    z = lambda *shape: torch.zeros((batch, *shape), dtype=dtype,
                                   device=device)
    return {"conv_x": z(k, cfg.n_heads, cfg.head_dim),
            "conv_b": z(k, cfg.n_groups, cfg.d_state),
            "conv_c": z(k, cfg.n_groups, cfg.d_state),
            "state": z(cfg.n_heads, cfg.d_state, cfg.head_dim)}


def _conv_step(cache: torch.Tensor, xt: torch.Tensor, w: torch.Tensor):
    """cache: (B, K-1, ...) past inputs; xt: (B, ...) new -> (y, cache).
    Mixed dtypes (a float32 cache, bfloat16 weights) promote, as jnp's
    einsum does."""
    hist = torch.cat([cache, xt[:, None]], dim=1)             # (B, K, ...)
    dt = torch.promote_types(hist.dtype, w.dtype)
    y = torch.einsum("bk...,k...->b...", hist.to(dt), w.to(dt))
    return F.silu(y), hist[:, 1:]


def ssm_decode(p: dict, cfg: SSMConfig, u: torch.Tensor, cache: dict):
    """u: (B, 1, D); cache from ssm_cache_def.  Returns (y (B, 1, D), new
    cache); the given cache is not modified."""
    rep = cfg.n_heads // cfg.n_groups
    ut = u[:, 0]
    x_in = torch.einsum("bd,dhp->bhp", ut, p["w_x"])
    b_in = torch.einsum("bd,dgs->bgs", ut, p["w_b"])
    c_in = torch.einsum("bd,dgs->bgs", ut, p["w_c"])
    z = torch.einsum("bd,dhp->bhp", ut, p["w_z"])
    dt, loga = _decay(p, torch.einsum("bd,dh->bh", ut, p["w_dt"]))

    x, cx = _conv_step(cache["conv_x"], x_in, p["conv_x"])
    b, cb = _conv_step(cache["conv_b"], b_in, p["conv_b"])
    c, cc = _conv_step(cache["conv_c"], c_in, p["conv_c"])

    b = torch.repeat_interleave(b, rep, dim=1).float()         # (B, H, S)
    c = torch.repeat_interleave(c, rep, dim=1).float()
    a = torch.exp(loga)                                        # (B, H)
    x32 = x.float() * dt[..., None]
    s = (a[:, :, None, None] * cache["state"]
         + torch.einsum("bhs,bhp->bhsp", b, x32))
    y = torch.einsum("bhs,bhsp->bhp", c, s)
    out = _gate_out(p, y, x, z, u.dtype)[:, None]
    return out, {"conv_x": cx, "conv_b": cb, "conv_c": cc, "state": s}
