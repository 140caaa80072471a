"""Wrapper of the fused ROSA kernel (port of the reference's
`kernels/rosa_fused/ops.py`), with its plain PyTorch version beside it.

`rosa_fused_matmul` does what a tile cannot do locally, in the order the
composed `rosa.backends` chain fixes:

  * quantization full-scales: global (or per-row) absmax reductions, passed
    as the (M, 3) scale operand `sx = [sxd, sxa, s2]`.  The requantization
    scale s2 of the conditioned activations comes from an elementwise
    pre-pass over x (`ref.condition_x`), outside the kernel;
  * the key split of `_forward` (mgate/ANALOG: (k_w, k_x); static WS: the
    whole key to the weight side; static IS: to the activation side), each
    side's (DAC, thermal) draws split as `mrr.realize_weights` splits them;
  * static variation: per-lane fields broadcast per orientation
    (`mrr.expand_lanes`) and fold with the draws into the three additive
    chain offsets, as stride-0 views when there are no per-shot draws.

`rosa_fused(...)` takes those operands.  On CPU and `meta` tensors it runs
`plain`, the same arithmetic in PyTorch ops; on CUDA tensors it launches
the kernel of `csrc/rosa_fused.cu` or raises.  Static specialization
(`realize_x` / `realize_w`) mirrors `_analog_operand`'s ideal shortcut: a
side with ideal noise, no variation and no gate skips the chain.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import skinny
from repro_torch.core import mrr, osa
from repro_torch.core import quant as Q
from repro_torch.core.constants import ComputeMode, Mapping
from repro_torch.kernels.rosa_fused import ref
from repro_torch.obs import trace as obs

# The tall path of the CUDA kernel (csrc/rosa_fused.cu, M > 16): TALL_BM
# rows and an N tile from N_TILES per block, TALL_BK lanes a step; M <= 16
# takes the decode path (kernels.skinny).
TALL_BM, TALL_BK = 128, 32
N_TILES = (16, 32, 64, 128)
LAUNCHES = kernels.LaunchCounter("rosa_fused")


def _offsets(t: torch.Tensor, key, noise: mrr.NoiseModel,
             var: mrr.StaticVariation | None, act: bool = False):
    """The three additive chain offsets (v_off, t_off, l_off) of one side,
    broadcast to its shape: per-shot draws (as `weight_of_voltage` splits
    `key`; an activation's, `act`, over a train step's global batch) plus
    static variation."""
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    if noise.is_ideal:
        e_dac = e_th = z
    else:
        if key is None:
            raise ValueError("noisy realization requires a key")
        d, th = (mrr.draw_act_eps if act else mrr.draw_eps)(
            key, t.shape, t.device, t.dtype)
        e_dac, e_th = noise.sigma_dac * d, noise.sigma_th * th
    dv, ddt, dlam = ((var.dv, var.ddt, var.dlam) if var is not None
                     else (z, z, z))
    return tuple(torch.broadcast_to(o.to(t.dtype), t.shape)
                 for o in (e_dac + dv, e_th + ddt, dlam))


def rosa_fused_matmul(x: torch.Tensor, w: torch.Tensor, key=None,
                      var: mrr.StaticVariation | None = None, gate=None,
                      mgate=None, **kw) -> torch.Tensor:
    """y = x @ w through the fused analog pipeline; x (M, K), w (K, N).

    Semantics are those of the composed `_forward` with the "ref" backend,
    up to the flip-aware bound: with per-shot noise the kernel adds draws
    and variation as one folded offset, and its contraction sums in another
    order, so a conditioned activation within float noise of a
    requantization boundary may flip one 8-bit code, which moves that row
    by at most one LSB.  Keywords as `operands`.
    """
    args, static = operands(x, w, key, var, gate, mgate, **kw)
    if obs.enabled():
        # once per shape and specialization (the reference's instant fires
        # at trace time): the compile timeline shows ONE kernel where the
        # composed path shows its device ops
        spec = dict(m=x.shape[0], k=x.shape[1], n=w.shape[1],
                    mapping=kw.get("mapping", Mapping.WS).name,
                    mode=kw.get("mode", ComputeMode.MIXED).name,
                    realize_x=static["realize_x"],
                    realize_w=static["realize_w"],
                    gated=static["use_gate"],
                    mapping_gated=static["use_mgate"])
        obs.instant_once(tuple(spec.values()), "kernels.rosa_fused",
                         "compile", **spec)
    return rosa_fused(*args, **static)


def operands(x: torch.Tensor, w: torch.Tensor, key=None,
             var: mrr.StaticVariation | None = None, gate=None, mgate=None,
             *, mapping: Mapping = Mapping.WS,
             mode: ComputeMode = ComputeMode.MIXED, quant_bits: int = 8,
             pam_bits: int = 1, act_per_vector: bool = False,
             noise: mrr.NoiseModel = mrr.IDEAL,
             osa_cfg: osa.OSAConfig = osa.IDEAL_OSA,
             p: mrr.MRRParams = mrr.DEFAULT_PARAMS) -> tuple[tuple, dict]:
    """The kernel's operands and static specialization for x @ w:
    `rosa_fused(*args, **static)` computes `rosa_fused_matmul`."""
    if mode is ComputeMode.DIGITAL:
        raise ValueError("DIGITAL layers take the exact digital path; the "
                         "fused kernel serves MIXED and ANALOG modes")
    x = x.float()
    w = w.float()
    qcfg = Q.QuantConfig(bits=quant_bits)
    analog = mode is ComputeMode.ANALOG
    if analog:
        mgate = None                 # _forward's ANALOG branch ignores it
    use_mgate = mgate is not None
    use_gate = gate is not None

    # -- which sides realize (mirrors _analog_operand's shortcut) --
    can_realize = not (noise.is_ideal and var is None and gate is None)
    w_active = use_mgate or analog or mapping in (Mapping.WS, Mapping.GEMM)
    x_active = use_mgate or analog or not w_active
    realize_w = w_active and can_realize
    realize_x = x_active and can_realize

    k_w, k_x = ref.split_keys(key, both=use_mgate or analog,
                              w_active=w_active)

    # -- scales --
    # the full-scales are the global operands': an activation's spans a
    # train step's batch and, under a K-split product, its columns
    # (Q.act_absmax_scale); a weight's the ranks that split it
    # (Q.weight_absmax_scale)
    sw = Q.weight_absmax_scale(w)
    if analog:
        sxd = sxa = s2 = Q.act_absmax_scale(x)
    else:
        sxd = Q.act_absmax_scale(x, act_per_vector)
        sxa = Q.act_absmax_scale(x, True)
        x_eff_pre = ref.condition_x(
            x, k_x, x_active=realize_x, use_mgate=use_mgate, mgate=mgate,
            gate=gate, var=var, qcfg=qcfg, p=p,
            noise=noise if realize_x else mrr.IDEAL,
            act_per_vector=act_per_vector)
        s2 = Q.act_absmax_scale(x_eff_pre, act_per_vector)

    x_off = _offsets(x, k_x, noise, var, act=True) if realize_x else None
    w_off = (_offsets(w, k_w, noise, mrr.expand_lanes(var, w))
             if realize_w else None)

    # slot jitter needs a key the composed ref path never threads either
    if analog:
        n_planes = 1
        gains = torch.ones(1, device=x.device)
    else:
        n_planes = -(-qcfg.n_planes // pam_bits)
        gains = osa.slot_gains(
            dataclasses.replace(osa_cfg, n_slots=n_planes,
                                pam_bits=pam_bits), None, torch.float32,
            x.device)

    m = x.shape[0]
    sx = torch.cat([s.reshape(-1, 1).expand(m, 1).float()
                    for s in (sxd, sxa, s2)], dim=1).contiguous()
    zero = torch.zeros((), device=x.device)
    gg = torch.stack([
        torch.as_tensor(gate, dtype=torch.float32, device=x.device)
        if use_gate else zero,
        torch.as_tensor(mgate, dtype=torch.float32, device=x.device)
        if use_mgate else zero,
        sw.float()])
    return ((x, w, gains, sx, gg, x_off, w_off),
            dict(analog=analog, n_planes=n_planes, radix_bits=pam_bits,
                 qmax=qcfg.qmax, realize_x=realize_x, realize_w=realize_w,
                 use_gate=use_gate, use_mgate=use_mgate, p=p))


def rosa_fused(x, w, gains, sx, gg, x_off=None, w_off=None, *,
               analog: bool = False, n_planes: int = 7, radix_bits: int = 1,
               qmax: int = 127, realize_x: bool = False,
               realize_w: bool = True, use_gate: bool = False,
               use_mgate: bool = False,
               p: mrr.MRRParams = mrr.DEFAULT_PARAMS) -> torch.Tensor:
    """The kernel's contract on prepared operands (see csrc/rosa_fused.cu):
    the plain version for CPU and meta tensors, the CUDA kernel for CUDA
    tensors."""
    if (x_off is not None) != realize_x or (w_off is not None) != realize_w:
        raise ValueError("offset operands must be present exactly for the "
                         "realized sides")
    kw = dict(analog=analog, n_planes=n_planes, radix_bits=radix_bits,
              qmax=qmax, realize_x=realize_x, realize_w=realize_w,
              use_gate=use_gate, use_mgate=use_mgate, p=p)
    if kernels.runs_plain(x):
        return plain(x, w, gains, sx, gg, x_off, w_off, **kw)
    return launch(x, w, gains, sx, gg, x_off, w_off, **kw)


# ---------------------------------------------------------------------------
# Plain version: the kernel's arithmetic in PyTorch ops
# ---------------------------------------------------------------------------
def plain(x, w, gains, sx, gg, x_off=None, w_off=None, *, analog: bool,
          n_planes: int, radix_bits: int, qmax: int, realize_x: bool,
          realize_w: bool, use_gate: bool, use_mgate: bool,
          p: mrr.MRRParams) -> torch.Tensor:
    """What the kernel computes, tile-free (no padding, so no lane masks).

    Operand conditioning repeats the composed chain op for op: the
    straight-through residue `t + (t_q - t)` of `fake_quant` feeds the
    folded chain (`mrr.realize_offsets`), so a noise-free realization here
    equals `ref.condition_x` / `condition_w` bit for bit.  Weights stay in
    normalized units; the full-scale sw enters at the flush."""
    chain = mrr.chain_constants(p)
    qf = torch.tensor(float(qmax), device=x.device)
    inv_q = 1.0 / qf
    sxd, sxa, s2 = sx[:, 0:1], sx[:, 1:2], sx[:, 2:3]
    gate, mgate, sw = gg[0], gg[1], gg[2]

    ws = w / sw
    wn = torch.clamp(torch.round(ws * qf), -qf, qf) * inv_q
    w_ws = wn
    if realize_w:
        w_an = mrr.realize_offsets(ws + (wn - ws), *w_off, chain)
        w_ws = wn + gate * (w_an - wn) if use_gate else w_an
    w_eff = (1.0 - mgate) * w_ws + mgate * wn if use_mgate else w_ws

    xd = torch.clamp(torch.round(x / sxd * qf), -qf, qf) * (sxd / qf)
    x_dig = x + (xd - x)
    x_is = x_dig
    if realize_x:
        xs = x / sxa
        xq = torch.clamp(torch.round(xs * qf), -qf, qf) * inv_q
        x_an = mrr.realize_offsets(xs + (xq - xs), *x_off, chain) * sxa
        x_is = x_dig + gate * (x_an - x_dig) if use_gate else x_an
    x_eff = (1.0 - mgate) * x_dig + mgate * x_is if use_mgate else x_is

    if analog:
        return (x_eff * (1.0 / s2)) @ w_eff * (s2 * sw)
    q2 = torch.clamp(torch.round(x_eff / s2 * qf), -qf, qf)
    sign = torch.sign(q2)
    mag = q2.abs().to(torch.int32)
    mask = (1 << radix_bits) - 1
    x_rec = torch.zeros_like(q2)
    for t in range(n_planes):
        d = (mag >> (radix_bits * t)) & mask
        x_rec = x_rec + gains[t] * (sign * d.to(q2.dtype))
    return (x_rec @ w_eff) * (s2 * (sw / qf))


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------
_FLAGS = {"analog": 1, "realize_x": 2, "realize_w": 4, "use_gate": 8,
          "use_mgate": 16}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.library("rosa_fused")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp, p64 = ctypes.POINTER(vp), ctypes.POINTER(i64)
    lib.rosa_fused_launch.argtypes = (
        [vp] * 5 + [pp, p64, pp, p64] + [vp] * 3 + [i32] * 9
        + [ctypes.c_float, i32, ctypes.POINTER(ctypes.c_float)] + [i32] * 3
        + [vp])
    lib.rosa_fused_launch.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _chain(p: mrr.MRRParams):
    """The folded chain's 19 float32 constants as a ctypes array."""
    values = mrr.chain_constants(p).values()
    return (ctypes.c_float * len(values))(*values)


def n_tile(n: int) -> int:
    """The tall path's N tile: the smallest of 16, 32, 64, 128 that holds
    N, else 128 (wider N takes several tiles)."""
    return next((t for t in N_TILES if n <= t), N_TILES[-1])


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, *, n_sm: int = 132) -> dict:
    """The launch `launch` makes for an (m, k, n) product: the decode path
    for m <= 16 (`skinny.decode_plan`), else the tall path: grid (row
    tiles of TALL_BM, N tiles), no K split, the weight conditioned once
    into a k x n workspace.  Cached per shape: do not modify the dict."""
    if m <= skinny.MAX_M:
        return skinny.decode_plan(m, k, n, n_sm=n_sm, planes=1)
    t = n_tile(n)
    return {"path": "tall",
            "grid": (skinny.cdiv(m, TALL_BM), skinny.cdiv(n, t), 1),
            "splits": 1, "k_per_split": k, "n_tile": t,
            "smem_bytes": 4 * (TALL_BM * (TALL_BK + 1) + TALL_BK * t),
            "operand_floats": k * n, "part_floats": 0}


def _side(offs, shape, name):
    """(pointer array, stride array) of one side's three offset streams."""
    if offs is None:
        return None, None
    ptrs = (ctypes.c_void_p * 3)()
    strides = (ctypes.c_longlong * 6)()
    for s, o in enumerate(offs):
        if tuple(o.shape) != tuple(shape):
            raise ValueError(f"rosa_fused: {name} offset {s} has shape "
                             f"{tuple(o.shape)}, expected {tuple(shape)}")
        ptrs[s] = o.data_ptr()
        strides[2 * s], strides[2 * s + 1] = o.stride()
    return ptrs, strides


def launch(x, w, gains, sx, gg, x_off=None, w_off=None, *, analog: bool,
           n_planes: int, radix_bits: int, qmax: int, realize_x: bool,
           realize_w: bool, use_gate: bool, use_mgate: bool,
           p: mrr.MRRParams) -> torch.Tensor:
    """Launch csrc/rosa_fused.cu on the current stream; raises on anything
    the kernel does not take or on a refused launch."""
    name = "rosa_fused"
    offs = [o for side in (x_off, w_off) if side is not None for o in side]
    kernels.require_cuda(x, w, gains, sx, gg, *offs, name=name)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.stride(1) != 1 or w.stride(1) != 1:
        raise ValueError(f"{name}: x and w need unit column stride")
    if tuple(sx.shape) != (m, 3) or sx.stride(1) != 1:
        raise ValueError(f"{name}: sx must be ({m}, 3) with unit column "
                         "stride")
    if tuple(gg.shape) != (3,) or not gg.is_contiguous():
        raise ValueError(f"{name}: gg must be a contiguous (3,) tensor")
    if gains.ndim != 1 or gains.shape[0] < n_planes \
            or not gains.is_contiguous():
        raise ValueError(f"{name}: gains must hold {n_planes} values")
    if not 1 <= n_planes <= 8:
        raise ValueError(f"{name}: n_planes={n_planes} outside 1..8")
    xp, xs = _side(x_off, (m, k), "x")
    wp, wst = _side(w_off, (k, n), "w")
    lib = _lib()
    dev = x.device
    pl = plan(m, k, n, n_sm=_n_sm(dev.index))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    operand = torch.empty(pl["operand_floats"], dtype=torch.float32,
                          device=dev)
    part = (torch.empty(pl["part_floats"], dtype=torch.float32, device=dev)
            if pl["part_floats"] else None)
    on = dict(analog=analog, realize_x=realize_x, realize_w=realize_w,
              use_gate=use_gate, use_mgate=use_mgate)
    flags = sum(bit for key, bit in _FLAGS.items() if on[key])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rosa_fused_launch(
            x.data_ptr(), w.data_ptr(), gains.data_ptr(), sx.data_ptr(),
            gg.data_ptr(), xp, xs, wp, wst, out.data_ptr(),
            operand.data_ptr(),
            part.data_ptr() if part is not None else None, m, k, n,
            x.stride(0), w.stride(0), n, sx.stride(0), n_planes, radix_bits,
            float(qmax), flags, _chain(p), pl["splits"], pl["k_per_split"],
            pl["n_tile"], stream)
    kernels.check_launch(rc, name)
    LAUNCHES.add()
    return out


def preflight(m: int, k: int, n: int, *, n_sm: int = 132,
              quant_bits: int = 8, pam_bits: int = 1) -> dict:
    """What `launch` would run for an (m, k, n) GEMM on an H100, without
    launching: the path (decode for m <= 16, else tall), grid (N tiles, K
    splits, 1) on the decode path or (row tiles, N tiles, 1) on the tall
    path, whose row tiles sit on grid x and so never meet the 65535 limit
    of grid y; the K split, the N tile (decode: 128; tall: 16, 32, 64 or
    128 following N), shared memory per block against the 227 KB limit
    (decode: the 6-stage ring, two blocks per SM), the workspaces and the
    fraction of multiply-adds the ragged tile edges waste (rows are never
    padded on the decode path: its kernel is templated on m)."""
    n_planes = -(-Q.QuantConfig(bits=quant_bits).n_planes // pam_bits)
    issues: list[str] = []
    if min(m, k, n) <= 0:
        return {"kernel": "rosa_fused", "grid": (0, 0, 0), "smem_bytes": 0,
                "pad_waste": 0.0,
                "issues": [f"non-positive dimension in m,k,n={m},{k},{n}"]}
    if n_planes > 8:
        issues.append(f"{n_planes} slots exceed the kernel's 8")
    pl = plan(m, k, n, n_sm=n_sm)
    if pl["smem_bytes"] > skinny.SMEM_LIMIT:
        issues.append(f"{pl['smem_bytes']} bytes of shared memory exceed "
                      "227 KB")
    if pl["grid"][1] > skinny.MAX_GRID_Y:
        issues.append(f"grid y {pl['grid'][1]} exceeds 65535")
    rows = m if pl["path"] == "decode" else -(-m // TALL_BM) * TALL_BM
    pad_waste = rows * -(-n // pl["n_tile"]) * pl["n_tile"] / (m * n) - 1.0
    return dict(pl, kernel="rosa_fused", pad_waste=pad_waste, issues=issues)
