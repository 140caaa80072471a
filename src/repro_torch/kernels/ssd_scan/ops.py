"""Wrapper of the SSD scan kernel (port of the reference's
`kernels/ssd_scan/ops.py`), with its plain PyTorch version beside it.

Shapes are model-land: x (B, L, H, P), loga (B, L, H), b and c (B, L, G, S)
with G head groups; the result is (y (B, L, H, P), state (B, H, S, P)).
The reference wrapper repeats b and c to heads, folds (B, H) and pads L to
the chunk multiple before its kernel; the CUDA kernels (`csrc/ssd_scan.cu`)
read b and c by group and mask the ragged tail themselves, so nothing is
copied here.  `plan` is the launch arithmetic of the five chunk-parallel
launches (prefix sums, C B^T per group, chunk states, state passing,
chunk outputs): `launch` runs it and `preflight` reports it.

The backward kernels (same source) take the forward's workspace (prefix
sums, C B^T, every chunk's incoming state) and the cotangents:
`plan_backward` is the arithmetic of their four launches, `launch_backward`
runs them (counted by `LAUNCHES_BWD`), `backward_stages` runs one of
them at a time (to time it) and `preflight_backward` reports them;
`plain_backward` (`ref.ssd_chunked_backward`) is what they compute.

On CPU tensors `ssd_scan` runs the plain version (`ref.ssd_chunked`),
which autograd differentiates op by op.  On CUDA tensors it launches the
kernels or raises: a call that needs gradients goes through `_Scan`, a
`torch.autograd.Function` whose forward keeps the launch's workspace and
whose backward launches the backward kernels; a call under `no_grad` (or
on operands that need none) launches the forward alone and keeps nothing.
There is no plain fallback on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import skinny
from repro_torch.kernels.ssd_scan import ref

QMAX = 128                      # longest chunk the kernels' tiles cover
MT = 256                        # threads of every block
MT_BLOCKS = 2                   # their __launch_bounds__ minimum blocks
KS = 32                         # depth of a staged strip
CT = 32                         # C B^T tile (CT x CT)
BT = 64                         # state and output tiles (BT x BT)
WROWS = 8                       # output rows of a warp (4 a thread)
STAGES = 3                      # strips in flight in a block's ring
SMEM_PER_SM = 233472            # shared memory an SM gives its blocks
MAX_GRID_X = 2**31 - 1
LAUNCH_NAMES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
# shared memory of each launch's block (csrc/ssd_scan.cu)
SMEM = {"ssd_chunk_state": 4 * (STAGES * 2 * KS * (BT + 4) + 2 * QMAX),
        "ssd_state_pass": 0,
        "ssd_chunk_out": 4 * (STAGES * (BT * (KS + 4) + KS * (BT + 4))
                              + QMAX)}
BWD_NAMES = ("ssd_bwd_chunk", "ssd_bwd_state", "ssd_bwd_grads",
             "ssd_bwd_finish")
ALL_STAGES = 15                 # the C launcher's mask of all four
# the backward's contraction launches (3xTF32 tensor-core tiles): STAGES
# ring slots of an A and a B strip (rows padded to KS + 4 or BT + 8: 64 x
# (KS + 4) floats either way), a staged BT x (BT + 8) tile, l
TC_RAW = 2 * BT * (KS + 4)
TC_SMEM = 4 * (STAGES * TC_RAW + BT * (BT + 8) + QMAX)
# dynamic shared memory of each backward launch's block, and the static
# shared memory of the finishing one (dl, the carry's sums, a tree)
SMEM_BWD = {"ssd_bwd_chunk": TC_SMEM, "ssd_bwd_state": 0,
            "ssd_bwd_grads": TC_SMEM, "ssd_bwd_finish": 0}
SMEM_STATIC_BWD = {"ssd_bwd_finish": 4 * (2 * QMAX + MT)}
LAUNCHES = kernels.LaunchCounter("ssd_scan")
LAUNCHES_BWD = kernels.LaunchCounter("ssd_scan_bwd")
plain = ref.ssd_chunked         # what the kernel computes, in PyTorch ops
plain_backward = ref.ssd_chunked_backward     # and its backward


def ssd_scan(x: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128):
    """x: (B, L, H, P); loga: (B, L, H); b, c: (B, L, G, S), G dividing H
    (heads within a group share B/C, Mamba-2's GVA).

    Returns (y: (B, L, H, P), state: (B, H, S, P))."""
    if x.device.type == "cpu":
        return plain(x, loga, b, c, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, loga, b, c)):
        return _Scan.apply(x, loga, b, c, chunk)
    return launch(x, loga, b, c, chunk)


class _Scan(torch.autograd.Function):
    """The forward launches; the backward launches the backward kernels on
    the forward's operands and workspace (kept, not recomputed: under
    recomputation the block's forward has just run again).  The final
    state's cotangent may be None (training reads y only)."""

    @staticmethod
    def forward(ctx, x, loga, b, c, chunk):
        y, state, ws = _launch(x, loga, b, c, chunk)
        ctx.save_for_backward(x, b, c, ws)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, b, c, ws = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = launch_backward(x, b, c, dy.contiguous(), dstate, ws,
                                ctx.chunk)
        return (*grads, None)


def _chunk_kinds(l: int, chunk: int):
    """(valid steps, chunks, chunks with an incoming state) of a length-l
    sequence: the full chunks, then the ragged tail."""
    full, tail = divmod(l, chunk)
    kinds = [(chunk, full, full - 1)] if full else []
    return kinds + ([(tail, 1, int(full > 0))] if tail else [])


def _executed_flops(bsz, l, h, p, g, s_dim, chunk, tiles) -> int:
    """Float32 operations the three launches execute (an FMA counts 2, an
    exp or a multiply 1), zero-filled tile edges included; output tiles
    whose rows all lie past a ragged tail exit at once."""
    _, ns, n_p, _ = tiles
    nc = skinny.cdiv(l, chunk)
    s_k = skinny.cdiv(s_dim, KS) * KS
    flops = bsz * h * s_dim * p * nc * 3                         # state pass
    for nv, count, inter in _chunk_kinds(l, chunk):
        t = skinny.cdiv(nv, CT)
        flops += bsz * g * count * t * (t + 1) // 2 * CT * CT * s_k * 2
        strips = skinny.cdiv(nv, KS)
        # chunk state: the tile's FMAs, B . w in place, the prefix sums, w
        per = ns * n_p * (strips * KS * (BT * BT * 2 + BT) + 2 * QMAX)
        rows = skinny.cdiv(nv, BT)
        for i0 in range(0, rows * BT, BT):
            n = skinny.cdiv(min(nv, i0 + BT), KS)
            # output: decayed C B^T (mask 3 a value); its strips against
            # X, each warp to the multiple of 4 past its last row; the store
            fma = sum(WROWS * BT * 2 * min(KS, -(-max(i0 + w + WROWS - j0, 0)
                                                // 4) * 4)
                      for j0 in range(0, n * KS, KS)
                      for w in range(0, BT, WROWS))
            per += n_p * (n * KS * BT * 3 + fma + BT * BT * 2 + BT)
        flops += bsz * h * count * per
        flops += bsz * h * inter * rows * n_p * s_k * BT * BT * 2   # C S_in
    return flops


@functools.lru_cache(maxsize=256)
def plan(bsz: int, l: int, h: int, p: int, g: int, s_dim: int,
         chunk: int = 128) -> dict:
    """The three launches of one scan: grid (x, y) and block of each, its
    shared memory, the resident blocks per SM its launch bounds and shared
    memory guarantee (at least), the workspace (prefix sums (B, H, NC, Q),
    C B^T (B, G, NC, Q, Q), chunk states (B, H, NC, S, P), float32) and the
    float32 operations executed.  The first launch's grid holds the C B^T
    tiles' blocks (`cbt_blocks`) after the chunk states'.  Chunks, heads
    and tiles sit on grid x, the batch on grid y.  Cached per shape: do
    not modify the dict."""
    nc = skinny.cdiv(l, chunk)
    tq = skinny.cdiv(chunk, CT)
    tiles = (tq * (tq + 1) // 2, skinny.cdiv(s_dim, BT), skinny.cdiv(p, BT),
             skinny.cdiv(chunk, BT))
    tri, ns, n_p, nm = tiles
    # the state pass takes 4 elements a thread when S P allows
    per = 4 if s_dim * p % 4 == 0 else 1
    gx = {"ssd_chunk_state": ns * n_p * nc * h + tri * nc * g,
          "ssd_state_pass": skinny.cdiv(h * s_dim * p, MT * per),
          "ssd_chunk_out": n_p * nc * h * nm}
    launches = [{"name": name, "grid": (gx[name], bsz, 1), "block": MT,
                 "smem_bytes": SMEM[name],
                 "blocks_per_sm": min(2048 // MT, MT_BLOCKS,
                                      SMEM_PER_SM // (SMEM[name] + 1024))}
                for name in LAUNCH_NAMES]
    ws = {"l": bsz * h * nc * chunk, "cbt": bsz * g * nc * chunk * chunk,
          "states": bsz * h * nc * s_dim * p}
    # the workspace's parts start at multiples of 4 floats (16 bytes)
    o_cbt = skinny.pad4(ws["l"])
    o_st = o_cbt + skinny.pad4(ws["cbt"])
    args = (ctypes.c_int * 8)(nc, *tiles, *(gx[n] for n in LAUNCH_NAMES))
    return {"n_chunks": nc, "tiles": tiles, "launches": launches,
            "cbt_blocks": tri * nc * g,
            "smem_bytes": max(SMEM.values()),
            "workspace_floats": ws,
            "workspace_bytes": 4 * sum(ws.values()),
            "flops": _executed_flops(bsz, l, h, p, g, s_dim, chunk, tiles),
            "offsets": (o_cbt, o_st, o_st + ws["states"]),
            "fits": bsz <= skinny.MAX_GRID_Y
            and all(x <= MAX_GRID_X for x in gx.values()),
            "c_args": args}


def preflight(bsz: int, l: int, h: int, p: int, s_dim: int, *,
              chunk: int = 128, groups: int = 1) -> dict:
    """What `launch` would run for a scan on an H100, without launching
    (the reference's `preflight`, for the CUDA kernels): the launches'
    grids, shared memory per block against the 227 KB limit, resident
    blocks per SM, the workspace, and `pad_waste`, the fraction of steps
    computed past L (the ragged tail is masked in the kernels, never
    copied, but its chunk is computed whole)."""
    issues: list[str] = []
    if min(bsz, l, h, p, s_dim, chunk, groups) <= 0:
        issues.append(f"non-positive dimension in B,L,H,P,S,chunk,G="
                      f"{bsz},{l},{h},{p},{s_dim},{chunk},{groups}")
        return {"kernel": "ssd_scan", "launches": [], "smem_bytes": 0,
                "workspace_bytes": 0, "pad_waste": 0.0, "issues": issues}
    if chunk > QMAX:
        issues.append(f"chunk={chunk} exceeds the kernels' {QMAX}")
    if h % groups:
        issues.append(f"{groups} groups do not divide {h} heads")
    if bsz > skinny.MAX_GRID_Y:
        issues.append(f"batch {bsz} exceeds grid y's 65535")
    if max(h * p, groups * s_dim) * QMAX >= 2**31 or h * s_dim * p >= 2**31:
        issues.append("a block's 32-bit offsets overflow at these widths")
    pl = plan(bsz, l, h, p, groups, s_dim, chunk)
    for ln in pl["launches"]:
        if ln["grid"][0] > MAX_GRID_X:
            issues.append(f"{ln['name']}: grid x {ln['grid'][0]} exceeds "
                          "2^31 - 1")
        if ln["smem_bytes"] > skinny.SMEM_LIMIT:
            issues.append(f"{ln['name']}: {ln['smem_bytes']} bytes of "
                          "shared memory exceed 227 KB")
    lp = pl["n_chunks"] * chunk
    out = {k: v for k, v in pl.items() if k != "c_args"}
    return dict(out, kernel="ssd_scan", pad_waste=lp / l - 1.0,
                issues=issues)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.library("ssd_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = (
        [vp] * 9 + [i32] * 7 + [ctypes.POINTER(i32), i32, vp])
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_occupancy.argtypes = [i32]
    lib.ssd_scan_occupancy.restype = i32
    lib.ssd_scan_backward_launch.argtypes = (
        [vp] * 12 + [ctypes.POINTER(vp)] + [i32] * 7
        + [ctypes.POINTER(i32), i32, i32, vp])
    lib.ssd_scan_backward_launch.restype = i32
    lib.ssd_scan_backward_smem_bytes.argtypes = [i32]
    lib.ssd_scan_backward_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_backward_occupancy.argtypes = [i32]
    lib.ssd_scan_backward_occupancy.restype = i32
    return lib


def occupancy() -> dict:
    """Resident blocks per SM of each launch on the current card, as the
    CUDA runtime reports them for the built kernels."""
    lib = _lib()
    return {name: lib.ssd_scan_occupancy(i)
            for i, name in enumerate(LAUNCH_NAMES)}


def occupancy_backward() -> dict:
    """`occupancy` of the four backward launches."""
    lib = _lib()
    return {name: lib.ssd_scan_backward_occupancy(i)
            for i, name in enumerate(BWD_NAMES)}


def launch(x: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, chunk: int = 128):
    """Launch csrc/ssd_scan.cu on the current stream; raises on anything
    the kernels do not take or on a refused launch."""
    return _launch(x, loga, b, c, chunk)[:2]


def _launch(x, loga, b, c, chunk):
    """`launch`, also returning its workspace (the backward's input)."""
    name = "ssd_scan"
    kernels.require_cuda(x, loga, b, c, name=name)
    if x.ndim != 4 or loga.ndim != 3 or b.ndim != 4 or c.ndim != 4:
        raise ValueError(f"{name}: expected x (B, L, H, P), loga (B, L, H), "
                         "b and c (B, L, G, S)")
    bsz, l, h, p = x.shape
    g, s_dim = b.shape[2], b.shape[3]
    if loga.shape != (bsz, l, h) or b.shape != c.shape \
            or b.shape[:2] != (bsz, l):
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, "
                         f"loga {tuple(loga.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    if h % g:
        raise ValueError(f"{name}: {g} groups do not divide {h} heads")
    if not 1 <= chunk <= QMAX:
        raise ValueError(f"{name}: chunk={chunk} outside 1..{QMAX}")
    if not (x.is_contiguous() and loga.is_contiguous()
            and b.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    pl = plan(bsz, l, h, p, g, s_dim, chunk)
    if not pl["fits"]:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the grid "
                         "limits (see preflight)")
    lib = _lib()
    y = torch.empty_like(x)
    state = x.new_empty((bsz, h, s_dim, p))
    o_cbt, o_st, n_ws = pl["offsets"]
    ws = x.new_empty(n_ws)
    ptrs = (x.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), state.data_ptr(), ws.data_ptr())
    vec = (int(p % 4 == 0 and (ptrs[0] | ptrs[4]) % 16 == 0)
           | int(s_dim % 4 == 0 and (ptrs[2] | ptrs[3]) % 16 == 0) << 1
           | int(chunk % 4 == 0) << 2)
    args = (*ptrs, ptrs[6] + 4 * o_cbt, ptrs[6] + 4 * o_st, bsz, l, h, p, g,
            s_dim, chunk, pl["c_args"], vec)
    if x.get_device() == torch.cuda.current_device():
        rc = lib.ssd_scan_launch(*args, kernels.stream_of(x))
    else:
        with torch.cuda.device(x.device):
            rc = lib.ssd_scan_launch(*args, kernels.stream_of(x))
    kernels.check_launch(rc, name)
    LAUNCHES.add()
    return y, state, ws


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def plan_backward(bsz: int, l: int, h: int, p: int, g: int, s_dim: int,
                  chunk: int = 128) -> dict:
    """The four launches of one scan's backward: grid (x, y) and block of
    each, its dynamic shared memory, the resident blocks per SM it is
    guaranteed (at least), and the workspace in floats: G (B, H, NC, S,
    P), D (B, H, NC, Q, Q), A's row and column sums (B, H, NC, TQ, Q)
    each (TQ: the chunk's 32-row tiles), the dot products of the incoming
    state and of the carry (B, H, NC, NS, Q) and (B, H, NC, NP, Q), and,
    when heads share a group, each head's dB and dC (B, L, H, S).  The
    first launch's D blocks take BT x BT tiles of the causal triangle
    (`tiles[0]` of them a chunk and head).  A launch's `smem_bytes`
    counts its static shared memory too.  Chunks, heads and tiles sit on
    grid x, the batch on grid y.  Cached per shape: do not modify the
    dict."""
    nc = skinny.cdiv(l, chunk)
    tq = skinny.cdiv(chunk, CT)
    nm = skinny.cdiv(chunk, BT)
    tri, ns, n_p = (nm * (nm + 1) // 2, skinny.cdiv(s_dim, BT),
                    skinny.cdiv(p, BT))
    per = 4 if s_dim * p % 4 == 0 else 1
    gx = {"ssd_bwd_chunk": (ns * n_p + tri) * nc * h,
          "ssd_bwd_state": skinny.cdiv(h * s_dim * p, MT * per),
          "ssd_bwd_grads": (n_p + 2 * ns) * nm * nc * h,
          "ssd_bwd_finish": nc * h + (skinny.cdiv(l * g * s_dim, MT)
                                      if g != h else 0)}
    launches = []
    for name in BWD_NAMES:
        smem = SMEM_BWD[name] + SMEM_STATIC_BWD.get(name, 0)
        launches.append({"name": name, "grid": (gx[name], bsz, 1),
                         "block": MT, "smem_bytes": smem,
                         "blocks_per_sm": min(2048 // MT, MT_BLOCKS,
                                              SMEM_PER_SM // (smem + 1024))})
    bhn = bsz * h * nc
    ws = {"g": bhn * s_dim * p, "d": bhn * chunk * chunk,
          "prow": bhn * tq * chunk, "pcol": bhn * tq * chunk,
          "pint": bhn * ns * chunk, "pcar": bhn * n_p * chunk,
          "pdb": bsz * l * h * s_dim if g != h else 0,
          "pdc": bsz * l * h * s_dim if g != h else 0}
    offsets, at = [], 0
    for n in ws.values():       # each part at a multiple of 4 floats
        offsets.append(at)
        at += skinny.pad4(n)
    args = (ctypes.c_int * 10)(nc, tri, ns, n_p, nm, tq,
                               *(gx[n] for n in BWD_NAMES))
    return {"n_chunks": nc, "tiles": (tri, ns, n_p, nm, tq),
            "launches": launches, "smem_bytes": max(SMEM_BWD.values()),
            "workspace_floats": ws, "workspace_bytes": 4 * sum(ws.values()),
            "offsets": tuple(offsets), "n_floats": at,
            "fits": bsz <= skinny.MAX_GRID_Y
            and all(x <= MAX_GRID_X for x in gx.values()),
            "c_args": args}


def preflight_backward(bsz: int, l: int, h: int, p: int, s_dim: int, *,
                       chunk: int = 128, groups: int = 1) -> dict:
    """What `launch_backward` would run for a scan's backward on an H100,
    without launching: `preflight`'s report for the four backward
    launches (their grids, shared memory per block against the 227 KB
    limit, resident blocks per SM and workspace)."""
    issues: list[str] = []
    if min(bsz, l, h, p, s_dim, chunk, groups) <= 0:
        issues.append(f"non-positive dimension in B,L,H,P,S,chunk,G="
                      f"{bsz},{l},{h},{p},{s_dim},{chunk},{groups}")
        return {"kernel": "ssd_scan_bwd", "launches": [], "smem_bytes": 0,
                "workspace_bytes": 0, "issues": issues}
    fwd = preflight(bsz, l, h, p, s_dim, chunk=chunk, groups=groups)
    issues += fwd["issues"]
    pl = plan_backward(bsz, l, h, p, groups, s_dim, chunk)
    for ln in pl["launches"]:
        if ln["grid"][0] > MAX_GRID_X:
            issues.append(f"{ln['name']}: grid x {ln['grid'][0]} exceeds "
                          "2^31 - 1")
        if ln["smem_bytes"] > skinny.SMEM_LIMIT:
            issues.append(f"{ln['name']}: {ln['smem_bytes']} bytes of "
                          "shared memory exceed 227 KB")
    out = {k: v for k, v in pl.items() if k != "c_args"}
    return dict(out, kernel="ssd_scan_bwd", issues=issues)


def launch_backward(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dy: torch.Tensor, dstate: torch.Tensor | None,
                    ws: torch.Tensor, chunk: int = 128):
    """Launch the backward kernels of csrc/ssd_scan.cu on the current
    stream after `_launch(x, loga, b, c, chunk)` returned workspace `ws`:
    (dx, dloga, db, dc) for cotangents dy (B, L, H, P) and dstate (B, H,
    S, P) or None (zero).  Raises on anything the kernels do not take or
    on a refused launch."""
    run, grads = _backward_call(x, b, c, dy, dstate, ws, chunk)
    run(ALL_STAGES)
    LAUNCHES_BWD.add()
    return grads


def backward_stages(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dy: torch.Tensor, dstate: torch.Tensor | None,
                    ws: torch.Tensor, chunk: int = 128):
    """A timing entry: `launch_backward`'s checks and buffers, returned as
    `run(which)`, which launches the backward's launch `which` (0..3, in
    `BWD_NAMES` order) alone on them, and the gradients it writes.  Call
    `run(None)` (the four launches) first, so that each launch finds the
    workspace its predecessors fill.  Not counted in `LAUNCHES_BWD`: a
    launch alone is no backward."""
    run, grads = _backward_call(x, b, c, dy, dstate, ws, chunk)
    return (lambda which: run(ALL_STAGES if which is None else 1 << which),
            grads)


def _backward_call(x, b, c, dy, dstate, ws, chunk):
    """`launch_backward`'s checks and allocations: (run(stages), (dx,
    dloga, db, dc)), run launching the masked launches on them."""
    name = "ssd_scan_bwd"
    kernels.require_cuda(x, b, c, dy, ws, name=name)
    bsz, l, h, p = x.shape
    g, s_dim = b.shape[2], b.shape[3]
    if dy.shape != x.shape or b.shape != c.shape \
            or b.shape[:2] != (bsz, l) or h % g:
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    if not 1 <= chunk <= QMAX:
        raise ValueError(f"{name}: chunk={chunk} outside 1..{QMAX}")
    pl = plan(bsz, l, h, p, g, s_dim, chunk)
    if ws.numel() != pl["offsets"][2]:
        raise ValueError(f"{name}: workspace of {ws.numel()} floats is not "
                         "this scan's forward's")
    if dstate is not None:
        kernels.require_cuda(dstate, name=name)
        if dstate.shape != (bsz, h, s_dim, p):
            raise ValueError(f"{name}: dstate {tuple(dstate.shape)} is not "
                             f"{(bsz, h, s_dim, p)}")
        if not dstate.is_contiguous() or dstate.data_ptr() % 16:
            dstate = dstate.clone()
    if not all(t.is_contiguous() for t in (x, b, c, dy)):
        raise ValueError(f"{name}: operands must be contiguous")
    pb = plan_backward(bsz, l, h, p, g, s_dim, chunk)
    if not pb["fits"]:
        raise ValueError(f"{name}: {tuple(x.shape)} exceeds the grid "
                         "limits (see preflight_backward)")
    lib = _lib()
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    dloga = x.new_empty((bsz, l, h))
    bws = x.new_empty(pb["n_floats"])
    base = bws.data_ptr()
    parts = [base + 4 * o if n else None
             for o, n in zip(pb["offsets"], pb["workspace_floats"].values())]
    wsp = (ctypes.c_void_p * 8)(*parts)
    o_cbt, o_st, _ = pl["offsets"]
    ptrs = (x.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr())
    vec = (int(p % 4 == 0 and (ptrs[0] | ptrs[3]) % 16 == 0)
           | int(s_dim % 4 == 0 and (ptrs[1] | ptrs[2]) % 16 == 0) << 1
           | int(chunk % 4 == 0) << 2 | int(p % 4 == 0) << 3)
    w0 = ws.data_ptr()
    args = (*ptrs, None if dstate is None else dstate.data_ptr(), w0,
            w0 + 4 * o_cbt, w0 + 4 * o_st, dx.data_ptr(), dloga.data_ptr(),
            db.data_ptr(), dc.data_ptr(), wsp, bsz, l, h, p, g, s_dim, chunk,
            pb["c_args"], vec)

    def run(stages, _held=(bws, dstate)):   # the buffers live with run
        with torch.cuda.device(x.device):
            rc = lib.ssd_scan_backward_launch(*args, stages,
                                              kernels.stream_of(x))
        kernels.check_launch(rc, name)
    return run, (dx, dloga, db, dc)
