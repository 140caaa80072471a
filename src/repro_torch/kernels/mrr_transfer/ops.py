"""Wrapper of the MRR transfer kernel (port of the reference's
`kernels/mrr_transfer/ops.py`), with its plain PyTorch version beside it.

`mrr_transfer(w, key, sigma_dac, sigma_th, p, var=None, eps=None)` realizes
target weights of any shape on the noisy MRR chain.  The (DAC, thermal)
N(0, 1) draws come from `eps` or from `key`, split as `mrr.draw_eps` (and
so `core.mrr.realize_weights`) splits it: the kernel and the plain chain
consume the same draws from the same key.  The reference wrapper pads the
weights to an (8, 128)-tiled sheet for its TPU kernel and draws its noise
on that sheet; the CUDA kernel (`csrc/mrr_transfer.cu`) takes the weights'
own buffer, as one stream without a chip and in 2-D tiles of its (rows,
cols) view with one (`plan`), and masks the ragged edges, so nothing is
padded or copied here.  A chip's per-lane fields go to it as the lane
vectors themselves, with the axis they run along.

On CPU tensors `mrr_transfer` runs `plain` (`ref.mrr_transfer_ref`), which
autograd differentiates op by op, as JAX differentiates the reference's
chain; on CUDA tensors it launches the kernel or raises.  The CUDA path is
a `torch.autograd.Function` whose backward launches the backward kernel
(`launch_backward`, counted by `LAUNCHES_BWD`; its plain version is
`plain_grad`, `ref.mrr_transfer_grad_ref`), or raises: there is no plain
fallback on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import kernels
from repro_torch.core import mrr
from repro_torch.kernels.mrr_transfer import ref

THREADS = 256            # threads per block of csrc/mrr_transfer.cu
PER_MAX = 8              # segments or rows a thread takes, at most
BLOCKS_PER_SM = 8        # blocks per SM the plan aims at
MAX_GRID_Y = 65535
LAUNCHES = kernels.LaunchCounter("mrr_transfer")
LAUNCHES_BWD = kernels.LaunchCounter("mrr_transfer_bwd")
plain = ref.mrr_transfer_ref    # what the kernel computes, in PyTorch ops
plain_grad = ref.mrr_transfer_grad_ref    # and its backward


def mrr_transfer(w: torch.Tensor, key: torch.Generator | None = None,
                 sigma_dac: float = 0.02, sigma_th: float = 0.04,
                 p: mrr.MRRParams = mrr.DEFAULT_PARAMS,
                 var: mrr.StaticVariation | None = None,
                 eps: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """Noisy MRR realization of target weights `w`, any shape.

    With a non-zero sigma the draws are `eps` or, without it, drawn from
    `key` on `w`'s device; `var` (a chip's static variation) broadcasts
    against `w`.  Returns the realized weights, `w`'s shape."""
    noise = mrr.NoiseModel(sigma_dac, sigma_th)
    if noise.is_ideal:
        eps = None
    elif eps is None:
        if key is None:
            raise ValueError("noisy realization requires a key or injected "
                             "draws")
        eps = mrr.draw_eps(key, w.shape, w.device, w.dtype)
    e_dac, e_th = eps if eps is not None else (None, None)
    if w.device.type == "cpu":
        return plain(w, e_dac, e_th, sigma_dac, sigma_th, p, var)
    return _Transfer.apply(w, e_dac, e_th, sigma_dac, sigma_th, p, var)


class _Transfer(torch.autograd.Function):
    """The kernel launch; the backward launches the backward kernel, which
    recomputes the chain from the forward's operands (nothing else is
    saved).  Gradients flow to `w` only: the draws and the chip's fields
    are constants, as in the reference."""

    @staticmethod
    def forward(ctx, w, e_dac, e_th, sigma_dac, sigma_th, p, var):
        ctx.save_for_backward(w, e_dac, e_th)
        ctx.chain = (sigma_dac, sigma_th, p, var)
        return launch(w, e_dac, e_th, sigma_dac, sigma_th, p, var)

    @staticmethod
    def backward(ctx, g):
        w, e_dac, e_th = ctx.saved_tensors
        dq = launch_backward(g.contiguous(), w, e_dac, e_th, *ctx.chain)
        return dq, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------
VAR_NONE, VAR_ROW, VAR_COL, VAR_ANY = range(4)    # layouts of the fields
MAX_COLS = 2**31 - 129          # a row's 32-bit column index, tile included


class _Fields(ctypes.Structure):
    """struct Fields of csrc/mrr_transfer.cu: dv, ddt, dlam, element
    (r, c) at p[r * s0 + c * s1]."""
    _fields_ = [("p", ctypes.c_void_p * 3), ("s0", ctypes.c_longlong * 3),
                ("s1", ctypes.c_longlong * 3)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kernels.library("mrr_transfer")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mrr_transfer_launch.argtypes = [
        vp, vp, vp, ctypes.POINTER(_Fields), i32, vp, i64, i32,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float), i32,
        i32, i32, i32, vp]
    lib.mrr_transfer_launch.restype = i32
    lib.mrr_transfer_backward_launch.argtypes = [
        vp, *lib.mrr_transfer_launch.argtypes]
    lib.mrr_transfer_backward_launch.restype = i32
    return lib


_CHAIN: list = [None, None]      # the last parameters and their array


def _chain(p: mrr.MRRParams):
    """The folded chain's 19 float32 constants as a ctypes array, kept for
    the parameter object last asked for (hashing the dataclass on every
    call costs more than the launch's other host work)."""
    if _CHAIN[0] is not p:
        values = mrr.chain_constants(p).values()
        _CHAIN[:] = [p, (ctypes.c_float * len(values))(*values)]
    return _CHAIN[1]


def _sheet(shape, with_var: bool) -> tuple[int, int]:
    """(rows, cols) of the 2-D view the kernel walks: the shape's own
    (n / last, last) when a chip's fields refer to it, else (n, 1), the
    stream without a chip."""
    cols = int(shape[-1]) if len(shape) else 1
    n = math.prod(shape)
    if not with_var:
        return n, 1
    return (n // cols if cols else 0), max(cols, 1)


def _per_row(f: torch.Tensor, shape, rows: int) -> bool:
    return len(shape) == 2 and f.ndim == 2 and tuple(f.shape) == (rows, 1)


def _per_col(f: torch.Tensor, shape, cols: int) -> bool:
    return (1 <= f.ndim <= len(shape) and f.shape[-1] == cols
            and all(d == 1 for d in f.shape[:-1]))


def _fields(var: mrr.StaticVariation, w: torch.Tensor, rows: int,
            cols: int):
    """(layout, ctypes struct, tensors to hold) of the three fields: per
    row or per column as the lane vectors themselves (three views alike),
    any other broadcast as stride views of w's (rows, cols) sheet.
    (Against a weight of rank 3 or more that reshape may copy; the caller
    holds the returned tensors until the launch is enqueued.)"""
    fs = (var.dv, var.ddt, var.dlam)
    shape, stride = fs[0].shape, fs[0].stride()
    alike = all(f.shape == shape and f.stride() == stride for f in fs[1:])
    st = _Fields()
    if alike and _per_row(fs[0], w.shape, rows):
        st.p[:] = [f.data_ptr() for f in fs]
        st.s0[:] = (stride[0],) * 3
        return VAR_ROW, st, fs
    if alike and _per_col(fs[0], w.shape, cols):
        st.p[:] = [f.data_ptr() for f in fs]
        st.s1[:] = (stride[-1],) * 3
        return VAR_COL, st, fs
    held = tuple(torch.broadcast_to(f, w.shape).reshape(rows, cols)
                 for f in fs)
    st.p[:] = [v.data_ptr() for v in held]
    st.s0[:] = [v.stride(0) for v in held]
    st.s1[:] = [v.stride(1) for v in held]
    return VAR_ANY, st, held


@functools.lru_cache(maxsize=1024)
def plan(rows: int, cols: int, vec: bool, chip: bool, *,
         n_sm: int = 132) -> dict:
    """The launch of csrc/mrr_transfer.cu over a (rows, cols) sheet.
    Without a chip the rows * cols elements are one stream: each block
    takes `per` x THREADS segments of `vec` elements (4 with 16-byte
    accesses, else 1).  With one, blocks walk tiles of 8 warps x `per`
    rows by 32 lanes x `vec` columns: column tiles on grid x, row tiles on
    grid y up to 65535 (blocks then take further row tiles in turn).  No
    division locates an element; a per-row field is read once a row, a
    per-column one once a thread.  `per` is at most PER_MAX and shrinks
    until there are BLOCKS_PER_SM blocks for each of `n_sm` SMs."""
    v = 4 if vec else 1
    want = n_sm * BLOCKS_PER_SM
    if not chip:
        n = rows * cols
        per = max(1, min(PER_MAX, n // (want * THREADS * v)))
        return {"rows": rows, "cols": cols, "vec": v, "per": per,
                "grid": (max(1, -(-n // (per * THREADS * v))), 1, 1),
                "block": THREADS}
    gx = max(1, -(-cols // (32 * v)))
    warps = THREADS // 32
    per = max(1, min(PER_MAX, rows * gx // (want * warps)))
    row_tiles = -(-rows // (warps * per))
    gy = max(1, min(row_tiles, MAX_GRID_Y))
    return {"rows": rows, "cols": cols, "vec": v, "per": per,
            "tile": (warps * per, 32 * v), "grid": (gx, gy, 1),
            "block": THREADS, "row_tiles_per_block": -(-row_tiles // gy)}


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(w: torch.Tensor, e_dac: torch.Tensor | None = None,
           e_th: torch.Tensor | None = None, sigma_dac: float = 0.02,
           sigma_th: float = 0.04, p: mrr.MRRParams = mrr.DEFAULT_PARAMS,
           var: mrr.StaticVariation | None = None) -> torch.Tensor:
    """Launch csrc/mrr_transfer.cu on the current stream; raises on anything
    the kernel does not take or on a refused launch."""
    out = _launch(None, w, e_dac, e_th, sigma_dac, sigma_th, p, var)
    LAUNCHES.add()
    return out


def launch_backward(g: torch.Tensor, w: torch.Tensor,
                    e_dac: torch.Tensor | None = None,
                    e_th: torch.Tensor | None = None,
                    sigma_dac: float = 0.02, sigma_th: float = 0.04,
                    p: mrr.MRRParams = mrr.DEFAULT_PARAMS,
                    var: mrr.StaticVariation | None = None) -> torch.Tensor:
    """Launch the backward kernel of csrc/mrr_transfer.cu: g * d realize /
    d w at `w` (the forward's operands), `w`'s shape, on the current
    stream; raises as `launch` does."""
    out = _launch(g, w, e_dac, e_th, sigma_dac, sigma_th, p, var)
    LAUNCHES_BWD.add()
    return out


def _launch(g, w, e_dac, e_th, sigma_dac, sigma_th, p, var) -> torch.Tensor:
    """The forward (`g` None) or the backward launch over w's sheet."""
    name = "mrr_transfer" if g is None else "mrr_transfer_bwd"
    noisy = sigma_dac != 0.0 or sigma_th != 0.0
    if noisy != (e_dac is not None) or (e_dac is None) != (e_th is None):
        raise ValueError(f"{name}: the draws must be given exactly when a "
                         "sigma is non-zero")
    streams = (w, e_dac, e_th) if noisy else (w,)
    if g is not None:
        streams += (g,)
    fs = (var.dv, var.ddt, var.dlam) if var is not None else ()
    kernels.require_cuda(*streams, *fs, name=name)
    if any(t.shape != w.shape for t in streams):
        raise ValueError(f"{name}: operands of shapes "
                         f"{[tuple(t.shape) for t in streams[1:]]} for "
                         f"weights of shape {tuple(w.shape)}")
    if not all(t.is_contiguous() for t in streams):
        raise ValueError(f"{name}: w, the draws and g must be contiguous")
    rows, cols = _sheet(w.shape, var is not None)
    if var is not None and cols > MAX_COLS:
        raise ValueError(f"{name}: rows of {cols} elements exceed the "
                         f"kernel's {MAX_COLS}")
    mode, fields, held = VAR_NONE, None, ()
    if var is not None:
        mode, fields, held = _fields(var, w, rows, cols)
    out = torch.empty_like(w)
    ptrs = [t.data_ptr() for t in streams + (out,)]
    vec = (var is None or cols % 4 == 0 or rows == 1) and not any(
        q % 16 for q in ptrs)
    index = w.get_device()
    pl = plan(rows, cols, vec, var is not None, n_sm=_n_sm(index))
    gx, gy, _ = pl["grid"]
    args = (ptrs[0], ptrs[1] if noisy else None, ptrs[2] if noisy else None,
            fields, mode, ptrs[-1], rows, cols, sigma_dac, sigma_th,
            _chain(p), int(vec), gx, gy, pl["per"])
    lib = _lib()
    fn = lib.mrr_transfer_launch if g is None else functools.partial(
        lib.mrr_transfer_backward_launch, g.data_ptr())
    if index == torch.cuda.current_device():
        rc = fn(*args, kernels.stream_of(w))
    else:
        with torch.cuda.device(w.device):
            rc = fn(*args, kernels.stream_of(w))
    del held
    kernels.check_launch(rc, name)
    return out


def preflight(n_elements: int, *, shape=None, lanes: str | None = None,
              noisy: bool = True, n_sm: int = 132) -> dict:
    """What `launch` would run for `n_elements` weights (of `shape`, default
    1-D) on an H100, without launching, 16-byte aligned streams assumed:
    the sheet, its tile plan, the bytes the kernel moves (w in, out, and
    the two draws when `noisy`; a chip's per-lane fields once) and no
    padding (the kernel masks ragged edges).  `lanes`: None, "row" or
    "col", the orientation of a chip's per-lane fields.  `launch_backward`
    walks the same plan and moves g besides."""
    issues: list[str] = []
    if n_elements <= 0:
        issues.append(f"non-positive size n_elements={n_elements}")
        return {"kernel": "mrr_transfer", "grid": (0, 0, 0),
                "smem_bytes": 0, "bytes": 0, "pad_waste": 0.0,
                "issues": issues}
    shape = tuple(shape) if shape is not None else (n_elements,)
    chip = lanes is not None
    rows, cols = _sheet(shape, chip)
    if chip and cols > MAX_COLS:
        issues.append(f"rows of {cols} elements exceed {MAX_COLS}")
    pl = plan(rows, cols, not chip or cols % 4 == 0 or rows == 1, chip,
              n_sm=n_sm)
    n_lanes = {"row": rows, "col": cols}.get(lanes, 0)
    return dict(pl, kernel="mrr_transfer", smem_bytes=0,
                bytes=(16 if noisy else 8) * n_elements + 12 * n_lanes,
                pad_waste=0.0, issues=issues)
