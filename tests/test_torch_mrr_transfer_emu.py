"""The `mrr_transfer` CUDA kernels (`csrc/mrr_transfer.cu`, forward and
backward) run on the CPU through an emulation of the CUDA subset they use
(`tests/cuda_emu.h`, compiled with g++ and `-ffp-contract=off`, as nvcc
builds the source with `--fmad=false`), driven through the wrapper's own
plan and argument building (`ops.launch`, `ops.launch_backward`) on CPU
buffers.  Each launch is held to its plain version bit for bit (`ops.plain`,
`ops.plain_grad`), and two runs give equal bits, on:

  * mobilenet_v3's four depthwise weights with a chip per row, with and
    without the per-shot draws (rows of 9 or 25: V 1);
  * a chip per column against (M, K) activations, a full-shape (`any`)
    field, at a ragged (V 1) and an aligned (V 4) width;
  * the stream without a chip: a ragged 1-D length (V 4 with a scalar
    tail) and a misaligned view of it (V 1);
  * plans with several segments or rows a thread (the SM count cut to 1)
    and with row tiles taken in turn past a grid y cut to 3.

The emulation checks indexing, masks, lane layouts and the order of the
float operations, not the card's speed: phase 12(a) of chip_smoke.py runs
the same comparison on the card.
"""

import contextlib
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import mrr
from repro_torch.kernels.mrr_transfer import ops
from test_torch_rosa_fused_emu import HEADER, _launches

SIGMAS = (mrr.PAPER_NOISE.sigma_dac, mrr.PAPER_NOISE.sigma_th)


def emulated_source() -> str:
    """`mrr_transfer.cu` for the emulation: its launches made `emu_launch`
    calls (the kernels use no shared memory, shuffle or inline PTX)."""
    text = (kernels.CSRC / "mrr_transfer.cu").read_text()
    text = text.replace("#include <cuda_runtime.h>",
                        f'#include "{HEADER.name}"')
    text = _launches(text)
    assert "<<<" not in text and "asm" not in text
    return text


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the emulation is not built")
    d = tmp_path_factory.mktemp("mrr_transfer_emu")
    src = d / "mrr_transfer_emu.cpp"
    src.write_text(emulated_source())
    lib = d / "libmrr_transfer_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                    "-w", "-ffp-contract=off", f"-I{HEADER.parent}", "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   timeout=600)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def emulated(monkeypatch, emu_lib):
    """The wrappers launch the emulated kernels on CPU tensors; the
    returned function sets the SM count and the grid-y limit the plan
    sees."""
    monkeypatch.setattr(kernels, "library", lambda name: emu_lib)
    monkeypatch.setattr(kernels, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    sms = {"n": 132}
    monkeypatch.setattr(ops, "_n_sm", lambda index: sms["n"])
    ops._lib.cache_clear()
    ops.plan.cache_clear()

    def configure(n_sm=132, max_grid_y=ops.MAX_GRID_Y):
        sms["n"] = n_sm
        monkeypatch.setattr(ops, "MAX_GRID_Y", max_grid_y)
        ops.plan.cache_clear()

    yield configure
    ops._lib.cache_clear()
    ops.plan.cache_clear()


def _operands(shape, layout, noisy, seed):
    """Targets over the clip range, a gradient, the draws and a chip's
    fields in `layout` (None, "row", "col" or "any")."""
    r = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(r.normal(size=sh).astype(np.float32))
    w = torch.from_numpy(r.uniform(-1.1, 1.1, shape).astype(np.float32))
    g = f(*shape)
    eps = (f(*shape), f(*shape)) if noisy else (None, None)
    var = None
    if layout == "any":
        var = mrr.StaticVariation(*(s * f(*shape) for s in (0.01, 0.04,
                                                             0.01)))
    elif layout is not None:
        lanes = shape[0] if layout == "row" else shape[-1]
        var = mrr.StaticVariation(*(s * f(lanes) for s in (0.01, 0.04,
                                                           0.01)))
        if layout == "row":
            var = mrr.expand_lanes(var, w)
    return w, g, eps, var


DW = [((r, c), "row", noisy) for r, c in ((16, 9), (36, 9), (48, 25),
                                          (60, 25)) for noisy in (False,
                                                                  True)]
# (shape, layout, draws, (SMs, grid y limit), V the plan takes)
CASES = [(*c, (132, ops.MAX_GRID_Y), 1) for c in DW] + [
    ((37, 27), "col", True, (132, ops.MAX_GRID_Y), 1),
    ((24, 256), "col", False, (132, ops.MAX_GRID_Y), 4),
    ((37, 27), "any", False, (132, ops.MAX_GRID_Y), 1),
    ((40, 100), "any", True, (132, ops.MAX_GRID_Y), 4),
    ((1001,), None, True, (132, ops.MAX_GRID_Y), 4),
    ((1001,), None, False, (132, ops.MAX_GRID_Y), 4),
    ((20001,), None, True, (1, ops.MAX_GRID_Y), 4),
    ((600, 8), "row", False, (1, 3), 4),
    ((600, 8), "row", True, (1, ops.MAX_GRID_Y), 4),
]


def _id(case):
    shape, layout, noisy, (n_sm, gy), v = case
    return (f"{'x'.join(map(str, shape))}-{layout or 'nochip'}"
            f"-{'draws' if noisy else 'nodraws'}-v{v}"
            + (f"-sm{n_sm}" if n_sm != 132 else "")
            + (f"-gy{gy}" if gy != ops.MAX_GRID_Y else ""))


def _held_bitwise(w, g, eps, sig, var):
    y = ops.launch(w, *eps, *sig, var=var)
    dq = ops.launch_backward(g, w, *eps, *sig, var=var)
    assert torch.equal(y, ops.plain(w, *eps, *sig, var=var))
    assert torch.equal(dq, ops.plain_grad(g, w, *eps, *sig, var=var))
    assert torch.equal(y, ops.launch(w, *eps, *sig, var=var))
    assert torch.equal(dq, ops.launch_backward(g, w, *eps, *sig, var=var))
    return y, dq


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_emulated_kernels_equal_plain_bit_for_bit(emulated, case):
    shape, layout, noisy, (n_sm, gy), v = case
    emulated(n_sm, gy)
    w, g, eps, var = _operands(shape, layout, noisy, sum(shape) + noisy)
    rows, cols = ops._sheet(w.shape, var is not None)
    pl = ops.plan(rows, cols, cols % 4 == 0 or var is None, var is not None,
                  n_sm=n_sm)
    assert pl["vec"] == v
    if n_sm == 1:                        # several segments or rows a thread
        assert pl["per"] > 1
    if gy != ops.MAX_GRID_Y:             # row tiles taken in turn
        assert pl["row_tiles_per_block"] > 1
    sig = SIGMAS if noisy else (0.0, 0.0)
    n_fwd, n_bwd = ops.LAUNCHES.count, ops.LAUNCHES_BWD.count
    y, dq = _held_bitwise(w, g, eps, sig, var)
    assert ops.LAUNCHES.count == n_fwd + 2
    assert ops.LAUNCHES_BWD.count == n_bwd + 2
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(dq).all())
    inside = (w > -1) & (w < 1)
    assert bool((dq[~((w >= -1) & (w <= 1))] == 0).all())
    assert bool((dq[inside] != 0).any())


def test_emulated_stream_misaligned_takes_single_lanes(emulated):
    """A view 4 bytes into its buffer: no 16-byte accesses (V 1) on the
    stream without a chip, with and without the draws."""
    for noisy in (False, True):
        w, g, eps, _ = _operands((1002,), None, noisy, 7 + noisy)
        w, g = w[1:], g[1:]
        eps = tuple(e[1:] for e in eps) if noisy else eps
        assert w.data_ptr() % 16 and w.is_contiguous()
        _held_bitwise(w, g, eps, SIGMAS if noisy else (0.0, 0.0), None)
