"""The `ssd_scan` CUDA kernels (`csrc/ssd_scan.cu`: the forward's three
launches and the backward's four, with the backward's 3xTF32 tensor-core
tiles) run on the CPU through an emulation of the CUDA subset they use
(`tests/cuda_emu.h`, compiled with g++), driven through the wrappers'
own argument building (`ops._launch`, `ops.launch_backward`) and held
against the plain versions at small shapes: ragged tails, a chunk and
one, L 1, G 1 / 2 / H, a chunk that is not a multiple of 32, widths
that are not multiples of 4 (4-byte copies).

Bounds: the forward's y and final state within 1e-4 of their max (the
card's phase 6 bound); each backward gradient within 4x the float32
plain backward's distance from float64 plus 1e-6 of its max, and within
1e-4 of its max (the card's phase 19(a) gates); two runs equal bit for
bit; a None dstate gives a zero one's bits.  The emulation checks
indexing, masks, barriers and the order of sums, not the card's
rounding inside an mma (modelled as one rounding of its exact sum) and
not speed: the card's own runs are phases 6 and 19(a) of chip_smoke.py.
"""

import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.ssd_scan import ops

HEADER = pathlib.Path(__file__).with_name("cuda_emu.h")
# the device functions that hold inline PTX, and what the emulation runs
EMULATED = {"cp16": "emu_cp(dst, src, 16, bytes);",
            "cp4": "emu_cp(dst, src, 4, bytes);",
            "cp_commit": "", "cp_wait": "",
            "tf32_rna": "return emu_tf32(v);",
            "mma_tf32": "emu_mma(d, a, b0, b1);"}


def emulated_source(text: str) -> str:
    """`ssd_scan.cu` for the emulation: the PTX functions' bodies
    replaced, dynamic and static shared memory made block-wide, launches
    made `emu_launch` calls."""
    text = text.replace("#include <cuda_runtime.h>",
                        f'#include "{HEADER.name}"')
    for name, body in EMULATED.items():
        text, n = re.subn(
            rf"(__device__ __forceinline__ \w+ {name}\([^)]*\) \{{)\n.*?\n\}}",
            lambda m: f"{m.group(1)}\n  {body}\n}}", text, flags=re.S)
        assert n == 1, name
    text = text.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = emu_smem;")
    text = text.replace("__shared__ float", "static float")
    text = re.sub(r"(\w+(?:<\d+>)?)<<<\s*(dim3\([^;]*?\)),\s*(\w+),[^;]*?>>>"
                  r"\((.*?)\);",
                  lambda m: f"emu_launch({m.group(2)}, {m.group(3)}, [&] "
                            f"{{ {m.group(1)}({m.group(4)}); }});",
                  text, flags=re.S)
    assert "<<<" not in text and "asm" not in text
    return text


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the emulation is not built")
    d = tmp_path_factory.mktemp("ssd_emu")
    src = d / "ssd_scan_emu.cpp"
    src.write_text(emulated_source((kernels.CSRC / "ssd_scan.cu")
                                   .read_text()))
    lib = d / "libssd_scan_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", "-w", f"-I{HEADER.parent}", "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def emulated(monkeypatch, emu_lib):
    """The wrappers launch the emulated kernels on CPU tensors."""
    monkeypatch.setattr(kernels, "library", lambda name: emu_lib)
    monkeypatch.setattr(kernels, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    ops._lib.cache_clear()
    yield
    ops._lib.cache_clear()


def _inputs(bsz, l, h, p, g, s, seed):
    r = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(r.normal(size=sh).astype(np.float32))
    loga = -torch.nn.functional.softplus(f(bsz, l, h))
    return (f(bsz, l, h, p), loga, f(bsz, l, g, s), f(bsz, l, g, s),
            f(bsz, l, h, p), f(bsz, h, s, p))


# (B, L, H, P, G, S, chunk)
CASES = [(1, 70, 2, 64, 1, 128, 128), (1, 129, 2, 64, 2, 128, 128),
         (2, 40, 4, 8, 2, 16, 16), (1, 100, 2, 64, 1, 64, 50),
         (1, 37, 3, 20, 3, 36, 24), (1, 1, 2, 64, 1, 128, 128)]


@pytest.mark.parametrize("case", CASES)
def test_emulated_kernels_match_plain_versions(emulated, case):
    bsz, l, h, p, g, s, q = case
    x, loga, b, c, dy, ds = _inputs(*case[:6], seed=l)
    y, st, ws = ops._launch(x, loga, b, c, q)
    wy, wst = ops.plain(x, loga, b, c, q)
    for a, w in ((y, wy), (st, wst)):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())

    got = ops.launch_backward(x, b, c, dy, ds, ws, q)
    want = ops.plain_backward(*(t.double() for t in (x, loga, b, c, dy,
                                                     ds)), q)
    p32 = ops.plain_backward(x, loga, b, c, dy, ds, q)
    for name, a, w, f in zip(("dx", "dloga", "db", "dc"), got, want, p32):
        assert bool(torch.isfinite(a).all()), name
        scale = float(w.abs().max())
        dev = float((a.double() - w).abs().max())
        floor = float((f.double() - w).abs().max())
        assert dev <= 4 * floor + 1e-6 * scale and dev <= 1e-4 * scale, (
            name, dev, floor, scale)
    again = ops.launch_backward(x, b, c, dy, ds, ws, q)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    none = ops.launch_backward(x, b, c, dy, None, ws, q)
    zero = ops.launch_backward(x, b, c, dy, torch.zeros_like(ds), ws, q)
    assert all(torch.equal(u, v) for u, v in zip(none, zero))
