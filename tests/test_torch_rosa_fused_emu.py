"""The `rosa_fused` CUDA kernel's tall path (`csrc/rosa_fused.cu`, M > 16)
runs on the CPU through an emulation of the CUDA subset it uses
(`tests/cuda_emu.h`, compiled with g++), driven through the wrapper's own
plan and argument building (`ops.launch`) and held against the plain
version at small tall shapes: M 17, 64 and 130 (one 64-row tile, a
ragged 128-row one), K 100 and 300 (not multiples of a stage), N 10 (a
sheet: activations conditioned in the tile) and 200 (both operands
through workspaces), the K split on and off, on each route:

  * codes: IS with the paper's per-shot noise and a chip, MIXED, ideal
    slot gains; its int32 sums must equal the exact integer product of
    the plain version's codes, flushed in the kernel's order, bit for bit;
  * tf32x2: WS with a chip (the weight realized);
  * tf32x3: ANALOG, and IS under a non-ideal OSA (splitter imbalance);
    the TF32 routes also within chip_smoke.py's `split_tf32_parity` of
    the float64 product (a split that dropped its low terms fails it).

Every case meets the flip-aware bound of `assert_quantized_parity`, and
two runs give equal bits.  The emulation checks indexing, masks, barriers
and the order of sums, not the card's rounding inside an mma (modelled
as one rounding of its exact sum) and not speed: the card's own runs are
phase 2 of chip_smoke.py.
"""

import contextlib
import ctypes
import functools
import importlib.util
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import mrr
from repro_torch.core import osa
from repro_torch.core.constants import ComputeMode, Mapping
from repro_torch.kernels.rosa_fused import ops
from test_torch_ref import assert_quantized_parity

HEADER = pathlib.Path(__file__).with_name("cuda_emu.h")
# the device functions that hold inline PTX, and what the emulation runs
EMULATED = {
    "rosa_fused.cu": {
        "cp16": "std::memcpy(dst, src, 16);",
        "cp_commit": "", "cp_wait": "",
        "tf32_rna": "return emu_tf32(v);",
        "mma_s8": "std::abort();", "mma_tf32": "std::abort();",
        "mma_s8_tile": "emu_mma_s8_tile(acc, a, b);",
        "mma_tf32_tile": "emu_mma_tf32_tile<MT, SPLIT_A>(acc, ah, al, bh, "
                         "bl);"},
    "skinny_stream.cuh": {
        "cp_async16": "emu_cp(dst, src, 16, 16);",
        "cp_async4": "emu_cp(dst, src, 4, 4);",
        "cp_commit": "", "cp_wait": ""},
}


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """The repo's chip_smoke.py as a module (its checks, not its phases)."""
    path = HEADER.parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(text: str, i: int, open_: str, close: str) -> int:
    """Index of the bracket closing the one at text[i]."""
    depth = 0
    for j in range(i, len(text)):
        depth += (text[j] == open_) - (text[j] == close)
        if depth == 0:
            return j
    raise ValueError("unbalanced")


def _split_top(s: str) -> list:
    """s split at the commas outside any parentheses."""
    parts, depth, start = [], 0, 0
    for i, c in enumerate(s):
        depth += (c == "(") - (c == ")")
        if c == "," and depth == 0:
            parts.append(s[start:i].strip())
            start = i + 1
    return parts + [s[start:].strip()]


def _launches(text: str) -> str:
    """Every `kernel<<<grid, threads, ...>>>(args);` as an emu_launch."""
    out, i = [], 0
    while (j := text.find("<<<", i)) >= 0:
        s = j
        if text[s - 1] == ">":
            s = text.rfind("<", 0, s - 1)
        while text[s - 1].isalnum() or text[s - 1] == "_":
            s -= 1
        e = text.index(">>>", j)
        grid, threads = _split_top(text[j + 3:e])[:2]
        a1 = _close(text, e + 3, "(", ")")
        out.append(f"{text[i:s]}emu_launch(dim3({grid}), {threads}, [&] {{ "
                   f"{text[s:j]}({text[e + 4:a1]}); }})")
        i = a1 + 1
    return "".join(out) + text[i:]


def _emulate(text: str, bodies: dict) -> str:
    for name, body in bodies.items():
        text, n = re.subn(
            rf"(__device__ __forceinline__ \w+ {name}\(.*?\) \{{)\n.*?\n\}}",
            lambda m: f"{m.group(1)}\n  {body}\n}}", text, flags=re.S)
        assert n == 1, name
    text = text.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = emu_smem;")
    text = text.replace("__shared__ float", "static float")
    text = text.replace("#include <cuda_runtime.h>",
                        f'#include "{HEADER.name}"')
    return _launches(text)


def emulated_source() -> str:
    """`rosa_fused.cu` with `skinny_stream.cuh` inlined, for the
    emulation: the PTX functions' bodies replaced, shared memory made
    block-wide, launches made `emu_launch` calls."""
    header = _emulate((kernels.CSRC / "skinny_stream.cuh").read_text(),
                      EMULATED["skinny_stream.cuh"])
    text = _emulate((kernels.CSRC / "rosa_fused.cu").read_text(),
                    EMULATED["rosa_fused.cu"])
    text = text.replace('#include "skinny_stream.cuh"',
                        header.replace("#pragma once", ""))
    assert "<<<" not in text and "asm" not in text
    return text


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the emulation is not built")
    d = tmp_path_factory.mktemp("rosa_fused_emu")
    src = d / "rosa_fused_emu.cpp"
    src.write_text(emulated_source())
    lib = d / "librosa_fused_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                    "-w", "-ffp-contract=off", f"-I{HEADER.parent}", "-o",
                    str(lib), str(src)], check=True, capture_output=True,
                   timeout=600)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def emulated(monkeypatch, emu_lib):
    """The wrapper launches the emulated kernel on CPU tensors; n_sm(s)
    sets the SM count the plan sees (1: no K split)."""
    sms = {"n": 132}
    monkeypatch.setattr(kernels, "library", lambda name: emu_lib)
    monkeypatch.setattr(kernels, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(ops, "_n_sm", lambda index: sms["n"])
    ops._lib.cache_clear()
    yield lambda n: sms.update(n=n)
    ops._lib.cache_clear()


def _operands(m, k, n, seed, kw):
    r = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(r.normal(size=sh).astype(np.float32))
    x, w = f(m, k), f(k, n)
    var = mrr.StaticVariation(0.01 * f(k), 0.04 * f(k), 0.01 * f(k))
    key = None
    if kw.pop("noisy", False):
        kw["noise"] = mrr.PAPER_NOISE
        key = torch.Generator().manual_seed(seed)
    return ops.operands(x, w, key, var, **kw)


IS_NOISY = dict(mapping=Mapping.IS, act_per_vector=True, noisy=True)
ROUTE_KW = {
    "codes": IS_NOISY,
    "tf32x2": dict(mapping=Mapping.WS),
    "tf32x3": dict(mode=ComputeMode.ANALOG),
    "tf32x3 osa": dict(mapping=Mapping.IS, act_per_vector=True,
                       osa_cfg=osa.OSAConfig(splitter_imbalance=0.02)),
}
# (M, K, N, split): each value of M, K, N and the split on every route
SHAPES = [(17, 100, 200, True), (64, 300, 200, False),
          (64, 300, 10, True), (130, 300, 200, True),
          (130, 100, 10, False)]
CASES = [(r, s) for r in ("codes", "tf32x2", "tf32x3") for s in SHAPES] \
    + [("tf32x3 osa", (130, 300, 200, True))]


@pytest.mark.parametrize("route,shape", CASES, ids=[
    f"{r.replace(' ', '_')}-{m}x{k}x{n}-{'split' if sp else 'whole'}"
    for r, (m, k, n, sp) in CASES])
def test_emulated_tall_path_matches_plain(emulated, route, shape):
    m, k, n, split = shape
    emulated(132 if split else 1)
    args, static = _operands(m, k, n, m + k + n, dict(ROUTE_KW[route]))
    assert ops.route_of(k, **static) == route.split()[0]
    pl = ops.plan(m, k, n, n_sm=132 if split else 1, route=route.split()[0])
    assert pl["path"] == "tall" and (pl["splits"] > 1) == split
    assert pl["x_in_tile"] == (n <= ops.TALL_BN)
    y = ops.launch(*args, **static)
    want = ops.plain(*args, **static)
    assert bool(torch.isfinite(y).all())
    assert_quantized_parity(y, want)
    assert torch.equal(y, ops.launch(*args, **static))
    if route != "codes":
        chip_smoke().split_tf32_parity(y, want, args, static, route)
    else:
        a, w_eff = ops.conditioned(*args, **static)
        codes = torch.round(w_eff.double() * static["qmax"])
        sums = (a.double() @ codes).float()       # exact: |sums| < 2^24
        qf = torch.tensor(float(static["qmax"]))
        s2, sw = args[3][:, 2:3], args[4][2]
        exact = (sums * (1.0 / qf)) * (s2 * (sw / qf))
        assert torch.equal(y, exact)


def test_emulated_codes_route_is_exact_past_float32_sums(emulated):
    """K 2100 of full-scale codes: the int32 sums reach 2^25, past
    float32's integers, where the plain version's product rounds; the
    kernel's stay exact (one column tile of 200, split)."""
    m, k, n = 20, 2100, 200
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.choice([-1.0, 1.0], size=(m, k))
                         .astype(np.float32))
    w = torch.from_numpy(np.sign(x[:1].numpy().T) * np.ones((k, n),
                                                             np.float32))
    args, static = ops.operands(x, w, mapping=Mapping.WS)
    assert ops.route_of(k, **static) == "codes"
    y = ops.launch(*args, **static)
    a, w_eff = ops.conditioned(*args, **static)
    sums = a.double() @ torch.round(w_eff.double() * 127)
    assert float(sums.abs().max()) > 2**24
    qf = torch.tensor(127.0)
    s2, sw = args[3][:, 2:3], args[4][2]
    assert torch.equal(y, (sums.float() * (1.0 / qf)) * (s2 * (sw / qf)))
