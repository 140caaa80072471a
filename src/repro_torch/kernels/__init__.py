"""Hand-written CUDA kernels for Hopper (sm_90a) and their loader.

Each kernel lives in `csrc/<name>.cu` behind a plain C interface (shared
device code in `csrc/*.cuh`).  On first use `library(name)` compiles
every source in `csrc/` with `nvcc` (one process per source, all started
together) into `<checkout>/build/repro_torch_kernels/lib<name>-<hash>.so`,
where the hash covers the source, the shared headers and the flags, and
loads it with `ctypes`.  Nothing is
built when this package is imported, and nothing is built for a CPU
tensor: each wrapper takes its plain PyTorch version only for tensors on
the CPU, and for a CUDA tensor launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")

# --fmad=false: the MRR realization chain is evaluated op by op, as its
# plain version is; the accumulations use fmaf explicitly.  No fast math:
# it would approximate division and sqrt and flush denormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}

# Observers of `build_all`, each called as fn(event, name, seconds): event
# "build" after nvcc built library `name` (`seconds` from its start to its
# collection), "cache_hit" for a library found up to date.  Empty unless
# `repro_torch.obs.install_kernel_hooks` registered one.
BUILD_LISTENERS: list = []


def _notify(event: str, name: str, seconds: float = 0.0) -> None:
    for fn in BUILD_LISTENERS:
        fn(event, name, seconds)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch build with the CUDA toolkit on first use")


def _target(src: pathlib.Path) -> pathlib.Path:
    # the hash covers the shared headers a source may include
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers
                       + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, pathlib.Path]:
    """Compile the named sources (default: every `csrc/*.cu`) in parallel;
    returns {name: library path}.  Up-to-date libraries are not rebuilt.
    Raises `KernelBuildError` with nvcc's output if any build fails."""
    srcs = sorted(CSRC.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in names]
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    for s in srcs:
        if s not in todo:
            _notify("cache_hit", s.stem)
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for s in todo:
            tmp = out[s.stem].with_suffix(f".{os.getpid()}.tmp")
            procs.append((s, tmp, time.perf_counter(), subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for s, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            (BUILD_DIR / f"{s.stem}.log").write_bytes(log)
            if proc.returncode != 0:
                errors.append(f"{s.name}:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out[s.stem])
                _notify("build", s.stem, time.perf_counter() - t0)
        if errors:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return out


def build_log(name: str) -> str:
    """nvcc's output (registers, shared memory, spills) of the last build."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _LIBS[name] = lib
    return lib


class LaunchCounter:
    """Launches of one kernel: its wrapper calls `add()` where it launches
    the kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of `t`'s device, as
    `torch.cuda.current_stream(t.device).cuda_stream` gives it, without
    building a Stream object (several microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_launch(rc: int, name: str) -> None:
    """Raise if a C launcher returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper takes its plain version for `t`: on the CPU,
    and on `meta`, where a trace (the dry run's) has no data to launch on.
    A CUDA tensor always takes the kernel; any other device reaches the
    kernel's checks and is refused."""
    return t.device.type in ("cpu", "meta")


def require_cuda(*tensors, name: str) -> None:
    """Device and dtype checks shared by the kernel wrappers: every operand
    a kernel reads is a float32 CUDA tensor."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
