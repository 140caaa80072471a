#!/usr/bin/env python3
"""The `mrr_transfer` backward's blocks an SM on one CUDA card.

Builds `csrc/mrr_transfer.cu` as written (`--blocks 0`, build `src`) and
with `BLOCKS_PER_SM` set to each other value given for every backward
kernel (the minimum `__launch_bounds__` gives them, so their register
cap), and another tree's source beside them (`--parent`), all with the
package's nvcc flags, one nvcc a source, started together.  For each
build it prints every backward kernel's registers and local bytes a
thread (`cuobjdump --dump-resource-usage`) and SASS instructions an
element on the fast path (`chip_smoke.sass_fast_path`), and whether the
forward's SASS equals the first build's (labels aside; the diff of the
first forward kernel that differs goes to
`chiprun_out/mrr_bwd_blocks_fwd_<build>.diff`, the backward's SASS at
the wide chip-only sheet to `chiprun_out/mrr_bwd_blocks_<build>.sass`).
Then it times the backward kernel-only (CUDA-graph replays,
`chip_smoke.kernel_only_ms`) at phase 12(a)'s wide sheets, the widest
depthwise weight, the conv_stem sheet, the full-shape field and the
ragged stream, the builds taken in turn and in reverse turn for
`--rounds` rounds, each build of this tree first held bit for bit to
`ops.plain_grad`.

    python3 tools/mrr_bwd_blocks.py --blocks 0 1 8 \\
        [--parent build/parent/src/repro_torch/kernels/csrc/mrr_transfer.cu]

The numbers go to stdout and `chiprun_out/mrr_bwd_blocks.json`.
"""

import argparse
import ctypes
import difflib
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import mrr  # noqa: E402
from repro_torch.kernels.mrr_transfer import ops  # noqa: E402

BLOCKS = re.compile(r"constexpr int BLOCKS_PER_SM = [^;]+;")
OUT = ROOT / "build" / "mrr_bwd_blocks"
# (what, shape, draws, the chip's layout as in chip_smoke.MRR_BWD_CASES)
CASES = [("(5120, 51200), chip", (5120, 51200), False, 0),
         ("(5120, 51200), chip, draws", (5120, 51200), True, 0),
         ("mobilenet_v3 dw 60x25, chip", (60, 25), False, 0),
         ("mobilenet_v3 dw 60x25, chip, draws", (60, 25), True, 0),
         ("conv_stem IS sheet, chip per column, draws", (524288, 27), True,
          1),
         ("full-shape chip field", (4096, 100), False, "any"),
         ("ragged 1-D, draws, no chip", (1_000_003,), True, None)]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(sources: dict) -> dict:
    """{tag: library path} of {tag: CUDA source text}, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in sources.items():
        src = OUT / f"mrr_transfer_{tag}.cu"
        src.write_text(text)
        lib = OUT / f"libmrr_transfer_{tag}.so"
        procs[tag] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tag}:\n{log.decode()}")
        libs[tag] = lib
    return libs


def short(mangled: str) -> str:
    """A kernel's name and template arguments, without the anonymous
    namespace's mangling (which holds the source file's name)."""
    return re.search(r"transfer_kernel_\w+?ELi\dE(?=EEv)", mangled).group(0)


def functions(sass: str) -> dict:
    """{short name: its SASS text} of `cuobjdump -sass` output, the labels
    (numbered across the whole library) made one."""
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return {short(k): re.sub(r"\.L_x_\d+", ".L_x", v)
            for k, v in zip(parts[1::2], parts[2::2])}


def operands(shape, noisy, axis):
    g = torch.Generator("cuda").manual_seed(12)
    w = 2.2 * torch.rand(shape, device="cuda", generator=g) - 1.1
    gr = torch.randn(shape, device="cuda", generator=g)
    var = None
    if axis is not None:
        lanes = shape if axis == "any" else shape[axis]
        var = mrr.StaticVariation(
            *(s * torch.randn(lanes, device="cuda", generator=g)
              for s in (0.01, 0.04, 0.01)))
    if axis == 0:
        var = mrr.expand_lanes(var, w)
    sig = (mrr.PAPER_NOISE.sigma_dac, mrr.PAPER_NOISE.sigma_th) \
        if noisy else (0.0, 0.0)
    eps = mrr.draw_eps(torch.Generator("cuda").manual_seed(13), shape,
                       "cuda") if noisy else (None, None)
    return (gr, w, *eps, *sig), var


def use(lib: ctypes.CDLL) -> None:
    """Point the wrapper at the loaded library `lib`."""
    kernels._LIBS["mrr_transfer"] = lib
    ops._lib.cache_clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[0, 1, 4, 8],
                    help="blocks an SM for every backward kernel; 0: the "
                    "source's own choice (build `src`)")
    ap.add_argument("--parent", type=pathlib.Path,
                    help="another tree's csrc/mrr_transfer.cu, timed beside")
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mrr_bwd_blocks: no CUDA device", file=sys.stderr)
        return 1
    cs = chip_smoke()
    text = (kernels.CSRC / "mrr_transfer.cu").read_text()
    if len(BLOCKS.findall(text)) != 1:
        raise SystemExit("mrr_bwd_blocks: the source does not define "
                         "BLOCKS_PER_SM once")
    sources = {f"b{b}" if b else "src": BLOCKS.sub(
        f"constexpr int BLOCKS_PER_SM = BWD ? {b} : 0;", text) if b else text
        for b in opts.blocks}
    if opts.parent is not None:
        sources = {"parent": opts.parent.read_text(), **sources}
    print(f"card: {cs.card_line()}; torch {torch.__version__}")
    libs = build(sources)
    tool = pathlib.Path(kernels.nvcc_path()).with_name("cuobjdump")
    report = {"card": cs.card_line(), "builds": {}}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    first = None
    for tag, lib in libs.items():
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        funcs = functions(sass)
        fwd = {k: v for k, v in funcs.items() if "ELb0ELi" in k}
        first = first or fwd
        res = cs.kernel_resources(lib)
        info = {"forward_sass_equal_first": fwd == first, "kernels": {}}
        for full, (regs, local) in sorted(res.items()):
            name = short(full)
            if "ELb1ELi" not in name:               # a forward kernel
                continue
            count, stored = cs.sass_fast_path(sass, name)
            info["kernels"][name] = dict(registers=regs, local_bytes=local,
                                         instr_per_element=count / stored)
        report["builds"][tag] = info
        if fwd != first:          # the first forward kernel that differs
            k = next(k for k in first if fwd.get(k) != first[k])
            (out / f"mrr_bwd_blocks_fwd_{tag}.diff").write_text("".join(
                difflib.unified_diff(first[k].splitlines(True),
                                     fwd.get(k, "").splitlines(True),
                                     k, f"{tag}: {k}")))
        wide = cs.mrr_kernel(CASES[0][1], False, 0, True)
        (out / f"mrr_bwd_blocks_{tag}.sass").write_text(next(
            v for k, v in funcs.items() if wide in k))
        print(f"  {tag}: forward SASS equal to {next(iter(libs))}'s: "
              f"{info['forward_sass_equal_first']}")
        for name, k in info["kernels"].items():
            print(f"    {name}: {k['registers']} registers, "
                  f"{k['local_bytes']} local bytes, "
                  f"{k['instr_per_element']:.2f} SASS instructions an element")
    loaded = {tag: ctypes.CDLL(str(lib)) for tag, lib in libs.items()}
    times = {tag: {c[0]: [] for c in CASES} for tag in libs}
    for what, shape, noisy, axis in CASES:
        args, var = operands(shape, noisy, axis)
        want = ops.plain_grad(*args, var=var)
        for tag in libs:
            if tag == "parent":
                continue
            use(loaded[tag])
            got = ops.launch_backward(*args, var=var)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{tag} {what}: differs from plain_grad")
        del want
        order = list(libs)
        for r in range(opts.rounds):
            for tag in (order if r % 2 == 0 else order[::-1]):
                use(loaded[tag])
                times[tag][what].append(cs.kernel_only_ms(
                    lambda: ops.launch_backward(*args, var=var)))
        del args, var
        torch.cuda.empty_cache()
    for what, *_ in CASES:
        print(f"  {what}: kernel-only ms, median of {opts.rounds} (runs)")
        for tag in libs:
            ts = times[tag][what]
            print(f"    {tag}: {statistics.median(ts):.4f} "
                  f"({' / '.join(f'{t:.4f}' for t in ts)})")
    report["kernel_ms"] = times
    (out / "mrr_bwd_blocks.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
