"""Kernel preflight: every zoo shape checked against the CUDA kernels'
launch contracts (the port's counterpart of `repro.analysis.checks.pallas`).

The four `kernels/*/ops.py` each export a `preflight()` that walks their
launcher's plan (grid, K split, shared memory, padding) without launching
anything; this check maps a target's workload shapes through them and
turns the reports into findings, against the limits of the card the
process sees (`torch.cuda.get_device_properties`: SMs, opt-in shared
memory per block) or, with no card, an H100's: 132 SMs, 227 KB of shared
memory per block, grid y and z at most 65535.

Findings, one to one onto the reference's:

  KER001 ERROR    (PAL001) a launch's shared memory per block exceeds the
                  card's opt-in limit: the kernel cannot launch
  KER002 WARNING  (PAL002) padding waste > 50%: the shape is legal but a
                  large share of the multiply-adds work on ragged tile
                  edges
  KER003 ERROR    (PAL003) contract violation: a shape or grid the
                  launcher refuses (grid y or z past 65535, more planes
                  than the kernel holds, 32-bit offset overflow, ...)
"""

from __future__ import annotations

import functools

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.registry import register
from repro_torch.analysis.target import AnalysisTarget

H100 = {"n_sm": 132, "smem_bytes": 232448, "max_grid_yz": 65535}
PAD_WASTE_WARN = 0.5


@functools.lru_cache(maxsize=None)
def device_limits() -> dict:
    """The limits the preflights are held to: the card's where there is
    one, else an H100's (`H100`)."""
    import torch
    if not torch.cuda.is_available():
        return dict(H100)
    props = torch.cuda.get_device_properties(0)
    return {"n_sm": props.multi_processor_count,
            "smem_bytes": getattr(props, "shared_memory_per_block_optin",
                                  H100["smem_bytes"]),
            "max_grid_yz": H100["max_grid_yz"]}


def _grids(rep: dict) -> list:
    return [rep["grid"]] if "grid" in rep else \
        [ln["grid"] for ln in rep.get("launches", ())]


def _smem(rep: dict) -> int:
    return max([rep.get("smem_bytes", 0)]
               + [ln["smem_bytes"] for ln in rep.get("launches", ())])


def _findings_from(rep: dict, subject: str, where: str,
                   lim: dict) -> list[Finding]:
    out: list[Finding] = []
    loc = f"{rep['kernel']}:{where}"
    # shared memory is KER001's, held to the card's own limit below
    issues = [i for i in rep["issues"] if "shared memory" not in i]
    if not any("grid" in i for i in issues):
        for grid in _grids(rep):
            if max(grid[1:], default=0) > lim["max_grid_yz"]:
                issues.append(f"grid {tuple(grid)} exceeds "
                              f"{lim['max_grid_yz']} in y or z")
    for issue in issues:
        out.append(Finding(
            check="kernels", code="KER003", severity=Severity.ERROR,
            subject=subject, location=loc,
            message=f"kernel contract violation: {issue}"))
    smem = _smem(rep)
    if smem > lim["smem_bytes"]:
        out.append(Finding(
            check="kernels", code="KER001", severity=Severity.ERROR,
            subject=subject, location=loc,
            message=(f"{smem} bytes of shared memory per block exceed the "
                     f"card's {lim['smem_bytes']}: the launch fails")))
    if rep["pad_waste"] > PAD_WASTE_WARN:
        out.append(Finding(
            check="kernels", code="KER002", severity=Severity.WARNING,
            subject=subject, location=loc,
            message=(f"padding inflates the kernel's work by "
                     f"{rep['pad_waste']:.0%}: ragged tile edges")))
    return out


@register("kernels")
def check_kernels(target: AnalysisTarget) -> list[Finding]:
    if not target.gemm_shapes and not target.ssd_shapes:
        return []
    from repro_torch.kernels.mrr_transfer import ops as mrr_ops
    from repro_torch.kernels.osa_matmul import ops as osa_ops
    from repro_torch.kernels.rosa_fused import ops as fused_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    lim = device_limits()
    findings: list[Finding] = []
    for name, m, k, n in target.gemm_shapes:
        where = f"{name} {m}x{k}x{n}"
        osa_rep = osa_ops.preflight(m, k, n, n_sm=lim["n_sm"])
        findings += _findings_from(osa_rep, target.name, where, lim)
        # the WS path realizes the (k, n) weight sheet through mrr_transfer
        findings += _findings_from(
            mrr_ops.preflight(k * n, shape=(k, n), n_sm=lim["n_sm"]),
            target.name, where, lim)
        # the fused kernel covers the same GEMM in one launch; where its
        # grid and padding equal osa_matmul's, a KER002 would restate the
        # one already filed against osa_matmul under a second fingerprint
        fused_rep = fused_ops.preflight(m, k, n, n_sm=lim["n_sm"])
        fused = _findings_from(fused_rep, target.name, where, lim)
        if (fused_rep["grid"] == osa_rep["grid"]
                and fused_rep["pad_waste"] == osa_rep["pad_waste"]):
            fused = [f for f in fused if f.code != "KER002"]
        findings += fused
    for name, bsz, l, h, p, s_dim in target.ssd_shapes:
        findings += _findings_from(
            ssd_ops.preflight(bsz, l, h, p, s_dim), target.name,
            f"{name} B{bsz}xL{l}xH{h}xP{p}xS{s_dim}", lim)
    return findings
