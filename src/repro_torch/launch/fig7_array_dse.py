"""Fig. 7: OPE array-size DSE across the paper workloads (PyTorch port of
`benchmarks/fig7_array_dse.py`).

Sweeps (R, C) under C<=8, T*R*C<=1024; reports relative EDP (vs the 4x4
compact baseline) per workload + the aggregated metric M, and the paper's
headline deltas: best config vs DEAP-CNNs (R=113,C=9) and vs compact 4x4.
Paper claims: -64% vs DEAP, -26% vs compact; winner (R=8,C=8).  The grid
evaluates in float64 on the device (`core.dse`, vectorized engine).

    python -m repro_torch.launch.fig7_array_dse [--device cpu] [--json PATH]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.paper_cnns import WORKLOADS
from repro_torch.core import dse
from repro_torch.core import energy as E
from repro_torch.core.constants import COMPACT_4X4
from repro_torch.launch import cli_device, write_json


def run(verbose: bool = True, device: str | torch.device | None = None,
        osa: bool = False) -> dict:
    wls = [dse.Workload(n, layers) for n, layers in WORKLOADS.items()]
    pts = dse.sweep(wls, osa=E.OSA_OPTIMAL if osa else E.NO_OSA,
                    batch=128, device=device)
    best = pts[0]
    deap = next(p for p in pts if p.ope.rows == 113)
    compact = next(p for p in pts if p.ope == COMPACT_4X4)

    if verbose:
        hdr = f"{'config':16s} {'geomean':>8s} {'worst':>8s} {'M':>8s}  " \
            + " ".join(f"{w.name[:9]:>9s}" for w in wls)
        print(hdr)
        for p in [*pts[:10], deap, compact]:
            row = " ".join(f"{p.rel_edp[w.name]:9.3f}" for w in wls)
            print(f"{p.label:16s} {p.geomean:8.3f} {p.worst:8.3f} "
                  f"{p.metric:8.3f}  {row}")
        print(f"\nbest = {best.label}")
        print(f"aggregated relative EDP: best vs DEAP-CNNs: "
              f"{(1 - best.metric / deap.metric) * 100:.1f}% lower "
              f"(paper: 64%)")
        print(f"aggregated relative EDP: best vs compact 4x4: "
              f"{(1 - best.metric / compact.metric) * 100:.1f}% lower "
              f"(paper: 26%)")
    return {"best": best, "deap": deap, "compact": compact,
            "reduction_vs_deap": 1 - best.metric / deap.metric,
            "reduction_vs_compact": 1 - best.metric / compact.metric}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    res = run(device=cli_device(args.device))
    write_json(args.json, res)
    return res


if __name__ == "__main__":
    main()
