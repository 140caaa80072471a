"""Fig. 8: EDP reduction from optical shift-and-add (PyTorch port of
`benchmarks/fig8_osa.py`).

Three bars per workload on the optimized (8,8) array, mixed mode:
  baseline      — no OSA: the ADC fires once per bit slot,
  + OSA         — default (unoptimized) ODE chain length,
  + ODE sizing  — chain sized to the full slot count (1 conversion/output).
Paper claims: OSA -29% EDP, OSA+ODE sizing -37% vs the no-OSA baseline.
The model is the scalar one (`core.energy`), as in the reference: a few
dozen layers need no device.  `device` is checked as in the other
launchers, so every launcher refuses alike without a card.

    python -m repro_torch.launch.fig8_osa [--device cpu] [--json PATH]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.paper_cnns import WORKLOADS
from repro_torch.core import energy as E
from repro_torch.core.constants import ROSA_OPTIMAL
from repro_torch.core.energy_vec import resolve_device
from repro_torch.launch import cli_device, write_json

# batched inference (paper Sec. 4 operating point): amortizes the 5 us
# thermo-optic weight programming across the batch's input streams
BATCH = 128


def run(verbose: bool = True,
        device: str | torch.device | None = None) -> dict:
    resolve_device(device)
    out = {}
    geo = {"no_osa": 1.0, "osa": 1.0, "osa_ode": 1.0}
    names = list(WORKLOADS)
    for name in names:
        layers = WORKLOADS[name]
        base = E.network_energy(layers, ROSA_OPTIMAL, osa=E.NO_OSA,
                                batch=BATCH).edp
        osa = E.network_energy(layers, ROSA_OPTIMAL, osa=E.OSA_DEFAULT,
                               batch=BATCH).edp
        opt = E.network_energy(layers, ROSA_OPTIMAL, osa=E.OSA_OPTIMAL,
                               batch=BATCH).edp
        out[name] = dict(no_osa=base, osa=osa, osa_ode=opt,
                         red_osa=1 - osa / base, red_ode=1 - opt / base)
        geo["osa"] *= (osa / base) ** (1 / len(names))
        geo["osa_ode"] *= (opt / base) ** (1 / len(names))
    if verbose:
        print(f"{'workload':14s} {'EDP no-OSA':>12s} {'+OSA':>12s} "
              f"{'+ODE sizing':>12s} {'dOSA':>7s} {'dODE':>7s}")
        for n, r in out.items():
            print(f"{n:14s} {r['no_osa']:12.4e} {r['osa']:12.4e} "
                  f"{r['osa_ode']:12.4e} {r['red_osa'] * 100:6.1f}% "
                  f"{r['red_ode'] * 100:6.1f}%")
        print(f"\ngeomean EDP reduction: OSA {100 * (1 - geo['osa']):.1f}% "
              f"(paper: 29%), OSA+ODE {100 * (1 - geo['osa_ode']):.1f}% "
              f"(paper: 37%)")
    out["geomean_reduction_osa"] = 1 - geo["osa"]
    out["geomean_reduction_osa_ode"] = 1 - geo["osa_ode"]
    return out


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
