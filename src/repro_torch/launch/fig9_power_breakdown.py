"""Fig. 9: component-wise power with / without OSA (PyTorch port of
`benchmarks/fig9_power_breakdown.py`).

Average power = component energy / runtime for four CNN workloads on the
(8,8) array.  The paper's observation to reproduce: OSA cuts OAC (PD+TIA)
and ADC power, and also the partial-sum SRAM + main-memory traffic.  The
model is the scalar one (`core.energy`), as in the reference; `device` is
checked as in the other launchers.

    python -m repro_torch.launch.fig9_power_breakdown [--device cpu] \\
        [--json PATH]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.paper_cnns import CNN_WORKLOADS
from repro_torch.core import energy as E
from repro_torch.core.constants import ROSA_OPTIMAL
from repro_torch.core.energy_vec import resolve_device
from repro_torch.launch import cli_device, write_json

COMPONENTS = ("laser", "mrr_static", "odl_static", "sram_leak", "eo_mod",
              "dac_prog", "pd_tia", "adc", "sram_dyn", "dram")


def run(verbose: bool = True,
        device: str | torch.device | None = None) -> dict:
    resolve_device(device)
    out = {}
    for name, layers in CNN_WORKLOADS.items():
        rows = {}
        for tag, osa in (("no_osa", E.NO_OSA), ("osa", E.OSA_OPTIMAL)):
            bd = E.network_energy(layers, ROSA_OPTIMAL, osa=osa,
                                  batch=128)
            rows[tag] = {c: getattr(bd, c) / bd.latency
                         for c in COMPONENTS}
            rows[tag]["total"] = bd.energy / bd.latency
        out[name] = rows
    if verbose:
        for name, rows in out.items():
            print(f"\n{name}  (avg power [W])")
            print(f"  {'component':12s} {'no OSA':>11s} {'with OSA':>11s}")
            for c in COMPONENTS + ("total",):
                a, b = rows["no_osa"][c], rows["osa"][c]
                mark = " <-" if b < a * 0.7 and a > 1e-6 else ""
                print(f"  {c:12s} {a:11.4e} {b:11.4e}{mark}")
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
