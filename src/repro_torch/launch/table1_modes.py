"""Table 1: analog vs digital vs mixed computing modes (PyTorch port of
`benchmarks/table1_modes.py`).

Throughput / update-time / OPS formulas evaluated on the paper's array
sizes, plus the energy model's view of one representative conv layer under
each mode (the robustness column comes from the behavioural runs of
launch/table4).  Scalar arithmetic (`core.energy`), as in the reference;
`device` is checked as in the other launchers.

    python -m repro_torch.launch.table1_modes [--device cpu] [--json PATH]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import energy as E
from repro_torch.core.constants import ComputeMode, OPEConfig
from repro_torch.core.energy_vec import resolve_device
from repro_torch.launch import cli_device, write_json

LAYER = E.LayerShape("conv3", m=64, k=1728, n=384)


def run(verbose: bool = True,
        device: str | torch.device | None = None) -> dict:
    resolve_device(device)
    ope = OPEConfig(rows=8, cols=8, tiles=16)
    rows = {}
    for mode, name in [(ComputeMode.ANALOG, "analog (DEAP-CNNs)"),
                       (ComputeMode.DIGITAL, "digital (HolyLight)"),
                       (ComputeMode.MIXED, "mixed (ROSA)")]:
        ops = {ComputeMode.ANALOG: E.ops_analog,
               ComputeMode.DIGITAL: E.ops_digital,
               ComputeMode.MIXED: E.ops_mixed}[mode](ope)
        bd = E.layer_energy(LAYER, ope, mode=mode)
        rows[mode.value] = dict(name=name, ops=ops, latency=bd.latency,
                                energy=bd.energy, edp=bd.edp,
                                oadc_energy=bd.adc + bd.pd_tia)
    if verbose:
        print(f"{'mode':22s} {'OPS':>12s} {'latency[s]':>12s} "
              f"{'energy[J]':>12s} {'EDP[J*s]':>12s} {'OADC[J]':>10s}")
        for r in rows.values():
            print(f"{r['name']:22s} {r['ops']:12.3e} {r['latency']:12.3e} "
                  f"{r['energy']:12.3e} {r['edp']:12.3e} "
                  f"{r['oadc_energy']:10.3e}")
        mx, an = rows["mixed"], rows["analog"]
        print(f"\nmixed vs analog: {an['latency'] / mx['latency']:.0f}x "
              f"faster, OPS x{mx['ops'] / an['ops']:.1f}")
    return rows


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
