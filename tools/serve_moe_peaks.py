#!/usr/bin/env python3
"""The card's memory at each prefill length of `chip_smoke.py` phase 24's
cells.  For each length one group of 4 ranks on card 0 (gloo, as the
phase runs them) serves the cell's prefill on its SERVE_RULES shards
through `chip_smoke.sr_rank`; the script prints one JSON line a length:
each rank's peak (`torch.cuda.max_memory_allocated`), their sum beside
`chip_smoke.PEAK_GIB`, the step's wall, or the error of a group that
failed (out of memory), and goes on to the next length.  Phase 24's
`SP_PREFILL` holds the longest whose sum stays under PEAK_GIB.  Needs a
CUDA card; run from the repository's root:

    python3 tools/serve_moe_peaks.py
    python3 tools/serve_moe_peaks.py --arch deepseek-v2-236b \\
        --lengths 2x1024 2x2048
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# rows x positions, ascending; then one row of 4096 positions (a rank
# holds all its tokens: cutting the rows does not shrink its buffers)
LADDER = {"qwen3-moe-235b-a22b": ("2x1024", "2x1536", "2x2048", "1x4096"),
          "deepseek-v2-236b": ("2x512", "2x768", "2x1024", "2x2048",
                               "1x4096")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="*", choices=sorted(LADDER),
                    default=sorted(LADDER, reverse=True))
    ap.add_argument("--lengths", nargs="*",
                    help="rows x positions, e.g. 2x2048 (default: each "
                    "arch's ladder)")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_moe_peaks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch import kernels
    from repro_torch.distributed import runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    print(CS.card_line(), flush=True)
    for arch in opts.arch:
        # the arch's first prefill cell's overrides (deepseek-v2: optical)
        ov = next(c[3] for c in CS.SP_CELLS
                  if c[1] == arch and c[5][1] == "prefill")
        ov = {k: v for k, v in ov.items() if k != "capacity_factor"}
        for length in opts.lengths or LADDER[arch]:
            b, n = (int(x) for x in length.split("x"))
            CS.SP_PREFILL[arch] = (b, n)
            cell = CS.sp_cell("p", arch, "prefill", **ov)
            row = {"arch": arch, "rows": b, "positions": n}
            t0 = time.perf_counter()
            try:
                outs = runtime.spawn(CS.sr_rank, 4, device_type="cuda",
                                     backend="gloo",
                                     args=({"cells": (cell,)},),
                                     timeout=CS.RANK_TIMEOUT)
                peaks = [o["p"]["peak_bytes"] / 2**30 for o in outs]
                row.update(ok=True, peaks_gib=peaks, card_gib=sum(peaks),
                           under=sum(peaks) < CS.PEAK_GIB,
                           step_ms=1e3 * max(o["p"]["walls"][-1]
                                             for o in outs))
            except runtime.RankError as e:
                lines = [x for x in str(e).splitlines() if x.strip()]
                row.update(ok=False, error=" | ".join(
                    [lines[0]] + [x for x in lines if "memory" in x][:1]))
            row["group_s"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
