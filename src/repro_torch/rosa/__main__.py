"""Offline plan-cache maintenance: `python -m repro_torch.rosa stats|gc`.

The serving stack bounds its cache online (`PlanCache(max_entries=...)`
collects after every store); this CLI is the operator's view of a store on
disk: how big it has grown, what is hot, and a manual prune for roots that
were written unbounded.  It only touches files (no device).

    python -m repro_torch.rosa stats [--root PATH]
    python -m repro_torch.rosa gc --max-entries N [--root PATH]
"""

from __future__ import annotations

import argparse
import json

from repro_torch.rosa.program import PlanCache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.rosa",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_stats = sub.add_parser("stats", help="summarize a plan-cache store")
    p_gc = sub.add_parser("gc", help="evict LRU entries beyond a bound")
    p_gc.add_argument("--max-entries", type=int, required=True,
                      help="keep at most N entries (plans + matrices)")
    for p in (p_stats, p_gc):
        p.add_argument("--root", default=None,
                       help="cache root (default: $ROSA_PLAN_CACHE or "
                            "~/.cache/rosa-repro/plans)")
    args = ap.parse_args(argv)

    cache = PlanCache(args.root)
    if args.cmd == "gc":
        evicted = cache.gc(args.max_entries)
        print(json.dumps({"evicted": evicted, **cache.stats()}, indent=1))
    else:
        print(json.dumps(cache.stats(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
