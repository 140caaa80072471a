#!/usr/bin/env python3
"""Transfer rates of ranks that share one card: gloo's own `all_reduce`
and `all_gather` on CUDA and on CPU tensors, the runtime's `psum` and
`all_gather` of CUDA tensors (through card buffers mapped across the
ranks), and the card's copies to and from pageable, page-locked and
shared host memory, at 256 MiB a rank, on 2 and 4 ranks
(`repro_torch.distributed.runtime.spawn`, gloo, card 0).  It is why
`distributed.runtime` carries the CUDA collectives of ranks that share a
card through card buffers and not through gloo.

    python3 tools/rank_transfer_rates.py      # from the repository root,
                                              # on a host with a CUDA card
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import runtime  # noqa: E402


def timed(fn, n: int = 3) -> float:
    """Seconds a call, the mean of `n` after one warm-up, every rank
    aligned by a barrier."""
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    return (time.perf_counter() - t0) / n


def rates(rank: int, world: int, device) -> dict:
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(world, 1, "cuda")
    out = {}
    for mib in (256,):
        n = mib * 2**20 // 4
        x = torch.ones(n, device=device)
        xc = torch.ones(n)
        parts = [torch.empty_like(x) for _ in range(world)]
        pin = torch.empty(n, pin_memory=True)
        shm = torch.empty(n).share_memory_()
        cases = {"allreduce_cuda": lambda: dist.all_reduce(x),
                 "allreduce_cpu": lambda: dist.all_reduce(xc),
                 "allgather_cuda": lambda: dist.all_gather(parts, x),
                 "psum_card": lambda: runtime.psum(x, "data", mesh),
                 "allgather_card": lambda: runtime.all_gather(
                     x, "data", tiled=True, mesh=mesh),
                 "d2h_pageable": lambda: xc.copy_(x),
                 "d2h_pinned": lambda: pin.copy_(x),
                 "d2h_shm": lambda: shm.copy_(x),
                 "h2d_pageable": lambda: x.copy_(xc),
                 "h2d_pinned": lambda: x.copy_(pin),
                 "h2d_shm": lambda: x.copy_(shm)}
        for name, fn in cases.items():
            out[(name, mib)] = timed(fn)
        del x, parts, pin, shm
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_transfer_rates: no CUDA device", file=sys.stderr)
        return 1
    for world in (2, 4):
        res = runtime.spawn(rates, world, device_type="cuda",
                            backend="gloo", timeout=600)[0]
        for (name, mib), s in res.items():
            print(f"{world} ranks  {name:15s} {mib:5d} MiB  "
                  f"{s * 1e3:8.1f} ms  {mib / 1024 / s:6.2f} GB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
