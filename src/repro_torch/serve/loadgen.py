"""Synthetic request streams for serving benchmarks and tests (a copy of
`repro.serve.loadgen`: the same numpy draws give the same requests).

Arrivals are a Poisson process expressed in scheduler TICKS (exponential
inter-arrival gaps of mean 1/rate), prompt and generation lengths are
uniform over closed ranges — all drawn from one `numpy` Generator seeded
explicitly, so a (seed, rate, ranges) tuple is a fully reproducible
workload.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serve.scheduler import Request


def poisson_requests(n: int, rate: float, *, vocab: int,
                     prompt_len: tuple[int, int] = (4, 16),
                     gen_len: tuple[int, int] = (2, 16),
                     seed: int = 0,
                     start_rid: int = 0) -> list[Request]:
    """`n` requests with Poisson(rate-per-tick) arrivals.

    rate <= 0 means everything arrives at tick 0 (closed-loop load).
    """
    if n < 1:
        raise ValueError("n must be >= 1")
    rng = np.random.default_rng(seed)
    if rate > 0:
        gaps = rng.exponential(1.0 / rate, size=n)
        arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    else:
        arrivals = np.zeros(n, np.int64)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        glen = int(rng.integers(gen_len[0], gen_len[1] + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=start_rid + i, prompt=prompt,
                            max_new_tokens=glen,
                            arrival=int(arrivals[i])))
    return reqs
