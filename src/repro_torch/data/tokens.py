"""Deterministic synthetic LM token pipeline (PyTorch port of
`repro.data.tokens`).

The batch for step N is a pure function of (seed, N): after a restore the
pipeline resumes mid-stream with no sample lost or repeated.  Tokens
follow the reference's noisy bigram, next = (a * t_{-1} + noise) mod V,
drawn with the same numpy generator calls in the same order, so a batch
equals the reference's bit for bit; the tensors (int32) go on the
caller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise_levels: int = 7

    def batch(self, step: int, device=None) -> dict:
        """The full global batch of a step: tokens and next-token labels
        (B, seq_len), int32."""
        coef = np.random.default_rng(self.seed)     # per-run constants
        a = int(coef.integers(2, 8))
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s, v = self.global_batch, self.seq_len + 1, self.vocab
        noise = rng.integers(0, self.noise_levels, size=(b, s))
        toks = np.zeros((b, s), np.int64)
        toks[:, 0] = rng.integers(0, v, size=b)
        for t in range(1, s):
            # the map t_{-1} -> a t_{-1} is deterministic; the noise sets
            # the achievable loss floor at ln(noise_levels)
            toks[:, t] = (a * toks[:, t - 1] + noise[:, t]) % v
        toks = torch.from_numpy(toks.astype(np.int32))
        return {"tokens": toks[:, :-1].contiguous().to(device),
                "labels": toks[:, 1:].contiguous().to(device)}

    def shard_batch(self, step: int, shard: int, n_shards: int,
                    device=None) -> dict:
        """One data-parallel shard's slice of the step's batch (a rank's
        rows of the global batch); a batch that does not divide over the
        shards is refused."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"divide over {n_shards} shards")
        full = self.batch(step)
        per = self.global_batch // n_shards
        return {k: v[shard * per:(shard + 1) * per].to(device)
                for k, v in full.items()}
