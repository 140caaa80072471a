"""Launch arithmetic of the skinny-M streaming path
(`csrc/skinny_stream.cuh`), shared by the `osa_matmul` and `rosa_fused`
wrappers: the constants mirror the header's, and `decode_plan` is what
both launchers run (and what their `preflight`s report) for M <= 16.
"""

from __future__ import annotations

BN = 128          # columns per block (32 lanes x float4)
BK = 32           # weight rows per ring stage
STAGES = 6        # ring depth
PER_SM = 16       # blocks per SM the K split aims at
MAX_M = 16        # rows the decode path takes; more take the tall path
SMEM_LIMIT = 232448       # dynamic shared memory a block may use (227 KB)
MAX_GRID_Y = 65535


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad4(m: int) -> int:
    return cdiv(m, 4) * 4


def decode_plan(m: int, k: int, n: int, *, n_sm: int, planes: int) -> dict:
    """Grid, K split and shared memory of the decode path for an (m, k, n)
    contraction with `planes` activation planes per row (1 unless the
    per-plane mode).

    K is split across blocks (grid y) until there are about PER_SM blocks
    per SM, keeping at least four ring stages per block; each split covers
    a whole number of stages.  The activation workspace holds k *
    planes * pad4(m) floats, the partial tiles splits * m * n when K is
    split."""
    tiles = cdiv(n, BN)
    splits = max(1, min(cdiv(PER_SM * n_sm, tiles), cdiv(k, 4 * BK),
                        MAX_GRID_Y))
    k_per_split = cdiv(cdiv(k, splits), BK) * BK
    splits = cdiv(k, k_per_split)
    mp = pad4(m)
    smem = 4 * STAGES * (BK * BN + BK * planes * mp)
    in_flight = (2 if planes == 1 else 1) * smem
    return {"path": "decode", "grid": (tiles, splits, 1), "splits": splits,
            "k_per_split": k_per_split, "n_tile": BN,
            "smem_bytes": smem, "bytes_in_flight_per_sm": in_flight,
            "operand_floats": k * planes * mp,
            "part_floats": splits * m * n if splits > 1 else 0}
