"""Launch arithmetic of the chunk-parallel `ssd_scan` and the tiled
`mrr_transfer` CUDA kernels, pinned without a card.

`ssd_scan.ops.plan` / `preflight` and `mrr_transfer.ops.plan` /
`preflight` are what the launchers run, so these tests hold the grids
(grid y <= 65535 where the batch or the row tiles sit), shared memory per
block (<= 232,448 bytes), the workspace, the resident blocks per SM and the
operations executed against the values the kernels' design gives; the
`ssd_scan` preflight is held against the reference's on the keys that mean
the same thing.  The layout detection of a chip's per-lane fields runs on
CPU tensors.  Kernel-vs-plain parity on the card lives in
`tests/test_torch_ssm.py` and `tests/test_torch_mrr_transfer.py`.
"""

import pytest
import torch

from repro_torch.core import mrr as TM
from repro_torch.kernels.mrr_transfer import ops as mrr_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from test_torch_ref import reference

SERVED = (1, 512, 64, 64, 128)          # B, L, H, P, S of mamba2-1.3b
SMEM_LIMIT = 232448
N_SM = 132


@pytest.fixture(scope="module")
def R():
    return reference()


def _needed_flops(bsz, l, h, p, g, s, q):
    """Float operations the chunked form needs (chip_smoke.ssd_bound's
    count): C B^T on the causal triangle once per group; per head the
    decay mask, att X on the triangle, C S_in from the second chunk on,
    the carry and the state decay."""
    flops = 0
    for lo in range(0, l, q):
        n = min(q, l - lo)
        tri = n * (n + 1) // 2
        flops += bsz * g * 2 * tri * s
        flops += bsz * h * (2 * tri + 2 * tri * p + 2 * n * s * p + n * s
                            + s * p + (2 * n * s * p + n * p if lo else 0))
    return flops


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,chunk", [
    (SERVED, 128), ((2, 300, 2, 8, 16), 128), ((1, 37, 4, 8, 16), 16),
    ((3, 1000, 8, 64, 64), 64)])
def test_ssd_preflight_agrees_with_reference(R, shape, chunk):
    ours = ssd_ops.preflight(*shape, chunk=chunk)
    theirs = R.ssd_ops.preflight(*shape, chunk=chunk)
    assert ours["kernel"] == theirs["kernel"] == "ssd_scan"
    assert ours["pad_waste"] == pytest.approx(theirs["pad_waste"], abs=0)
    assert ours["issues"] == theirs["issues"] == []


@pytest.mark.parametrize("shape", [(0, 512, 64, 64, 128),
                                   (1, 512, 64, 0, 128)])
def test_ssd_preflight_flags_non_positive_dims_as_reference(R, shape):
    assert ssd_ops.preflight(*shape)["issues"]
    assert R.ssd_ops.preflight(*shape)["issues"]


@pytest.mark.parametrize("bsz,l", [(65535, 512), (1, 1_000_000)])
def test_ssd_grids_within_limits(bsz, l):
    pf = ssd_ops.preflight(bsz, l, 64, 64, 128)
    assert pf["issues"] == []
    for ln in pf["launches"]:
        gx, gy, gz = ln["grid"]
        assert gy == bsz and gy <= 65535 and gz == 1
        assert 1 <= gx <= 2**31 - 1
    assert ssd_ops.preflight(65536, 512, 64, 64, 128)["issues"]


@pytest.mark.parametrize("s_dim", [16, 64, 128, 256])
def test_ssd_shared_memory_per_block(s_dim):
    pf = ssd_ops.preflight(1, 512, 64, 64, s_dim)
    assert pf["issues"] == []
    assert all(ln["smem_bytes"] <= SMEM_LIMIT for ln in pf["launches"])
    # strips of S stage through shared memory: its size does not grow
    assert pf["smem_bytes"] == ssd_ops.preflight(1, 512, 64, 64, 16)[
        "smem_bytes"]


def test_ssd_workspace_at_served_shape():
    pf = ssd_ops.preflight(*SERVED)
    ws = pf["workspace_floats"]
    assert pf["n_chunks"] == 4
    assert ws == {"l": 64 * 4 * 128, "cbt": 4 * 128 * 128,
                  "states": 64 * 4 * 128 * 64}
    assert 4 * ws["cbt"] == 256 * 1024        # C B^T of the group, in L2
    assert pf["workspace_bytes"] == 4 * sum(ws.values())


def test_ssd_resident_blocks_and_grid_fill_at_served_shape():
    pf = ssd_ops.preflight(*SERVED)
    by = {ln["name"]: ln for ln in pf["launches"]}
    assert list(by) == ["ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out"]
    assert all(ln["blocks_per_sm"] >= 2 for ln in pf["launches"])
    # 64 heads x 4 chunks x 2 state tiles, then C B^T once per (group,
    # chunk): the 10 tiles of a 4 x 4 triangle
    assert pf["cbt_blocks"] == 10 * 4
    assert by["ssd_chunk_state"]["grid"] == (64 * 4 * 2 + 10 * 4, 1, 1)
    # the outputs: 64 heads x 4 chunks x 2 row tiles, >= 2 per SM
    assert by["ssd_chunk_out"]["grid"] == (64 * 4 * 2, 1, 1)
    assert by["ssd_chunk_out"]["grid"][0] >= 2 * N_SM


@pytest.mark.parametrize("shape", [
    (1, 512, 64, 64, 1, 128, 128), (1, 700, 64, 64, 1, 128, 128),
    (2, 300, 8, 64, 8, 64, 128)])
def test_ssd_executed_flops_within_1p5x_of_needed(shape):
    bsz, l, h, p, g, s, q = shape
    executed = ssd_ops.plan(bsz, l, h, p, g, s, q)["flops"]
    needed = _needed_flops(bsz, l, h, p, g, s, q)
    assert needed <= executed <= 1.5 * needed
    if shape[:3] == (1, 512, 64):
        assert executed <= 1.85e9   # one block per (b, h, P slice): 3.76e9


def test_ssd_chunk_bounds_raise_before_any_launch():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_ops.launch(x, torch.zeros(1, 4, 2), torch.zeros(1, 4, 1, 8),
                       torch.zeros(1, 4, 1, 8), 8)
    assert ssd_ops.preflight(1, 512, 64, 64, 128, chunk=256)["issues"]


# ---------------------------------------------------------------------------
# ssd_scan backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s_dim", [128, 64])     # mamba2-1.3b, zamba2-1.2b
def test_ssd_backward_grids_and_shared_memory_at_train_shape(s_dim):
    pb = ssd_ops.plan_backward(8, 256, 64, 64, 1, s_dim, 128)
    by = {ln["name"]: ln for ln in pb["launches"]}
    ns = s_dim // 64
    # D in 64 x 64 tiles: the 3 of a 2 x 2 triangle; its row and column
    # sums on the 4 quarters of a chunk's 32-row tiles
    assert pb["tiles"] == (3, ns, 1, 2, 4)
    # launch 1: per (head, chunk) ns state tiles and 3 tiles of D
    assert by["ssd_bwd_chunk"]["grid"] == ((ns + 3) * 2 * 64, 8, 1)
    assert by["ssd_bwd_state"]["grid"] == (64 * s_dim * 64 // (256 * 4), 8,
                                           1)
    # launch 3: per (head, chunk, 64-row tile) dX on P and dB, dC on S
    assert by["ssd_bwd_grads"]["grid"] == ((1 + 2 * ns) * 2 * 2 * 64, 8, 1)
    assert by["ssd_bwd_finish"]["grid"] == (2 * 64 + 256 * s_dim // 256, 8,
                                            1)
    # three ring slots of an A and a B strip (64 x 36 floats each), a
    # staged 64 x 72 tile, l
    smem = 4 * (3 * 2 * 64 * 36 + 64 * 72 + 128)
    assert by["ssd_bwd_chunk"]["smem_bytes"] == smem == 74240
    assert by["ssd_bwd_grads"]["smem_bytes"] == smem
    assert by["ssd_bwd_finish"]["smem_bytes"] == 4 * (2 * 128 + 256)
    # three blocks' shared memory fit an SM (the runtime reserves 1 KB a
    # block); the launch bounds guarantee two
    assert 3 * (smem + 1024) <= 233472 < 4 * (smem + 1024)
    assert all(ln["blocks_per_sm"] == 2 for ln in pb["launches"])


# ---------------------------------------------------------------------------
# mrr_transfer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,grid", [
    (1, (1, 1, 1)), (1500, (2, 1, 1)), (1_000_003, (977, 1, 1)),
    (5120 * 51200, (32000, 1, 1))])
def test_mrr_plan_one_stream_without_a_chip(n, grid):
    """Without a chip the elements are one stream of float4 segments; a
    thread takes up to 8 of them, fewer until 132 SMs get 8 blocks each."""
    pf = mrr_ops.preflight(n)
    assert pf["issues"] == [] and pf["pad_waste"] == 0.0
    assert (pf["rows"], pf["cols"]) == (n, 1)
    assert pf["vec"] == 4 and pf["grid"] == grid
    assert pf["per"] == (8 if n == 5120 * 51200 else 1)
    assert pf["bytes"] == 16 * n


@pytest.mark.parametrize("lanes", ["row", "col"])
def test_mrr_plan_wide_sheet_both_orientations(lanes):
    pf = mrr_ops.preflight(5120 * 51200, shape=(5120, 51200), lanes=lanes,
                           noisy=False)
    assert pf["issues"] == []
    assert (pf["rows"], pf["cols"]) == (5120, 51200)
    assert pf["vec"] == 4 and pf["tile"] == (64, 128)
    assert pf["grid"] == (400, 80, 1) and pf["row_tiles_per_block"] == 1
    assert pf["bytes"] == 8 * 5120 * 51200 + 12 * (
        5120 if lanes == "row" else 51200)


def test_mrr_plan_ragged_rows_and_grid_y_cap():
    # (M, K) activations with K = 27: rows start unaligned, 1 lane each
    pf = mrr_ops.preflight(524288 * 27, shape=(524288, 27), lanes="col")
    assert pf["vec"] == 1 and pf["grid"] == (1, 8192, 1)
    # without a chip the same sheet is one aligned stream
    flat = mrr_ops.preflight(524288 * 27, shape=(524288, 27))
    assert (flat["rows"], flat["cols"], flat["vec"]) == (524288 * 27, 1, 4)
    # the main path's depthwise weight: one row a warp, 8 blocks
    dw = mrr_ops.preflight(60 * 25, shape=(60, 25), lanes="row")
    assert (dw["vec"], dw["per"], dw["grid"]) == (1, 1, (1, 8, 1))
    big = mrr_ops.preflight(10**7 * 27, shape=(10**7, 27), lanes="col")
    assert big["grid"][1] == 65535 and big["row_tiles_per_block"] == 3


def test_mrr_lane_layouts_of_expand_lanes():
    k, n = 6, 10
    lane = TM.StaticVariation(torch.rand(k), torch.rand(k), torch.rand(k))
    w = torch.zeros(k, n)              # (K, N) weight: one value a row
    for f in (TM.expand_lanes(lane, w).dv, TM.expand_lanes(lane, w).dlam):
        assert mrr_ops._per_row(f, w.shape, k)
        assert not mrr_ops._per_col(f, w.shape, n)
    x = torch.zeros(3, k)              # (M, K) activations: one a column
    f = TM.expand_lanes(lane, x).ddt
    assert mrr_ops._per_col(f, x.shape, k)
    assert not mrr_ops._per_row(f, x.shape, 3)
    full = torch.rand(k, n)            # any other broadcast: strided view
    assert not mrr_ops._per_row(full, w.shape, k)
    assert not mrr_ops._per_col(full, w.shape, n)


@pytest.mark.parametrize("event,fam", [
    ("(anonymous namespace)::ssd_chunk_state(float const*, float const*)",
     "ssd_scan kernel"),
    ("void (anonymous namespace)::ssd_state_pass<4>(float const*, float*)",
     "ssd_scan kernel"),
    ("(anonymous namespace)::ssd_chunk_out(float const*, float const*)",
     "ssd_scan kernel"),
    ("(anonymous namespace)::ssd_bwd_chunk((anonymous namespace)::BwdPtrs, "
     "(anonymous namespace)::Dims)", "ssd_scan backward kernel"),
    ("void (anonymous namespace)::ssd_bwd_state<4>((anonymous namespace)::"
     "BwdPtrs, (anonymous namespace)::Dims)", "ssd_scan backward kernel"),
    ("void (anonymous namespace)::transfer_kernel_tiles<true, 1, 4>(float "
     "const*)", "mrr_transfer kernel"),
    ("void (anonymous namespace)::transfer_kernel_flat<false, 4>(float "
     "const*)", "mrr_transfer kernel")])
def test_profiles_book_the_kernels_under_their_families(event, fam):
    from repro_torch.launch.profile_serve import family
    assert family(event) == fam


def test_mrr_fields_pass_lane_vectors_or_strided_views():
    """What the launcher hands the kernel for a chip: per-row and
    per-column lane vectors as they are (their stride along the lane
    axis), any other broadcast as (row, column) strides of the sheet."""
    k, n = 6, 10
    lane = TM.StaticVariation(torch.rand(k), torch.rand(k), torch.rand(k))
    w = torch.zeros(k, n)
    mode, st, held = mrr_ops._fields(TM.expand_lanes(lane, w), w, k, n)
    assert mode == mrr_ops.VAR_ROW and list(st.s0) == [1, 1, 1]
    assert list(st.p) == [f.data_ptr() for f in (lane.dv, lane.ddt,
                                                 lane.dlam)]
    x = torch.zeros(3, k)
    mode, st, _ = mrr_ops._fields(TM.expand_lanes(lane, x), x, 3, k)
    assert mode == mrr_ops.VAR_COL and list(st.s1) == [1, 1, 1]
    full = TM.StaticVariation(*(torch.rand(k, n) for _ in range(3)))
    mode, st, held = mrr_ops._fields(full, w, k, n)
    assert mode == mrr_ops.VAR_ANY
    assert list(st.s0) == [n] * 3 and list(st.s1) == [1] * 3
    assert all(h.shape == (k, n) for h in held)
