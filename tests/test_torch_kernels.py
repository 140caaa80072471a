"""Port parity of the two kernel modules against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version (the kernel's
arithmetic in PyTorch ops); the reference runs its Pallas kernels in
interpret mode.  Tolerances:

  * rosa_fused: the flip-aware one-LSB bound (`assert_quantized_parity`):
    the two packages realize operands a few ulps apart (test_torch_core),
    so a conditioned activation near a requantization boundary may flip
    one 8-bit code;
  * osa_matmul: float32 rtol 1e-5 (another summation order; the codes and
    the digit recombination are exact).

Cases run with the chip's static variation pinned (carried across as
numbers) or ideal; per-shot draws differ between the packages, so noisy
cases hold the kernel path against the port's own composed chain, which
draws the same numbers from the same key.

Tests marked `cuda` launch the CUDA kernels and skip without a card.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import constants as TC
from repro_torch.core import mrr as TM
from repro_torch.core import osa as TO
from repro_torch.core.constants import ComputeMode, Mapping
from repro_torch.kernels.osa_matmul import ops as osa_ops
from repro_torch.kernels.rosa_fused import ops as fused_ops
from repro_torch.kernels.rosa_fused import ref as fused_ref
from test_torch_ref import assert_quantized_parity, reference, to_np

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def R():
    return reference()


def _operands(m, k, n, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(m, k)).astype(np.float32)
    w = r.normal(size=(k, n)).astype(np.float32)
    dv = (0.01 * r.normal(size=(k,))).astype(np.float32)
    return x, w, dv


def _vars(R, dv):
    j = R.mrr.StaticVariation(dv=R.jnp.asarray(dv), ddt=R.jnp.float32(0.05),
                              dlam=R.jnp.float32(1e-4))
    t = TM.StaticVariation(dv=torch.from_numpy(dv), ddt=torch.tensor(0.05),
                           dlam=torch.tensor(1e-4))
    return j, t


_NONIDEAL = {"splitter_imbalance": 0.01, "odl_loss_db_per_stage": 0.05}

# (m, k, n, seed, kwargs)
_FUSED_CASES = [
    (8, 16, 8, 0, {}),                                   # WS, pinned chip
    (12, 70, 33, 1, {"mapping": "IS"}),
    (12, 70, 33, 2, {"mapping": "IS", "apv": True}),
    (9, 130, 40, 3, {"apv": True}),                      # K not 128-aligned
    (4, 200, 24, 4, {"mapping": "IS", "apv": True}),     # serving-like rows
    (8, 32, 8, 5, {"with_var": False}),                  # ideal shortcut
    (9, 33, 8, 6, {"gate": 0.3}),
    (16, 48, 24, 7, {"mgate": 0.5, "apv": True}),        # mapping superposition
    (8, 40, 16, 8, {"mode": "ANALOG"}),
    (8, 40, 16, 9, {"mode": "ANALOG", "gate": 0.7}),
    (8, 24, 8, 10, {"pam_bits": 2}),                     # PAM-4 digits
    (8, 24, 8, 11, {"pam_bits": 2, "nonideal_osa": True}),
    # robust.sensitivity's gated evaluator: one-hot analog gates (0 or 1)
    # and constant mapping gates (0 = WS, 1 = IS), rows past the decode path
    (24, 72, 16, 12, {"gate": 0.0, "mgate": 0.0}),
    (24, 72, 16, 13, {"gate": 1.0, "mgate": 0.0}),
    (24, 72, 16, 14, {"gate": 0.0, "mgate": 1.0}),
    (24, 72, 16, 15, {"gate": 1.0, "mgate": 1.0}),
]


def _fused_kwargs(side, mapping="WS", mode="MIXED", apv=False, pam_bits=1,
                  nonideal_osa=False):
    osa_cfg = (side.osa.OSAConfig(**_NONIDEAL) if nonideal_osa
               else side.osa.IDEAL_OSA)
    return dict(mapping=side.constants.Mapping[mapping],
                mode=side.constants.ComputeMode[mode], act_per_vector=apv,
                pam_bits=pam_bits, osa_cfg=osa_cfg)


# the port's modules under the names `_fused_kwargs` reads
_Port = types.SimpleNamespace(constants=TC, osa=TO)


@pytest.mark.parametrize("m,k,n,seed,kw", _FUSED_CASES)
def test_fused_plain_matches_reference_kernel_and_chain(R, m, k, n, seed,
                                                        kw):
    """Plain rosa_fused_matmul vs the reference kernel (interpret) and vs
    the reference's composed chain; the port's own composed chain too."""
    kw = dict(kw)
    with_var = kw.pop("with_var", True)
    gate, mgate = kw.pop("gate", None), kw.pop("mgate", None)
    x, w, dv = _operands(m, k, n, seed)
    var_j, var_t = _vars(R, dv) if with_var else (None, None)
    y = fused_ops.rosa_fused_matmul(
        torch.from_numpy(x), torch.from_numpy(w), None, var_t, gate, mgate,
        **_fused_kwargs(_Port, **kw))
    jx, jw = R.jnp.asarray(x), R.jnp.asarray(w)
    y_kernel = R.fused_ops.rosa_fused_matmul(
        jx, jw, None, var_j, gate, mgate, bm=8, bn=128, bk=128,
        **_fused_kwargs(R, **kw))
    y_chain = R.fused_ref.rosa_fused_ref(jx, jw, None, var_j, gate, mgate,
                                         **_fused_kwargs(R, **kw))
    y_port_chain = fused_ref.rosa_fused_ref(
        torch.from_numpy(x), torch.from_numpy(w), None, var_t, gate, mgate,
        **_fused_kwargs(_Port, **kw))
    assert y.shape == (m, n) and y.dtype == torch.float32
    assert_quantized_parity(y, y_port_chain)
    assert_quantized_parity(y, y_kernel)
    assert_quantized_parity(y, y_chain)
    assert_quantized_parity(y_port_chain, y_chain)


@pytest.mark.parametrize("mapping,mgate,mode", [
    ("WS", None, "MIXED"), ("IS", None, "MIXED"), ("WS", 0.4, "MIXED"),
    ("WS", None, "ANALOG")])
def test_fused_noisy_matches_port_chain(mapping, mgate, mode):
    """Per-shot noise: the fused path and the composed chain split the same
    key the same way, so they see the same draws."""
    x, w, dv = _operands(10, 150, 20, 12)
    var = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.05),
                             torch.tensor(1e-4))
    kw = dict(mapping=Mapping[mapping], mode=ComputeMode[mode],
              noise=TM.PAPER_NOISE, act_per_vector=True)
    key = torch.Generator().manual_seed(3)
    y = fused_ops.rosa_fused_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    key, var, None, mgate, **kw)
    y_ref = fused_ref.rosa_fused_ref(torch.from_numpy(x), torch.from_numpy(w),
                                     key, var, None, mgate, **kw)
    assert_quantized_parity(y, y_ref)
    other = fused_ops.rosa_fused_matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.Generator().manual_seed(4), var, None, mgate, **kw)
    assert not torch.equal(y, other)


def test_fused_contract_errors():
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    with pytest.raises(ValueError, match="DIGITAL"):
        fused_ops.rosa_fused_matmul(x, w, mode=ComputeMode.DIGITAL)
    with pytest.raises(ValueError, match="jitter"):
        fused_ops.rosa_fused_matmul(
            x, w, osa_cfg=TO.OSAConfig(slot_jitter_sigma=0.1))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m,k,n,per_vector,pam_bits", [
    (8, 64, 24, False, 1), (5, 130, 17, True, 1), (4, 33, 9, False, 2)])
def test_osa_matmul_plain_matches_reference_kernel(R, fused, m, k, n,
                                                   per_vector, pam_bits):
    x, w, _ = _operands(m, k, n, m + k)
    y = osa_ops.osa_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           pam_bits=pam_bits, fused=fused,
                           per_vector=per_vector)
    want = R.osa_ops.osa_matmul(R.jnp.asarray(x), R.jnp.asarray(w),
                                pam_bits=pam_bits, fused=fused,
                                per_vector=per_vector)
    np.testing.assert_allclose(to_np(y), to_np(want), rtol=1e-5, atol=1e-4)


def test_osa_matmul_int_ideal_gains_equal_q_at_w(R):
    """Under ideal gains the recombined planes are q itself, so both modes
    equal q @ w, the reference oracle's answer."""
    r = np.random.default_rng(0)
    q = r.integers(-127, 128, size=(6, 50)).astype(np.float32)
    w = r.normal(size=(50, 11)).astype(np.float32)
    g = torch.tensor([2.0 ** t for t in range(7)])
    oracle = to_np(R.osa_ref.osa_matmul_ref(R.jnp.asarray(q),
                                            R.jnp.asarray(w)))
    for fused in (True, False):
        y = osa_ops.osa_matmul_int(torch.from_numpy(q), torch.from_numpy(w),
                                   g, n_planes=7, fused=fused)
        np.testing.assert_allclose(to_np(y), oracle, rtol=1e-5, atol=1e-4)


def test_cpu_calls_never_reach_the_kernel_loader(monkeypatch):
    """A CPU tensor takes the plain version: no nvcc, no library, no
    launch counted."""
    def boom(*a, **k):
        raise AssertionError("kernel loader reached from a CPU call")

    monkeypatch.setattr(kernels, "library", boom)
    monkeypatch.setattr(kernels, "build_all", boom)
    fused_ops._lib.cache_clear()
    osa_ops._lib.cache_clear()
    n_f, n_o = fused_ops.LAUNCHES.count, osa_ops.LAUNCHES.count
    x, w, dv = _operands(4, 40, 12, 1)
    var = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.0),
                             torch.tensor(0.0))
    fused_ops.rosa_fused_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                None, var, mapping=Mapping.IS)
    osa_ops.osa_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert (fused_ops.LAUNCHES.count, osa_ops.LAUNCHES.count) == (n_f, n_o)


def test_launch_refuses_cpu_tensors_and_missing_nvcc(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="CUDA"):
        osa_ops.launch(torch.zeros(2, 3), torch.zeros(3, 4), torch.ones(7),
                       n_planes=7)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(kernels.KernelBuildError, match="nvcc"):
        kernels.nvcc_path()


@pytest.mark.parametrize("mod", [fused_ops, osa_ops])
def test_preflight_at_serving_shapes(mod):
    """The decode path at the served projections: 400 column tiles split 6
    ways over K for mlp/wi, 40 tiles split 50 ways for mlp/wo (about 16
    blocks per SM), whole ring stages per split, and a ring that lets two
    blocks share an SM."""
    wi = mod.preflight(4, 5120, 51200)
    wo = mod.preflight(4, 25600, 5120)
    assert wi["issues"] == [] and wo["issues"] == []
    assert wi["path"] == wo["path"] == "decode"
    assert wi["grid"] == (400, 6, 1) and wi["k_per_split"] == 864
    assert wo["grid"] == (40, 50, 1) and wo["k_per_split"] == 512
    assert 2 * wi["smem_bytes"] + 2048 <= 228 * 1024
    assert wi["bytes_in_flight_per_sm"] >= 32 * 1024
    assert wi["pad_waste"] == 0.0          # no padded rows at m = 4


@pytest.mark.parametrize("mod", [fused_ops, osa_ops])
@pytest.mark.parametrize("m,path", [(1, "decode"), (4, "decode"),
                                    (8, "decode"), (16, "decode"),
                                    (17, "tall"), (524288, "tall")])
def test_launch_path_follows_m(mod, m, path):
    assert mod.plan(m, 27, 16)["path"] == path


@pytest.mark.parametrize("mod", [fused_ops, osa_ops])
def test_grid_y_within_limit_at_600000_rows(mod):
    pl = mod.preflight(600_000, 27, 16)
    assert pl["issues"] == [] and pl["grid"][1] <= 65535
    if mod is fused_ops:       # row tiles on grid x: every row has a block
        assert pl["grid"] == (-(-600_000 // 128), 1, 1)
    else:                      # capped; blocks take the rest in turn
        assert pl["grid"][:2] == (1, 65535)


@pytest.mark.parametrize("mod", [fused_ops, osa_ops])
@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_k_split_at_25600x5120(mod, m):
    pl = mod.plan(m, 25600, 5120)
    assert pl["splits"] == 50 and pl["k_per_split"] == 512
    assert pl["part_floats"] == 50 * m * 5120
    assert pl["operand_floats"] == 25600 * (-(-m // 4) * 4)


@pytest.mark.parametrize("m,k,n", [(1, 5120, 51200), (3, 700, 130),
                                   (16, 25600, 5120), (5, 33, 7),
                                   (9, 100000, 10)])
def test_decode_splits_cover_k_in_whole_stages(m, k, n):
    pl = fused_ops.plan(m, k, n)
    kps, splits = pl["k_per_split"], pl["splits"]
    assert kps % 32 == 0 and (splits - 1) * kps < k <= splits * kps
    assert pl["grid"] == (-(-n // 128), splits, 1)
    assert splits == 1 or pl["part_floats"] == splits * m * n


@pytest.mark.parametrize("m", range(1, 17))
@pytest.mark.parametrize("mode", ["rosa_fused", "osa fused",
                                  "osa per-plane"])
def test_dynamic_shared_memory_within_limit(m, mode):
    pl = (fused_ops.preflight(m, 5120, 51200) if mode == "rosa_fused" else
          osa_ops.preflight(m, 5120, 51200, fused=mode == "osa fused",
                            pam_bits=1))
    assert pl["issues"] == [] and pl["smem_bytes"] <= 232448
    if mode != "osa per-plane":             # two blocks per SM
        assert 2 * pl["smem_bytes"] + 2048 <= 228 * 1024


@pytest.mark.parametrize("m,n,tile", [(524288, 10, 32), (524288, 16, 32),
                                      (524288, 96, 128), (524288, 300, 128),
                                      (4, 51200, 128), (524288, 51200, 128)])
def test_n_tile_follows_n(m, n, tile):
    """A sheet with one column tile takes the least of 32, 64, 128 that
    holds N (a warp's tile is 32 columns wide) and conditions its
    activations in the tile; wider N takes 128-column tiles and both
    operands through workspaces."""
    pl = fused_ops.preflight(m, 27, n)
    assert pl["n_tile"] == tile and pl["issues"] == []
    assert pl["grid"][1 if pl["path"] == "tall" else 0] == -(-n // tile)
    if pl["path"] == "tall":
        assert pl["x_in_tile"] == (n <= 128)
        assert (pl["x_operand_bytes"] == 0) == pl["x_in_tile"]


@pytest.mark.parametrize("kw,route", [
    ({"mapping": Mapping.WS}, "codes"),
    ({"mapping": Mapping.IS, "act_per_vector": True}, "codes"),
    ({"mapping": Mapping.IS, "noise": TM.PAPER_NOISE,
      "key": torch.Generator().manual_seed(0)}, "codes"),
    ({"mapping": Mapping.IS, "gate": 0.5}, "codes"),
    ({"mapping": Mapping.WS, "gate": 0.5}, "tf32x2"),
    ({"mapping": Mapping.WS, "noise": TM.PAPER_NOISE,
      "key": torch.Generator().manual_seed(0)}, "tf32x2"),
    ({"mapping": Mapping.WS, "mgate": 0.5}, "tf32x2"),
    ({"mapping": Mapping.WS, "quant_bits": 10}, "tf32x2"),
    ({"mapping": Mapping.IS, "quant_bits": 12}, "tf32x2"),
    ({"mapping": Mapping.IS, "quant_bits": 13}, "tf32x3"),
    ({"mode": ComputeMode.ANALOG}, "tf32x3"),
    ({"mapping": Mapping.IS,
      "osa_cfg": TO.OSAConfig(splitter_imbalance=0.01)}, "tf32x3"),
    ({"mapping": Mapping.IS,
      "osa_cfg": TO.OSAConfig(odl_loss_db_per_stage=0.1)}, "tf32x3"),
])
def test_route_follows_operands(kw, route):
    """The tall path's route from what the host knows: codes on both sides
    (MIXED, ideal gains, qmax <= 127, an unrealized unblended weight) take
    int8 codes; an integer activation below 2048 against a float weight
    (realized or gated WS, a mapping gate, qmax 511 or 2047) two TF32
    passes; a non-ideal OSA, ANALOG mode or qmax 4095 three."""
    kw = dict(kw)
    key = kw.pop("key", None)
    x, w = torch.zeros(3, 40), torch.ones(40, 5)
    var = (TM.StaticVariation(torch.zeros(40), torch.tensor(0.0),
                              torch.tensor(0.0)) if "noise" in kw else None)
    args, static = fused_ops.operands(x, w, key, var, **kw)
    assert fused_ops.route_of(40, **static) == route
    # the plain version ignores the gains' flag
    assert torch.equal(
        fused_ops.plain(*args, **static),
        fused_ops.plain(*args, **dict(
            static, ideal_gains=not static["ideal_gains"])))


def test_codes_route_keeps_int32_sums():
    """K qmax^2 past int32 takes the TF32 route."""
    k_max = (2**31 - 1) // 127**2
    assert fused_ops.route_of(analog=False, qmax=127, realize_w=False,
                              use_mgate=False, ideal_gains=True,
                              k=k_max) == "codes"
    assert fused_ops.route_of(analog=False, qmax=127, realize_w=False,
                              use_mgate=False, ideal_gains=True,
                              k=k_max + 1) == "tf32x2"


@pytest.mark.parametrize("kw,ideal,route", [
    ({"mapping": Mapping.WS}, None, "codes"),
    ({"mapping": Mapping.WS, "gate": 0.5}, None, "tf32x2"),
    ({"mode": ComputeMode.ANALOG}, None, "tf32x3"),
    ({"mapping": Mapping.IS,
      "osa_cfg": TO.OSAConfig(splitter_imbalance=0.01)}, None, "tf32x3"),
    # the flag, not the gains tensor, decides: ideal gains flagged as not
    # ideal take the route that holds any gains
    ({"mapping": Mapping.IS}, False, "tf32x3"),
])
def test_launch_takes_the_route_of_its_flags(monkeypatch, kw, ideal, route):
    """`launch` derives the tall path's route from the static flags and
    hands the kernel that route's index and plan."""
    calls = []

    class Lib:
        def rosa_fused_launch(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(kernels, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "stream_of", lambda t: None)
    monkeypatch.setattr(fused_ops, "_lib", lambda: Lib())
    monkeypatch.setattr(fused_ops, "_n_sm", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    x, w = torch.zeros(20, 40), torch.ones(40, 5)
    args, static = fused_ops.operands(x, w, **kw)
    if ideal is not None:
        static = dict(static, ideal_gains=ideal)
    fused_ops.launch(*args, **static)
    pl = fused_ops.plan(20, 40, 5, route=route)
    # ..., splits, k_per_split, n_tile, route, m_tile, x_in_tile, stream
    assert calls[0][-7:-1] == (pl["splits"], pl["k_per_split"],
                               pl["n_tile"], fused_ops.ROUTES.index(route),
                               pl["m_tile"], int(pl["x_in_tile"]))


# splits: (codes route's, 64 lanes a stage; TF32 routes', 32)
@pytest.mark.parametrize("m,k,n,tile_m,splits", [
    (64, 3840, 30720, 64, (1, 1)), (64, 15360, 3840, 64, (9, 9)),
    (2048, 5120, 51200, 128, (1, 1)), (2048, 25600, 5120, 128, (1, 1)),
    (2048, 12800, 5120, 128, (1, 1)), (17, 100, 200, 64, (2, 4)),
    (512, 5120, 160, 128, (27, 32))])
@pytest.mark.parametrize("route", ["codes", "tf32x2", "tf32x3"])
def test_tall_plan_follows_the_shape(m, k, n, tile_m, splits, route):
    """The row tile follows M (64 rows at the 64-row chunk, not a half-empty
    128); K is split when the tiles leave SMs idle, into about two blocks
    an SM, each split whole stages of the route (at (17, 100, 200) a
    stage a block: 2 of 64 lanes, 4 of 32); the ring stays within the
    227 KB a block may use."""
    pl = fused_ops.preflight(m, k, n, route=route)
    bk = fused_ops.ROUTE_BK[route]
    assert pl["issues"] == [] and pl["route"] == route
    assert pl["m_tile"] == tile_m
    splits = splits[route != "codes"]
    assert pl["splits"] == splits
    blocks = pl["grid"][0] * pl["grid"][1] * pl["grid"][2]
    # short K caps the split at a stage a block
    assert splits == 1 or (132 <= blocks or pl["k_per_split"] == bk) \
        and blocks <= 4 * 132
    assert pl["k_per_split"] % bk == 0
    assert (pl["splits"] - 1) * pl["k_per_split"] < pl["kp"] \
        <= pl["splits"] * pl["k_per_split"]
    assert pl["kp"] == -(-k // bk) * bk
    assert pl["smem_bytes"] <= 232448
    es = fused_ops.ROUTE_BYTES[route]
    assert pl["w_operand_bytes"] == -(-n // 128) * 128 * pl["kp"] * es
    assert pl["part_bytes"] == (4 * splits * m * n if splits > 1 else 0)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernels build on first "
                    "use)")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(13, 200), (130, 200), (70, 40)])
@pytest.mark.parametrize("kw", [
    {"mapping": Mapping.IS, "act_per_vector": True},
    {"mapping": Mapping.WS}, {"mode": ComputeMode.ANALOG},
    {"mapping": Mapping.IS,
     "osa_cfg": TO.OSAConfig(splitter_imbalance=0.02)}])
def test_fused_kernel_matches_plain_on_cuda(kw, m, n):
    """Decode rows (13) and the tall path's routes: IS codes, realized WS
    tf32x2, ANALOG and a non-ideal OSA tf32x3, through workspaces (N 200)
    and conditioned in the tile (N 40); two launches equal bit for bit;
    the TF32 routes within `split_tf32_parity` of the float64 product."""
    _need_cuda()
    x, w, dv = _operands(m, 300, n, 5)
    var = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.05),
                             torch.tensor(1e-4))
    y_cpu = fused_ops.rosa_fused_matmul(torch.from_numpy(x),
                                        torch.from_numpy(w), None, var, **kw)
    xg, wg = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    y_gpu = fused_ops.rosa_fused_matmul(xg, wg, None, var.to("cuda"), **kw)
    torch.cuda.synchronize()
    assert_quantized_parity(y_gpu, y_cpu)
    args, static = fused_ops.operands(xg, wg, None, var.to("cuda"), **kw)
    y = fused_ops.launch(*args, **static)
    assert torch.equal(y, fused_ops.launch(*args, **static))
    if m > 16 and fused_ops.route_of(300, **static) != "codes":
        from test_torch_rosa_fused_emu import chip_smoke
        chip_smoke().split_tf32_parity(
            y, fused_ops.plain(*args, **static), args, static, str(kw))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_osa_kernel_matches_plain_on_cuda(fused):
    _need_cuda()
    x, w, _ = _operands(9, 700, 130, 6)
    y_cpu = osa_ops.osa_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               fused=fused)
    y_gpu = osa_ops.osa_matmul(torch.from_numpy(x).cuda(),
                               torch.from_numpy(w).cuda(), fused=fused)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(y_gpu), to_np(y_cpu), rtol=1e-5,
                               atol=1e-4)


def _fused_on(x, w, var, **kw):
    """rosa_fused_matmul on the CPU (the plain version) and on the card."""
    y_cpu = fused_ops.rosa_fused_matmul(torch.from_numpy(x),
                                        torch.from_numpy(w), None, var, **kw)
    xg, wg = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    y_gpu = fused_ops.rosa_fused_matmul(xg, wg, None, var.to("cuda"), **kw)
    torch.cuda.synchronize()
    return y_cpu, y_gpu


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 5, 16])
@pytest.mark.parametrize("kw", [
    {"mapping": Mapping.IS, "act_per_vector": True},
    {"mapping": Mapping.WS}])
def test_fused_decode_rows_match_plain_on_cuda(m, kw):
    _need_cuda()
    x, w, dv = _operands(m, 1100, 260, 20 + m)
    var = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.05),
                             torch.tensor(1e-4))
    y_cpu, y_gpu = _fused_on(x, w, var, **kw)
    assert_quantized_parity(y_gpu, y_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 5, 16])
@pytest.mark.parametrize("fused", [True, False])
def test_osa_decode_rows_match_plain_on_cuda(m, fused):
    _need_cuda()
    x, w, _ = _operands(m, 1100, 260, 30 + m)
    y_cpu = osa_ops.osa_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               fused=fused)
    y_gpu = osa_ops.osa_matmul(torch.from_numpy(x).cuda(),
                               torch.from_numpy(w).cuda(), fused=fused)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(y_gpu), to_np(y_cpu), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 40])
@pytest.mark.parametrize("view", ["ragged", "unaligned"])
def test_kernels_take_ragged_and_unaligned_weights_on_cuda(m, view):
    """Views of a (333, 304) weight: the first 301 columns (aligned rows,
    a ragged last float4) and a column-offset view starting 4 bytes past a
    16-byte boundary (every copy 4 bytes wide); both launch the kernels,
    never the plain version."""
    _need_cuda()
    x, w_full, dv = _operands(m, 333, 304, 40 + m)
    cols = slice(1, None) if view == "unaligned" else slice(None, 301)
    wg = torch.from_numpy(w_full).cuda()[:, cols]
    w = np.ascontiguousarray(w_full[:, cols])
    var = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.05),
                             torch.tensor(1e-4))
    for kw in ({"mapping": Mapping.WS}, {"mapping": Mapping.IS}):
        y_cpu = fused_ops.rosa_fused_matmul(
            torch.from_numpy(x), torch.from_numpy(w), None, var, **kw)
        y_gpu = fused_ops.rosa_fused_matmul(
            torch.from_numpy(x).cuda(), wg, None, var.to("cuda"), **kw)
        torch.cuda.synchronize()
        assert_quantized_parity(y_gpu, y_cpu)
    q = torch.round(torch.from_numpy(x) * 20).clamp(-127, 127)
    g = torch.tensor([2.0 ** t for t in range(7)])
    for fused in (True, False):
        y_cpu = osa_ops.osa_matmul_int(q, torch.from_numpy(w), g,
                                       n_planes=7, fused=fused)
        y_gpu = osa_ops.osa_matmul_int(q.cuda(), wg, g.cuda(), n_planes=7,
                                       fused=fused)
        torch.cuda.synchronize()
        np.testing.assert_allclose(to_np(y_gpu), to_np(y_cpu), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_osa_kernel_takes_524289_rows_on_cuda(fused):
    _need_cuda()
    r = np.random.default_rng(7)
    q = torch.from_numpy(r.integers(-127, 128, size=(524289, 27))
                         .astype(np.float32)).cuda()
    w = torch.from_numpy(r.normal(size=(27, 16)).astype(np.float32)).cuda()
    g = torch.tensor([2.0 ** t for t in range(7)], device="cuda")
    y = osa_ops.osa_matmul_int(q, w, g, n_planes=7, fused=fused)
    y_plain = osa_ops.plain(q, w, g, n_planes=7, fused=fused)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(y), to_np(y_plain), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.cuda
def test_split_k_launches_are_bitwise_deterministic_on_cuda():
    """K split across blocks (4 x 4096 x 256: 2 column tiles, split 32
    ways) is summed in a fixed order: two launches give equal bits."""
    _need_cuda()
    assert fused_ops.plan(4, 4096, 256)["splits"] > 1
    x, w, dv = _operands(4, 4096, 256, 50)
    var = TM.StaticVariation(torch.from_numpy(dv), torch.tensor(0.05),
                             torch.tensor(1e-4)).to("cuda")
    xg, wg = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    args, static = fused_ops.operands(xg, wg, None, var, mapping=Mapping.WS)
    assert torch.equal(fused_ops.launch(*args, **static),
                       fused_ops.launch(*args, **static))
    q = torch.round(xg * 20).clamp(-127, 127)
    g = torch.tensor([2.0 ** t for t in range(7)], device="cuda")
    for fused in (True, False):
        assert torch.equal(
            osa_ops.launch(q, wg, g, n_planes=7, fused=fused),
            osa_ops.launch(q, wg, g, n_planes=7, fused=fused))
