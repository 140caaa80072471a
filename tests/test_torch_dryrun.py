"""The dry run of the port (`repro_torch.launch.dryrun`) on the CPU:

  * `cell_bytes` of all 66 applicable (arch, shape, mesh) cells — the
    per-device bytes read from meta DTensors over a "fake" process group
    of 256 / 512 ranks — equal, part by part, the bytes reckoned from the
    reference's specs and dtypes: `abstract()` params in bfloat16,
    `init_opt_state` (float32 moments, int32 step; float32 `err` under
    gradient compression) over the params' specs, and `input_specs`'
    batch and cache, each leaf over its group's device count under
    `resolve_spec` with the cell's rules;
  * the 14 skips are the reference's `applicable`;
  * `run_cell` at smoke sizes (the configs' SMOKE, the reduced shapes) is
    `ok` with FLOPs for one config per family, and a dense prefill's count
    equals the closed form of its products;
  * a meta mamba2 step takes the plain scan;
  * the CLI writes one JSON a cell and closes its group.

No full-size step is traced here (`python -m repro_torch.launch.dryrun
--all --mesh both` does, in minutes).  Every test leaves no process group
open: the files run under xdist workers of their own.
"""

import json
import math
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import (ASSIGNED_SHAPES, SMOKE_SHAPES,
                                      applicable)
from test_torch_ref import reference

GIB = 2.0 ** 30


@pytest.fixture(scope="module")
def R():
    return reference()


@pytest.fixture(autouse=True)
def fake_group():
    """A "fake" group of 256 ranks for the test (the dry run swaps it for
    one of 512 on the multi-pod mesh), destroyed after it."""
    dryrun.fake_group(256)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture()
def smoke(monkeypatch):
    """The dry run on the smoke configs and the reduced shapes."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke)
    monkeypatch.setattr(dryrun, "ASSIGNED_SHAPES", SMOKE_SHAPES)
    monkeypatch.setattr(dryrun, "_TRACES", {})


def _ref_bytes(R, arch, shape_name, multi, compress=False,
               zero3=False) -> dict:
    """Per-device bytes of a cell from the reference's specs and dtypes."""
    jb = R.model.build_model(R.configs.get_config(arch))
    shape = R.model.ASSIGNED_SHAPES[shape_name]
    rules = R.sharding.SERVE_RULES if shape.kind != "train" \
        else R.sharding.ZERO3_TRAIN_RULES if zero3 \
        else R.sharding.TRAIN_RULES
    mesh = types.SimpleNamespace(
        shape=production_mesh_shape(multi_pod=multi).shape)

    def total(tree, axes):
        flat, treedef = jax.tree_util.tree_flatten(tree)
        n = 0
        for leaf, ax in zip(flat, treedef.flatten_up_to(axes)):
            spec = R.sharding.resolve_spec(leaf.shape, ax, rules, mesh)
            div = math.prod(
                mesh.shape[a] for part in spec if part
                for a in ((part,) if isinstance(part, str) else part))
            assert math.prod(leaf.shape) % div == 0
            n += math.prod(leaf.shape) // div * np.dtype(leaf.dtype).itemsize
        return n

    params = jb.abstract()
    p_axes = jb.param_axes()
    out = {"params_bytes": total(params, p_axes), "opt_state_bytes": 0}
    if shape.kind == "train":
        opt = jax.eval_shape(lambda p: R.steps.init_opt_state(p, compress),
                             params)
        o_axes = {"adam": {"mu": p_axes, "nu": p_axes, "step": ()}}
        if compress:
            o_axes["err"] = p_axes
        out["opt_state_bytes"] = total(opt, o_axes)
    out["batch_bytes"] = total(*jb.input_specs(shape))
    out["argument_bytes"] = sum(out.values())
    return out


def _cells(arch):
    cfg = get_config(arch)
    return [s for s, shape in ASSIGNED_SHAPES.items()
            if applicable(cfg, shape)[0]]


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_cell_bytes_equal_reference(R, arch):
    keys = ("params_bytes", "opt_state_bytes", "batch_bytes",
            "argument_bytes")
    for shape_name in _cells(arch):
        for kind in dryrun.MESH_KINDS:
            got = dryrun.cell_bytes(arch, shape_name, kind)
            want = _ref_bytes(R, arch, shape_name, kind == "multi")
            assert {k: got[k] for k in keys} == want, (shape_name, kind)
            assert got["n_devices"] == (512 if kind == "multi" else 256)
            assert 0 < got["largest_leaf_bytes"] <= got["argument_bytes"]


def test_cell_bytes_under_gradient_compression(R):
    got = dryrun.cell_bytes("qwen3-32b", "train_4k", "multi",
                            {"grad_compress": True})
    want = _ref_bytes(R, "qwen3-32b", "train_4k", True, compress=True)
    assert {k: got[k] for k in want} == want
    # err is one more float32 copy of the params' shards
    plain = dryrun.cell_bytes("qwen3-32b", "train_4k", "multi")
    assert got["opt_state_bytes"] - plain["opt_state_bytes"] \
        == 2 * plain["params_bytes"]


def test_cell_bytes_under_zero3(R):
    """The ZeRO-3 layout (`parallelism` "zero3") spreads a train batch over
    the whole mesh: 256 rows over the 512 devices' suffix ("data",
    "model")."""
    got = dryrun.cell_bytes("mistral-large-123b", "train_4k", "multi",
                            {"parallelism": "zero3"})
    want = _ref_bytes(R, "mistral-large-123b", "train_4k", True, zero3=True)
    assert {k: got[k] for k in want} == want
    tp = dryrun.cell_bytes("mistral-large-123b", "train_4k", "multi")
    assert got["batch_bytes"] * 8 == tp["batch_bytes"]      # 256 vs 32 ways


def test_every_cell_fits_one_card_and_the_largest_is_deepseek_v2_train():
    rows = {(a, s, k): dryrun.cell_bytes(a, s, k)
            for a in ARCH_IDS for s in _cells(a) for k in dryrun.MESH_KINDS}
    assert len(rows) == 66
    top = max(rows, key=lambda c: rows[c]["argument_bytes"])
    rec = rows[top]
    assert top == ("deepseek-v2-236b", "train_4k", "single")
    assert abs(rec["argument_bytes"] / GIB - 10.74) < 0.005
    assert abs(rec["params_bytes"] / GIB - 2.15) < 0.005
    assert abs(rec["opt_state_bytes"] / GIB - 8.59) < 0.005
    assert rec["largest_leaf"] == "opt_state/adam/mu/layers/ffn/wi"
    assert all(r["argument_bytes"] < 80e9 for r in rows.values())


def test_skips_equal_reference(R):
    skips = []
    for arch in ARCH_IDS:
        for name, shape in ASSIGNED_SHAPES.items():
            got = applicable(get_config(arch), shape)
            assert got == R.model.applicable(R.configs.get_config(arch),
                                             R.model.ASSIGNED_SHAPES[name])
            rec = dryrun.run_cell(arch, name, "single") if not got[0] \
                else None
            if rec is not None:
                assert rec["status"] == "skip" and rec["reason"] == got[1]
                skips.append((arch, name))
    assert len(skips) * 2 == 14
    assert {s for _, s in skips} == {"long_500k"}


# one config per family (phi-3-vision: the vision frontend)
FAMILIES = ["qwen3-32b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "mamba2-1.3b", "zamba2-1.2b", "seamless-m4t-medium",
            "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_at_smoke_size(smoke, arch):
    for shape in SMOKE_SHAPES:
        for kind in dryrun.MESH_KINDS:
            rec = dryrun.run_cell(arch, shape, kind)
            if rec["status"] == "skip":
                assert shape == "long_500k"
                continue
            assert rec["status"] == "ok", rec
            assert rec["matmul_flops_global"] > 0
            assert rec["matmul_flops_even_split"] \
                == rec["matmul_flops_global"] / rec["n_devices"]
            assert rec["trace_reused"] == (kind == "multi")
            assert rec["argument_bytes"] == sum(
                rec[f"{p}_bytes"] for p in ("params", "opt_state", "batch"))
            json.dumps(rec)


def test_dense_prefill_flops_equal_the_closed_form(smoke):
    """qwen3-32b-smoke's prefill: per layer the q, k, v and o projections,
    the scores and the weighted values of every head over the whole
    sequence, the gated MLP's two products; then the last token's
    logits."""
    cfg = get_smoke("qwen3-32b")
    shape = SMOKE_SHAPES["prefill_32k"]
    b, s = shape.global_batch, shape.seq_len
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * b * s * d * hd * (2 * h + 2 * kv)
             + 2 * 2 * b * h * s * s * hd + 2 * b * s * 3 * d * cfg.d_ff)
    want = cfg.n_layers * layer + 2 * b * d * cfg.vocab
    got = dryrun.run_cell("qwen3-32b", "prefill_32k", "single")
    assert abs(got["matmul_flops_global"] / want - 1) <= 0.01


def test_meta_mamba2_step_takes_the_plain_scan(smoke, monkeypatch):
    calls = []
    plain = ssd_ops.plain

    def counted(*a, **kw):
        calls.append(a[0].device.type)
        return plain(*a, **kw)

    monkeypatch.setattr(ssd_ops, "plain", counted)
    before = ssd_ops.LAUNCHES.count
    for shape in ("prefill_32k", "train_4k"):
        assert dryrun.run_cell("mamba2-1.3b", shape, "single")["status"] \
            == "ok"
    assert calls and set(calls) == {"meta"}
    assert ssd_ops.LAUNCHES.count == before
    # a meta tensor takes the plain version; a CUDA one never does
    assert kernels.runs_plain(torch.empty(1, device="meta"))
    assert kernels.runs_plain(torch.empty(1))
    assert not kernels.runs_plain(
        types.SimpleNamespace(device=torch.device("cuda", 0)))


def test_cli_writes_one_json_a_cell(smoke, tmp_path, capsys):
    dist.destroy_process_group()        # the CLI opens its own
    dryrun.main(["--arch", "gemma3-12b", "--mesh", "both", "--out",
                 str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"gemma3-12b__{s}__{k}.json"
                           for s in SMOKE_SHAPES for k in dryrun.MESH_KINDS)
    for f in files:
        rec = json.loads((tmp_path / f).read_text())
        assert rec["status"] == "ok" and rec["n_devices"] in (256, 512)
        assert rec["argument_bytes"] > 0 and rec["matmul_flops_global"] > 0
    out = capsys.readouterr().out
    assert out.count("[ok  ]") == 8
    assert not dist.is_initialized()
    # qwen3-32b has a skip at long_500k; an override names its file
    dryrun.main(["--arch", "qwen3-32b", "--shape", "long_500k", "--out",
                 str(tmp_path), "--override", '{"grad_compress": true}'])
    rec = json.loads((tmp_path / "qwen3-32b__long_500k__single__opt.json")
                     .read_text())
    assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
