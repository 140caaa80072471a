"""Dry run of every (arch x shape x mesh) cell on the production meshes
(PyTorch port of `repro.launch.dryrun`), on the CPU, allocating nothing.

For each cell the dry run:
  1. skips it where `models.model.applicable` says so, with its reason;
  2. builds the production mesh, (16, 16) = 256 devices or (2, 16, 16) =
     512, over the default process group — a "fake" group of that size,
     this process its rank 0, when none is open;
  3. resolves parameter / optimizer / batch / cache shardings from the
     logical rules (train vs serve) and makes each of those leaves a
     `meta` DTensor with its placements: params in bfloat16, AdamW
     moments in float32 with an int32 step (plus `err` under
     `grad_compress`), the batch and cache as `input_specs` gives them;
  4. traces the cell's step (`make_train_step`, `prefill` or
     `decode_step`) on global `meta` tensors under
     `torch.utils.flop_counter.FlopCounterMode`.

A record holds the per-device bytes read from the DTensors' local shards
(params, opt_state, batch with the cache, and their sum `argument_bytes`,
the reference's `argument_size_in_bytes`), the largest leaf per device,
and the matmul-class FLOPs of one step over the whole mesh
(`matmul_flops_global`) beside `matmul_flops_even_split`, that count over
the device count: an even split, not the count of a partitioned program.
The count does not depend on the mesh, so each (arch, shape) is traced
once and its count reused.  MoE layers run the port's `moe_ref`, which
evaluates every expert for every token, so an MoE cell counts every
expert's products.

The reference's compiled-program figures have no counterpart: temp bytes
(`memory_analysis()`), XLA's cost analysis and the HLO analysis
(`launch/hlo_analysis.py`) read an XLA executable, and `--save-hlo` has
no module to save.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
      --mesh multi
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (SERVE_RULES, TRAIN_RULES,
                                              ZERO3_TRAIN_RULES,
                                              param_shardings,
                                              tree_shardings)
from repro_torch.launch.mesh import (make_production_mesh,
                                     production_mesh_shape)
from repro_torch.launch.steps import (init_opt_state, make_train_step,
                                      opt_state_shardings)
from repro_torch.models.model import ASSIGNED_SHAPES, applicable, build_model
from repro_torch.optim import AdamWConfig

MESH_KINDS = ("single", "multi")
_TRACES: dict = {}          # (arch, shape, overrides) -> (flops, seconds)


def cell_config(arch: str, overrides: dict | None = None):
    """(config, grad_compress, parallelism) of a cell.  `overrides` are
    ModelConfig fields, plus the reference's `grad_compress`,
    `capacity_factor` (of the MoE config) and `parallelism` ("tp" or
    "zero3": the train-time layout, which the port's ModelConfig does not
    carry)."""
    cfg = get_config(arch)
    compress, parallelism = False, "tp"
    if overrides:
        overrides = dict(overrides)
        compress = overrides.pop("grad_compress", False)
        cap = overrides.pop("capacity_factor", None)
        parallelism = overrides.pop("parallelism", "tp")
        cfg = dataclasses.replace(cfg, **overrides)
        if cap is not None and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    return cfg, compress, parallelism


def cell_rules(kind: str, parallelism: str = "tp") -> dict:
    if kind != "train":
        return SERVE_RULES
    return ZERO3_TRAIN_RULES if parallelism == "zero3" else TRAIN_RULES


def fake_group(world: int) -> None:
    """Make the default process group one of `world` ranks: an open group
    of that size is kept; otherwise a "fake" group (no peers, collectives
    that return at once) is opened with this process as rank 0, in place
    of a fake group of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is open; the mesh needs {world}")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(mesh_kind: str):
    """The production DeviceMesh of `mesh_kind` ("single" | "multi") over a
    group of its size (`fake_group`)."""
    multi = mesh_kind == "multi"
    fake_group(production_mesh_shape(multi_pod=multi).size)
    return make_production_mesh(multi_pod=multi)


def _flat(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flat(tree[k], f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, t in enumerate(tree)
                for pair in _flat(t, f"{path}/{i}")]
    return [(path, tree)]


def _distribute(tree, shardings):
    """`tree` of meta tensors as meta DTensors laid out by `shardings`
    (NamedSharding leaves in the same structure)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_distribute(t, s)
                          for t, s in zip(tree, shardings, strict=True))
    local = torch.empty(shardings.shard_shape(tuple(tree.shape)),
                        dtype=tree.dtype, device="meta")
    return DTensor.from_local(local, shardings.mesh, shardings.placements,
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())


def cell_arguments(arch: str, shape_name: str, mesh_kind: str,
                   overrides: dict | None = None) -> dict:
    """{"params", "opt_state" (train cells), "batch"}: the step's
    arguments as meta DTensors on the production mesh, laid out by the
    cell's rules."""
    cfg, compress, parallelism = cell_config(arch, overrides)
    shape = ASSIGNED_SHAPES[shape_name]
    mesh = production_mesh(mesh_kind)
    rules = cell_rules(shape.kind, parallelism)
    bundle = build_model(cfg)
    params = bundle.abstract()
    p_sh = param_shardings(bundle.skeleton, mesh, rules)
    out = {"params": _distribute(params, p_sh)}
    if shape.kind == "train":
        out["opt_state"] = _distribute(init_opt_state(params, compress),
                                       opt_state_shardings(p_sh, compress))
    batch, axes = bundle.input_specs(shape)
    out["batch"] = _distribute(batch, tree_shardings(batch, axes, mesh,
                                                     rules))
    return out


def shards(trees) -> list[tuple[str, torch.Tensor]]:
    """(path, this device's local shard) of every DTensor leaf of
    `cell_arguments`' trees, paths from the tree names on."""
    return [(path.lstrip("/"), t.to_local()) for path, t in _flat(trees)]


def cell_bytes(arch: str, shape_name: str, mesh_kind: str,
               overrides: dict | None = None) -> dict:
    """The per-device bytes of a cell's step arguments, read from the
    local shards of `cell_arguments`: params_bytes, opt_state_bytes,
    batch_bytes (the cache included), argument_bytes (their sum), the
    largest leaf per device, n_devices and n_params."""
    cfg, _, _ = cell_config(arch, overrides)
    trees = cell_arguments(arch, shape_name, mesh_kind, overrides)
    rec = {f"{part}_bytes": 0 for part in ("params", "opt_state", "batch")}
    largest = ("", -1)
    for path, t in shards(trees):
        n = t.numel() * t.element_size()
        rec[f"{path.split('/')[0]}_bytes"] += n
        largest = max(largest, (path, n), key=lambda pn: pn[1])
    rec["argument_bytes"] = sum(rec.values())
    rec["largest_leaf"], rec["largest_leaf_bytes"] = largest
    rec["n_devices"] = production_mesh_shape(
        multi_pod=mesh_kind == "multi").size
    rec["n_params"] = build_model(cfg).n_params
    return rec


def trace_flops(arch: str, shape_name: str,
                overrides: dict | None = None) -> tuple[int, float, bool]:
    """(matmul-class FLOPs, seconds, reused) of the cell's step traced on
    global meta tensors: traced once per (arch, shape, overrides), then
    the first trace's figures with `reused` True."""
    key = (arch, shape_name, json.dumps(overrides, sort_keys=True))
    if key in _TRACES:
        return (*_TRACES[key], True)
    from torch.utils.flop_counter import FlopCounterMode
    cfg, compress, _ = cell_config(arch, overrides)
    shape = ASSIGNED_SHAPES[shape_name]
    bundle = build_model(cfg)
    t0 = time.perf_counter()
    params = bundle.abstract()
    batch, _ = bundle.input_specs(shape)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            step = make_train_step(bundle, AdamWConfig(),
                                   grad_compress=compress)
            step(params, init_opt_state(params, compress), batch)
        else:
            with torch.no_grad():
                bundle.step_fn(shape)(params, batch)
    _TRACES[key] = (counter.get_total_flops(), time.perf_counter() - t0)
    return (*_TRACES[key], False)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             backend: str = "dense", overrides: dict | None = None) -> dict:
    """One cell's JSON-able record."""
    cfg, _, _ = cell_config(arch, overrides)
    shape = ASSIGNED_SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
           "backend": backend, "status": "skip", "reason": why}
    if not ok:
        return rec
    t0 = time.perf_counter()
    rec.update(cell_bytes(arch, shape_name, mesh_kind, overrides))
    build_s = time.perf_counter() - t0
    flops, trace_s, reused = trace_flops(arch, shape_name, overrides)
    rec.update(status="ok", matmul_flops_global=flops,
               matmul_flops_even_split=flops / rec["n_devices"],
               build_s=build_s, trace_s=trace_s, trace_reused=reused)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Per-device bytes and step FLOPs of every (arch, "
                    "shape, mesh) cell, from meta DTensors on the CPU.")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None,
                    choices=list(ASSIGNED_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--backend", default="dense",
                    help="recorded with each cell")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig field overrides (and "
                         "grad_compress, capacity_factor, parallelism)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(ASSIGNED_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = list(MESH_KINDS) if args.mesh == "both" else [args.mesh]
    overrides = json.loads(args.override) if args.override else None

    n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mesh_kind in meshes:
                    tag = f"{arch}__{shape}__{mesh_kind}"
                    if overrides:
                        tag += "__opt"
                    try:
                        rec = run_cell(arch, shape, mesh_kind, args.backend,
                                       overrides)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_kind, "status": "fail",
                               "error": f"{type(e).__name__}: {e}"}
                        n_fail += 1
                    with open(os.path.join(args.out, tag + ".json"),
                              "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[{rec['status']:4s}] {tag} "
                          f"args/dev={rec.get('argument_bytes', '-')} "
                          f"flops={rec.get('matmul_flops_global', '-')} "
                          f"({rec.get('reason', rec.get('error', ''))})",
                          flush=True)
    finally:
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_backend() == "fake":
            dist.destroy_process_group()
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
