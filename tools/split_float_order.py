#!/usr/bin/env python3
"""How far a tensor-parallel train step's gradient moves from the
one-process step's, on the CPU: a smoke config's sharded loss and
gradient on a (data, model) mesh of gloo ranks (`launch.steps.
sharded_loss_and_grads`) against `loss_and_grads` in one process, in
float32, with every op in float64 (`--float64`: params, inputs and each
`Tensor.float()` of the model in float64, in every process), and with
the split off (`--whole`: `tp_axes` () so every layer is
gathered whole); the one-process step's float-order floor, its gradient
moved by permuting the d_model axis of the params (the same function,
every contraction over d_model summed in another order); and the
collectives of one step a rank (`--count`, at two depths, so a layer's
share shows).  `--noisy ref|fused` runs qwen3-32b-smoke's optical MLPs
under a noisy IS engine.

    PYTHONPATH=src python3 tools/split_float_order.py --arch zamba2-1.2b
    PYTHONPATH=src python3 tools/split_float_order.py --arch zamba2-1.2b \\
        --float64
    PYTHONPATH=src python3 tools/split_float_order.py --noisy ref
    PYTHONPATH=src python3 tools/split_float_order.py --count
"""

import argparse
import contextlib
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import runtime  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.module import leaves, map_tree, unflatten  # noqa

B, S = 4, 16                     # the train-ranks tests' family batch


def setup(opts) -> None:
    """Every process's: float64 everywhere, or the split off."""
    if opts.float64:
        torch.Tensor.float = lambda self: self.double()
    if opts.whole:
        import repro_torch.distributed.sharding as SH
        SH.tp_axes = lambda: ()


def inputs(opts, layers: int = 0):
    """(bundle, params, batch) of the tests' family step (seeds 2, 3) or,
    with `--noisy`, of the noisy optical step (seeds 0, 1)."""
    from repro_torch.models.model import ShapeSpec, make_inputs
    if opts.noisy:
        from repro_torch.data import TokenPipeline
        cfg = dataclasses.replace(get_smoke("qwen3-32b"), rosa_mlp=True)
        batch = TokenPipeline(cfg.vocab, 32, B, seed=1).batch(0)
        seed = 0
    else:
        cfg = get_smoke(opts.arch)
        batch = None
        seed = 2
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(seed))
    if batch is None:
        batch, _ = make_inputs(cfg, ShapeSpec("t", "train", S, B),
                               concrete=True,
                               generator=torch.Generator().manual_seed(3))
    if opts.float64:
        params = map_tree(lambda t: t.double(), params)
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    return bundle, params, batch


def engine(opts):
    if not opts.noisy:
        return contextlib.nullcontext()
    from repro_torch import rosa
    from repro_torch.core import mrr
    from repro_torch.core.constants import Mapping
    from repro_torch.rosa.backends import RosaConfig
    return rosa.engine_context(rosa.Engine.from_config(
        RosaConfig(noise=mrr.PAPER_NOISE, mapping=Mapping.IS,
                   backend=opts.noisy), key=torch.Generator().manual_seed(3)))


def grads_rank(rank, world, device, opts):
    from repro_torch.distributed.sharding import gather, shard_tree
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    setup(opts)
    mesh = make_test_mesh(*opts.mesh)
    bundle, params, batch = inputs(opts)
    layout = ST.train_layout(bundle, mesh, B)
    local = shard_tree(params, layout.specs, mesh)
    with engine(opts):
        loss, grads = ST.sharded_loss_and_grads(
            bundle, local, layout.local_batch(batch), layout)
    spec_of = dict(leaves(layout.specs))
    whole = {p: gather(g, spec_of[p], mesh).numpy()
             for p, g in leaves(grads)}
    return float(loss), whole if rank == 0 else None


def count_rank(rank, world, device, opts, layers):
    """The gloo collectives of this rank's second step."""
    import torch.distributed as dist
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import AdamWConfig
    torch.set_num_threads(1)
    setup(opts)
    counts: dict = {}
    for name in ("all_reduce", "all_gather", "all_to_all_single"):
        real = getattr(dist, name)

        def wrap(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)
        setattr(dist, name, wrap)
    mesh = make_test_mesh(*opts.mesh)
    cfg = dataclasses.replace(get_smoke(opts.arch), n_layers=layers)
    bundle = build_model(cfg)
    layout = ST.train_layout(bundle, mesh, 2 * B)
    params = shard_tree(bundle.init(torch.Generator().manual_seed(0)),
                        layout.specs, mesh)
    opt = ST.init_opt_state(params)
    step = ST.make_train_step(bundle, AdamWConfig(), layout=layout)
    batch = layout.local_batch(TokenPipeline(cfg.vocab, 32, 2 * B,
                                             seed=0).batch(0))
    step(params, opt, batch)
    counts.clear()
    step(params, opt, batch)
    return sum(counts.values())


def floor(bundle, params, batch, grads, opts) -> float:
    """The largest move of a leaf's gradient (over its max) under two
    permutations of the params' d_model axis."""
    axes = dict(leaves(map_tree(lambda d: d.axes, bundle.skeleton)))
    worst = 0.0
    for seed in (1, 2):
        perm = torch.randperm(bundle.cfg.d_model,
                              generator=torch.Generator().manual_seed(seed))

        def pm(path, t):
            for ax, name in enumerate(axes[path]):
                if name == "embed":
                    t = t.index_select(ax, perm)
            return t
        with engine(opts):
            _, g2 = ST.loss_and_grads(bundle, unflatten(
                (p, pm(p, t)) for p, t in leaves(params)), batch)
        got = dict(leaves(g2))
        for p, g in leaves(grads):
            worst = max(worst, float((pm(p, g) - got[p]).abs().max())
                        / float(g.abs().max() + 1e-30))
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--mesh", default="2x2", help="data x model")
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--whole", action="store_true")
    ap.add_argument("--noisy", choices=("ref", "fused"))
    ap.add_argument("--count", action="store_true")
    opts = ap.parse_args()
    opts.mesh = tuple(int(n) for n in opts.mesh.split("x"))
    world = opts.mesh[0] * opts.mesh[1]
    if opts.count:
        got = {n: runtime.spawn(count_rank, world, device_type="cpu",
                                backend="gloo", args=(opts, n),
                                timeout=600)[0] for n in (2, 4)}
        print(f"{opts.arch} {opts.mesh}"
              + (" whole" if opts.whole else " split")
              + f": collectives a step and rank {got}, "
              f"{(got[4] - got[2]) / 2:.1f} a layer")
        return
    outs = runtime.spawn(grads_rank, world, device_type="cpu",
                         backend="gloo", args=(opts,), timeout=600)
    setup(opts)
    bundle, params, batch = inputs(opts)
    with engine(opts):
        loss, grads = ST.loss_and_grads(bundle, params, batch)
    got = outs[0][1]
    dev = max(float(np.abs(got[p] - g.numpy()).max())
              / float(g.abs().max() + 1e-30) for p, g in leaves(grads))
    name = "qwen3-32b-smoke noisy " + opts.noisy if opts.noisy \
        else opts.arch + "-smoke"
    print(f"{name} {opts.mesh}" + (" float64" if opts.float64 else "")
          + (" whole" if opts.whole else " split")
          + f": loss {outs[0][0]!r} vs one process {float(loss)!r} (rel "
          f"{abs(outs[0][0] - float(loss)) / abs(float(loss)):.2e}); the "
          f"gradient's largest move a leaf {dev:.2e} of its max; the "
          f"one-process floor (d_model permuted) "
          f"{floor(bundle, params, batch, grads, opts):.2e}")


if __name__ == "__main__":
    main()
