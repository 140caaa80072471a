"""Reference harness for the PyTorch port's tests (`tests/test_torch_*.py`).

The port (`repro_torch`) is held against the JAX package (`repro`) on the
CPU: inputs are made from a seed with numpy and fed to both.  This module
is the only place the port's tests reach the JAX package from:

  * `reference()` imports `repro` lazily, from fixtures.  The installed jax
    no longer has `jax.experimental.enable_x64`, which two reference
    modules use; the alias to `jax.enable_x64` is applied here, inside the
    function, never at import — test files collected before a fixture runs
    keep their own outcome.
  * numpy converters between the two packages;
  * `assert_quantized_parity`, a restatement of the flip-aware bound of
    `tests/test_kernels.py` (that module imports `repro` at import time).

Pallas kernels run on the JAX side as the JAX tests run them off-TPU: in
interpret mode.
"""

import importlib
import os
import types

import numpy as np
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

_REF_MODULES = {
    "constants": "repro.core.constants", "energy": "repro.core.energy",
    "mapping": "repro.core.mapping", "mrr": "repro.core.mrr",
    "osa": "repro.core.osa", "quant": "repro.core.quant",
    "rosa": "repro.rosa", "backends": "repro.rosa.backends",
    "fused_ops": "repro.kernels.rosa_fused.ops",
    "fused_ref": "repro.kernels.rosa_fused.ref",
    "osa_ops": "repro.kernels.osa_matmul.ops",
    "osa_ref": "repro.kernels.osa_matmul.ref",
    "ssd_ops": "repro.kernels.ssd_scan.ops",
    "ssd_ref": "repro.kernels.ssd_scan.ref", "ssm": "repro.models.ssm",
    "variation": "repro.robust.variation", "configs": "repro.configs",
    "model": "repro.models.model", "transformer": "repro.models.transformer",
    "serve": "repro.serve", "metrics": "repro.serve.metrics",
    "mt_kernel": "repro.kernels.mrr_transfer.mrr_transfer",
    "mt_ops": "repro.kernels.mrr_transfer.ops",
    "mt_ref": "repro.kernels.mrr_transfer.ref", "cnn": "repro.models.cnn",
    "module": "repro.models.module", "cnn_train": "repro.training.cnn_train",
    "synth_cifar": "repro.data.synth_cifar",
    "paper_cnns": "repro.configs.paper_cnns",
    "energy_vec": "repro.core.energy_vec", "dse": "repro.core.dse",
    "model_zoo": "repro.configs.model_zoo",
    "ensemble": "repro.robust.ensemble",
    "sensitivity": "repro.robust.sensitivity", "drift": "repro.robust.drift",
    "robust_report": "repro.robust.report", "schema": "repro.bench.schema",
    "compare": "repro.bench.compare",
    "moe": "repro.models.moe", "mla": "repro.models.mla",
    "layers": "repro.models.layers", "steps": "repro.launch.steps",
    "optim": "repro.optim", "optim_schedules": "repro.optim.schedules",
    "compress": "repro.distributed.compress", "tokens": "repro.data.tokens",
    "sharding": "repro.distributed.sharding",
    "checkpoint": "repro.checkpoint",
    "obs": "repro.obs", "obs_cli": "repro.obs.cli",
    "analysis": "repro.analysis", "analysis_cli": "repro.analysis.cli",
}


def reference() -> types.SimpleNamespace:
    """The reference modules (plus `jax`, `jnp`), imported on first call."""
    import jax
    import jax.experimental
    import jax.numpy as jnp
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    ns = {k: importlib.import_module(v) for k, v in _REF_MODULES.items()}
    return types.SimpleNamespace(jax=jax, jnp=jnp, **ns)


def to_np(a) -> np.ndarray:
    """A jax array or torch tensor as a numpy array (copy)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


BF16_STEP = 2.0 ** -8          # bfloat16's relative rounding step


def cache_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a cache of either package, dict keys sorted."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in cache_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, t in enumerate(tree)
                for pair in cache_leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def rel_err(got, want) -> float:
    """max|got - want| over max|want|, in float64; the shapes must agree."""
    got = to_np(got).astype(np.float64)
    want = to_np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def assert_logits_match(lg, jlg, tol: float = 1e-4) -> None:
    """Within `tol` of max|ref| with the argmax equal, row by row."""
    assert rel_err(lg, jlg) <= tol
    assert np.array_equal(to_np(lg).argmax(-1), to_np(jlg).argmax(-1))


def assert_caches_match(cache, jcache, tol: float = 1e-4) -> None:
    """The same leaves, paths and dtypes; int32 leaves equal, float32
    leaves within `tol` of their max, bfloat16 leaves within one bfloat16
    step (2^-8) of their max: a float32 value within float noise of a
    bfloat16 rounding boundary may round the other way."""
    got, want = cache_leaves(cache), cache_leaves(jcache)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(to_np(a), to_np(b))
            continue
        bound = BF16_STEP if a.dtype == torch.bfloat16 else tol
        assert rel_err(a.float(), b.astype("float32")) <= bound, path


def assert_quantized_parity(y, y_ref, *, qmax: int = 127,
                            tight: float = 2e-4) -> None:
    """Two implementations of the same quantized pipeline in different
    float op orders: a conditioned activation within float noise of a
    requantization boundary may flip its 8-bit code by one, moving that
    row's outputs by at most one requant LSB (~1/qmax of full scale).  The
    bulk must match at accumulation tightness, no deviation may exceed the
    one-LSB bound, and flipped rows must stay rare."""
    y = to_np(y).astype(np.float64)
    y = y.reshape(-1, y.shape[-1])
    r = to_np(y_ref).astype(np.float64).reshape(y.shape)
    scale = max(float(np.max(np.abs(r))), 1.0)
    d = np.abs(y - r) / scale
    assert d.max() <= 2.0 / qmax, \
        f"deviation {d.max():.2e} exceeds the one-LSB flip bound"
    bad_rows = int((d.max(axis=-1) > tight).sum())
    allowed = max(2, -(-y.shape[0] // 4))
    assert bad_rows <= allowed, \
        (f"{bad_rows} rows (of {y.shape[0]}) beyond the tight tolerance — "
         "more than requant boundary flips can explain")


def test_reference_loads_and_runs_interpret_kernel():
    """The harness reaches the reference and its Pallas kernel runs in
    interpret mode on the CPU."""
    R = reference()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 40)).astype(np.float32)
    w = rng.normal(size=(40, 24)).astype(np.float32)
    y = to_np(R.osa_ops.osa_matmul(R.jnp.asarray(x), R.jnp.asarray(w)))
    q, s = R.quant.quantize(R.jnp.asarray(x))
    np.testing.assert_allclose(y, to_np(q) @ w * (to_np(s) / 127),
                               rtol=1e-5, atol=1e-5)
