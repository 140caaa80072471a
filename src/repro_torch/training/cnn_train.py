"""QAT training + noisy evaluation for the reduced CNN families (PyTorch port
of `repro.training.cnn_train`).

The paper's Sec. 4 protocol: train with uniform 8-bit quantization of
inputs and weights (straight-through), then evaluate under DAC + thermal
noise with a chosen per-layer IS/WS mapping, on synth-CIFAR.

Execution routes through the compile-once `rosa.Program`: a model + engine
pair is compiled once (`cnn_program` -> `rosa.compile`, a trace on `meta`
tensors), training differentiates through the program's frozen engine,
evaluation calls the program with an explicit base key (per-layer keys
fold inside), and noisy evaluation compiles a derived program with
per-layer overrides (`ExecutionPlan.build`).

Everything runs on the device the parameters live on; `train_cnn` puts
them on `device` ("cuda" unless the caller asks for the CPU).  Noise keys
are `torch.Generator`s on that device, so draws are made where they are
used.

Variation-aware QAT: pass a chip `ensemble` (`robust.variation`) and step
i pins chip ``i % n_chips`` on the frozen engine, so the model learns
weights that survive the sampled wafer.  With a chip pinned every conv/fc
runs the `rosa_fused` kernel forward (straight-through backward) and each
depthwise weight the `mrr_transfer` kernel forward and backward.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import rosa
from repro_torch.core import mrr
from repro_torch.core.constants import ComputeMode, Mapping
from repro_torch.data.synth_cifar import train_test_split
from repro_torch.models.cnn import LITE_MODELS, LITE_SKIPS, cnn_apply, cnn_def
from repro_torch.models.module import abstract_params, init_params, map_tree

QAT_CFG = rosa.RosaConfig(mode=ComputeMode.MIXED, noise=mrr.IDEAL)

# Adam of the reference's training step (bias-corrected, no weight decay)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-8


def qat_engine(model: str, key: torch.Generator | None = None
               ) -> rosa.Engine:
    """Uniform 8-bit QAT engine for one lite model (all layers QAT_CFG)."""
    names = [s.name for s in LITE_MODELS[model]]
    return rosa.Engine.from_config(QAT_CFG, layers=names, key=key)


def cnn_program(model: str, engine: rosa.Engine | None = None, *,
                example_batch: int = 8) -> rosa.Program:
    """Compile one lite CNN against `engine` into a `rosa.Program`.

    No plan autotune: the engine's plan (uniform QAT, per-layer override,
    hybrid, ...) is frozen as-is; the compile still captures the named-GEMM
    `ProgramTrace`.  The program takes any batch; `example_batch` only
    sizes the trace."""
    specs = LITE_MODELS[model]
    skips = LITE_SKIPS.get(model)
    engine = engine if engine is not None else rosa.Engine.dense()

    def apply_fn(eng, params, x):
        return cnn_apply(params, specs, x, eng, residual_from=skips)

    skel = abstract_params(cnn_def(specs), torch.float32)
    x = torch.empty((example_batch, 32, 32, 3), dtype=torch.float32,
                    device="meta")
    return rosa.compile(apply_fn, engine, (skel, x), autotune=None)


def _loss(params, specs, skips, x, y, engine, key=None) -> torch.Tensor:
    logits = cnn_apply(params, specs, x, engine, key, residual_from=skips)
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.nn.functional.one_hot(y.long(), logits.shape[-1])
    return -torch.mean(torch.sum(labels * logp, dim=-1))


def adam_step(params: dict, m: dict, v: dict, grads: dict, i: int,
              lr: float) -> tuple[dict, dict, dict]:
    """One Adam update of step `i` (0-based), in the reference's order:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, then
    p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), t = i + 1.
    Returns new (params, m, v) trees."""
    t = i + 1
    f = np.float32                 # the bias corrections in float32
    bc1 = float(f(1) - f(ADAM_B1) ** t)
    bc2 = float(f(1) - f(ADAM_B2) ** t)
    m = _zip_map(lambda a, g: ADAM_B1 * a + (1 - ADAM_B1) * g, m, grads)
    v = _zip_map(lambda a, g: ADAM_B2 * a + (1 - ADAM_B2) * g * g, v, grads)
    params = _zip_map(
        lambda p, mm, vv: p - lr * (mm / bc1)
        / (torch.sqrt(vv / bc2) + ADAM_EPS), params, m, v)
    return params, m, v


def _zip_map(fn, *trees):
    """`fn` over the aligned leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree: dict) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    map_tree(out.append, tree)
    return out


def _unflatten(tree: dict, values: list) -> dict:
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


def value_and_grad(params: dict, specs, skips, x, y, engine
                   ) -> tuple[torch.Tensor, dict]:
    """The loss and its (straight-through) gradient tree at `params`."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    loss = _loss(_unflatten(params, leaves), specs, skips, x, y, engine)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _unflatten(params, list(grads))


def train_cnn(model: str = "alexnet", steps: int = 400, batch: int = 64,
              lr: float = 3e-3, seed: int = 0, qat: bool = True,
              n_train: int = 4096, verbose: bool = False, ensemble=None,
              device: str | torch.device = "cuda"):
    """Returns (params, clean_test_accuracy), params on `device`.

    Batches are drawn by numpy from `seed` as the reference draws them;
    the initial parameters come from a generator on `device`.  With a chip
    `ensemble` ({layer: StaticVariation} with a leading chip axis, on
    `device`), step i trains through chip ``i % n_chips``; the returned
    accuracy stays the clean (variation-free) one."""
    device = torch.device(device)
    specs = LITE_MODELS[model]
    skips = LITE_SKIPS.get(model)
    (xtr, ytr), _ = train_test_split(n_train=n_train, seed=seed)
    xtr_t = torch.from_numpy(xtr).to(device)
    ytr_t = torch.from_numpy(ytr).to(device)
    gen = torch.Generator(device).manual_seed(seed)
    params = init_params(cnn_def(specs), gen, device=device)
    # compile once; the training step differentiates through the program's
    # frozen engine (same plan, straight-through grads), evaluation calls
    # the program itself
    program = cnn_program(model, qat_engine(model) if qat
                          else rosa.Engine.dense())
    engine = program.engine
    chips = []
    if ensemble is not None:
        from repro_torch.robust import variation as V
        chips = [V.chip_at(ensemble, c)
                 for c in range(V.ensemble_size(ensemble))]
    m = map_tree(torch.zeros_like, params)
    v = map_tree(torch.zeros_like, params)

    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(xtr), batch)).to(device)
        eng = engine.with_variation(chips[i % len(chips)]) if chips \
            else engine
        loss, g = value_and_grad(params, specs, skips, xtr_t[idx],
                                 ytr_t[idx], eng)
        with torch.no_grad():
            params, m, v = adam_step(params, m, v, g, i, lr)
        if verbose and i % 100 == 0:
            print(f"  step {i} loss {float(loss):.3f}")

    acc = evaluate_cnn(params, model, program=program)
    return params, acc


@functools.lru_cache(maxsize=4)
def _test_set(seed: int, device: str):
    (_, _), (xte, yte) = train_test_split(seed=seed)
    return (torch.from_numpy(xte).to(device),
            torch.from_numpy(yte).to(device))


def params_device(params: dict) -> torch.device:
    """The device the parameter tree lives on."""
    return _leaves(params)[0].device


def eval_logits(params, model: str, program: rosa.Program,
                key: torch.Generator | None = None, variation=None,
                seed: int = 0) -> torch.Tensor:
    """The program's logits on the synth-CIFAR test split (seed + 1)."""
    xte, _ = _test_set(seed, str(params_device(params)))
    with torch.no_grad():
        return program(params, xte, key=key, variation=variation)


def evaluate_cnn(params, model: str, engine: rosa.Engine | None = None,
                 key: torch.Generator | None = None, n_mc: int = 1,
                 seed: int = 0, program: rosa.Program | None = None) -> float:
    """Test accuracy (%); with a noisy engine/program and n_mc > 1, the
    mean over n_mc base keys split from `key` (per-layer keys are folded by
    the engine).  Pass a pre-compiled `program` to skip the compile."""
    device = params_device(params)
    _, yte = _test_set(seed, str(device))
    if program is None:
        program = cnn_program(model, engine)

    def acc_of(k):
        logits = eval_logits(params, model, program, k, seed=seed)
        return torch.mean((torch.argmax(logits, -1) == yte).float())

    if key is None and n_mc == 1:
        return float(acc_of(None)) * 100.0
    base = key if key is not None \
        else torch.Generator(device).manual_seed(7)
    accs = torch.stack([acc_of(k) for k in mrr.split_keys(base, n_mc)])
    return float(torch.mean(accs)) * 100.0


def layer_noise_profile(params, model: str, *,
                        noise: mrr.NoiseModel = mrr.PAPER_NOISE,
                        n_mc: int = 3, seed: int = 0) -> dict:
    """d_l(m): accuracy drop (pp) when ONLY layer l is noisy-analog under
    mapping m, all other layers exact 8-bit (paper Fig. 6 protocol)."""
    specs = LITE_MODELS[model]
    names = [s.name for s in specs]
    base = qat_engine(model)
    clean = evaluate_cnn(params, model, program=cnn_program(model, base))
    out: dict[str, dict[str, float]] = {}
    key = torch.Generator(params_device(params)).manual_seed(seed + 100)
    for s in specs:
        out[s.name] = {}
        for mp in (Mapping.IS, Mapping.WS):
            noisy = dataclasses.replace(QAT_CFG, mapping=mp, noise=noise)
            prog = cnn_program(model, base.with_plan(rosa.ExecutionPlan.build(
                QAT_CFG, {s.name: noisy}, layers=names)))
            acc = evaluate_cnn(params, model, program=prog, key=key,
                               n_mc=n_mc)
            out[s.name][mp.value] = max(clean - acc, 0.0)
    return {"clean": clean, "layers": out}
