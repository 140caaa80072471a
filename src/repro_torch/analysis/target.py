"""`AnalysisTarget` — one unit of code the checks inspect (PyTorch port of
`repro.analysis.target`, with no jaxpr and no HLO).

A target bundles a callable with the arguments to run it on, plus the
*declared* intent the checks verify against what the call really does:

  state_argnums — positions of the arguments the step must update in
                  place (the port's counterpart of `donate_argnums`: the
                  port's steps keep their state in its own storage where
                  the reference donates it to a jitted step);
  hot_path      — this function runs per serving tick / per token, so
                  host round trips and undeclared state are findings, not
                  style;
  gemm_shapes   — (name, m, k, n) workload shapes for the kernel
                  preflight (a target may carry only shapes, no fn);
  ssd_shapes    — (name, B, L, H, P, S) workloads for `ssd_scan`'s.

`run()` records ONE call of `fn(*example_args)` (cached) under a
`TorchDispatchMode` recorder of the ATen ops it dispatches, and keeps what
the checks read: host round trips, random draws with the generator state
each consumed, the first float64 results, and which state tensors came
back in a new storage.  The recorded call is the second: the first, not
recorded, fills the process's one-time caches (`core.mrr.chain_constants`
reads its float32 constants off host tensors once), as a served step runs
warm; the reference traces, so its checks never see such work either.
The CUDA kernels are called through ctypes and are not seen; the tensors
their wrappers allocate are.  The calls mutate the example arguments as
the step would.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import hashlib
import os
import sys
import warnings
from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_TORCH_DIR = os.path.dirname(torch.__file__)
_THIS = os.path.abspath(__file__)
# ops whose result is a host value read off the device
_HOST_READS = {"_local_scalar_dense", "equal", "is_nonzero"}
# what torch.cuda.set_sync_debug_mode("warn") says at a synchronizing op
_SYNC_WARNING = "called a synchronizing CUDA operation"


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a pytree of dicts, lists, tuples and
    dataclasses (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix or "/", tree)]
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return []
    return [pair for k, v in items for pair in leaves(v, f"{prefix}/{k}")]


def _nodes(tree):
    """Every node of a pytree, the root first."""
    yield tree
    if isinstance(tree, dict):
        kids = tree.values()
    elif isinstance(tree, (list, tuple)):
        kids = tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kids = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        return
    for k in kids:
        yield from _nodes(k)


def materialize(tree, device):
    """`tree` with every `meta` tensor replaced by zeros on `device` (real
    tensors are kept): the example arguments a `rosa.compile` traced."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "meta":
            return tree
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize(v, device) for v in tree)
    return tree


def call_site() -> str:
    """`module path:function` of the innermost frame outside torch and
    this module: where the model code issued the op.  No line number, so
    a finding's fingerprint survives edits around it."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if not path.startswith(_TORCH_DIR) and path != _THIS:
            return f"{_module_path(path)}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


def _module_path(path: str) -> str:
    """A source path from `repro_torch/` on (else its base name)."""
    i = path.rfind(os.sep + "repro_torch" + os.sep)
    rel = path[i + 1:] if i >= 0 else os.path.basename(path)
    return rel.replace(os.sep, "/")


@functools.lru_cache(maxsize=None)
def _functions(path: str) -> list:
    """(first line, last line, name) of every def and lambda in a file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return [(n.lineno, n.end_lineno,
             getattr(n, "name", "<lambda>")) for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda))]


def _site_of(filename: str, lineno: int) -> str:
    """`call_site()`'s form for a warning's (file, line): the innermost
    def or lambda holding the line."""
    path = os.path.abspath(filename)
    try:
        spans = [f for f in _functions(path) if f[0] <= lineno <= f[1]]
    except (OSError, SyntaxError):
        spans = []
    name = max(spans)[2] if spans else "<module>"
    return f"{_module_path(path)}:{name}"


@functools.lru_cache(maxsize=None)
def _draws(packet) -> bool:
    """Whether an op family takes a Generator (so it draws random bits)."""
    return any("Generator" in str(a.type)
               for ov in packet.overloads()
               for a in getattr(packet, ov)._schema.arguments)


def _device_of(args, kwargs) -> torch.device:
    if kwargs.get("device") is not None:
        return torch.device(kwargs["device"])
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def generator_state(gen: torch.Generator) -> tuple:
    """(device, seed, digest of the state): equal for two generators that
    will draw the same numbers next."""
    digest = hashlib.sha1(gen.get_state().numpy().tobytes()).hexdigest()
    return (gen.device.type, gen.initial_seed(), digest[:16])


@dataclasses.dataclass(frozen=True)
class Draw:
    """One random op: where, which op, the generator state it consumed,
    and whether it drew from the global default generator."""

    site: str
    op: str
    state: tuple
    default: bool


@dataclasses.dataclass
class Run:
    """What one call of a target's fn did."""

    host_syncs: list = dataclasses.field(default_factory=list)  # (op, site)
    # sites of the syncs torch.cuda.set_sync_debug_mode("warn") reported
    # (on the card only; it also sees copies no ATen op shows, such as a
    # device tensor made from a host scalar)
    sync_warnings: list = dataclasses.field(default_factory=list)
    draws: list = dataclasses.field(default_factory=list)       # Draw
    f64: list = dataclasses.field(default_factory=list)         # (op, site)
    # argnum -> paths of its tensors that came back in a new storage, or
    # None when the state did not come back in the result at all
    fresh_state: dict = dataclasses.field(default_factory=dict)


class _Recorder(TorchDispatchMode):
    def __init__(self, run: Run):
        super().__init__()
        self.run = run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        op = f"aten.{packet.__name__}"
        if _draws(packet):
            gen = kwargs.get("generator")
            default = gen is None
            if default:
                dev = _device_of(args, kwargs)
                gen = (torch.cuda.default_generators[dev.index or 0]
                       if dev.type == "cuda" else torch.default_generator)
            self.run.draws.append(Draw(call_site(), op,
                                       generator_state(gen), default))
        out = func(*args, **kwargs)
        if packet.__name__ in _HOST_READS or _device_to_host(
                packet.__name__, args, kwargs):
            self.run.host_syncs.append((op, call_site()))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
               for t in tree_leaves(out)):
            self.run.f64.append((op, call_site()))
        return out


def _device_to_host(name: str, args, kwargs) -> bool:
    """A copy of a CUDA tensor into host memory."""
    if name == "_to_copy":
        dst = kwargs.get("device")
        return (args[0].is_cuda and dst is not None
                and torch.device(dst).type == "cpu")
    if name == "copy_":
        return not args[0].is_cuda and args[1].is_cuda
    return False


@dataclasses.dataclass
class AnalysisTarget:
    name: str
    fn: Callable | None = None
    example_args: tuple = ()
    state_argnums: tuple[int, ...] = ()
    hot_path: bool = False
    gemm_shapes: tuple[tuple[str, int, int, int], ...] = ()
    # (name, B, L, H, P, S) workloads for the ssd_scan preflight
    ssd_shapes: tuple[tuple[str, int, int, int, int, int], ...] = ()

    _run: Run | None = dataclasses.field(default=None, repr=False)

    def run(self) -> Run:
        """One warm call of `fn(*example_args)` under the recorder
        (cached)."""
        if self._run is not None:
            return self._run
        if self.fn is None:
            raise ValueError(f"target {self.name!r} has no callable")
        self.fn(*self.example_args)                 # warm-up, not recorded
        run = Run()
        before = {i: {p: t.untyped_storage().data_ptr()
                      for p, t in leaves(self.example_args[i])}
                  for i in self.state_argnums
                  if i < len(self.example_args)}
        on_cuda = any(t.is_cuda for _, t in leaves(self.example_args))
        prev_mode = torch.cuda.get_sync_debug_mode() if on_cuda else 0
        synchronize = torch.cuda.synchronize

        def recorded_synchronize(*a, **kw):
            run.host_syncs.append(("torch.cuda.synchronize", call_site()))
            return synchronize(*a, **kw)

        torch.cuda.synchronize = recorded_synchronize
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if on_cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    with _Recorder(run):
                        out = self.fn(*self.example_args)
                finally:
                    if on_cuda:
                        torch.cuda.set_sync_debug_mode(prev_mode)
        finally:
            torch.cuda.synchronize = synchronize
        run.sync_warnings = [_site_of(w.filename, w.lineno) for w in caught
                             if _SYNC_WARNING in str(w.message)]
        for i, ptrs in before.items():
            node = next((n for n in _nodes(out)
                         if {p for p, _ in leaves(n)} == set(ptrs)), None)
            run.fresh_state[i] = None if node is None else [
                p for p, t in leaves(node)
                if t.untyped_storage().data_ptr() != ptrs[p]]
        self._run = run
        return run


def program_target(program, example_args: Sequence[Any], *,
                   name: str = "program",
                   device: str | torch.device | None = None
                   ) -> AnalysisTarget:
    """Build the verification target for a `rosa.Program`.

    The program runs `apply_fn` under its frozen engine with a fresh
    generator as its base key (so a noisy layer draws, as the reference's
    abstract key makes its trace draw) on the example arguments, whose
    `meta` tensors become zeros on `device` (None: CUDA).  Programs take
    no declared state (`rosa.compile` has no `donate_argnums`)."""
    device = torch.device(device if device is not None else "cuda")
    key = torch.Generator(device).manual_seed(0)
    return AnalysisTarget(
        name=name, fn=lambda *args: program(*args, key=key),
        example_args=materialize(tuple(example_args), device))
