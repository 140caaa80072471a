"""Port parity of the architecture registry's metadata (`repro_torch.configs`,
`models.moe.MoEConfig`, `models.mla.MLAConfig`, the zoo fields of
`models.transformer.ModelConfig`) and of the GEMM-lowered model zoo
(`configs.model_zoo`) against the JAX reference, on the CPU.

The zoo rows must be equal (names, m, k, n, groups, kind); its DSE sweep
and the EDP-only hybrid plans within 1e-9 relative, with equal labels and
plans.  All ten architectures build; the four dense ones that were
metadata only until slice 11 now come from `get_config` / `get_smoke`
as the zoo reads them.
"""

import dataclasses
import importlib

import pytest

from repro_torch.configs import (ARCH_IDS, ARCHS, PORTED_ARCHS,
                                 get_config, get_smoke, get_workload_zoo,
                                 zoo_config)
from repro_torch.configs import model_zoo as TZ
from repro_torch.core import dse
from repro_torch.core import mapping as TM
from repro_torch.core.constants import ROSA_OPTIMAL
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.models.transformer import PORTED_FAMILIES
from test_torch_ref import reference

# ModelConfig fields of the reference that only steer XLA layout (the
# port carries `remat`, its train-time recomputation policy, and
# `moe_ep`, its expert-parallel MoE under a live mesh)
XLA_ONLY = {"parallelism"}
# metadata only until slice 11 (the dense configs and the vision frontend)
NEW_ARCHS = ["deepseek-67b", "gemma3-12b", "mistral-large-123b",
             "phi-3-vision-4.2b"]


@pytest.fixture(scope="module")
def R():
    return reference()


def _rows(layers):
    return [(s.name, s.m, s.k, s.n, s.groups, s.kind) for s in layers]


def _fields(cfg) -> dict:
    """A config as a dict; nested configs as dicts, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif f.name == "cache_dtype":
            v = str(v).rsplit(".", 1)[-1].strip("'>")
        out[f.name] = v
    return out


@pytest.mark.parametrize("seq_len", [TZ.ZOO_SEQ_LEN, 96])
@pytest.mark.parametrize("arch", ARCHS)
def test_layers_from_config_matches_reference(R, arch, seq_len):
    got = TZ.layers_from_config(zoo_config(arch), seq_len)
    want = R.model_zoo.layers_from_config(R.configs.get_config(arch), seq_len)
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(R, arch):
    """Every field the port carries equals the reference's, CONFIG and
    SMOKE; the port leaves out only the XLA layout fields."""
    port = importlib.import_module(f"repro_torch.configs.{arch}")
    ref = importlib.import_module(f"repro.configs.{arch}")
    for which in ("CONFIG", "SMOKE"):
        got = _fields(getattr(port, which))
        want = _fields(getattr(ref, which))
        assert set(want) - set(got) == XLA_ONLY
        assert got == {k: v for k, v in want.items() if k not in XLA_ONLY}
        assert getattr(port, which).is_encdec == getattr(ref, which).is_encdec
    if ref.CONFIG.mla is not None:
        assert port.CONFIG.mla.cache_width == ref.CONFIG.mla.cache_width


def test_registry_ids_equal_reference(R):
    assert ARCHS == R.configs.ARCHS
    assert ARCH_IDS == R.configs.ARCH_IDS


def test_zoo_sweep_matches_reference(R):
    wls = get_workload_zoo()
    jwls = R.configs.get_workload_zoo()
    assert [w.name for w in wls] == [w.name for w in jwls]
    assert sum(len(w.layers) for w in wls) == 5176
    pts = dse.sweep(wls, batch=8, device="cpu")
    jpts = R.dse.sweep(jwls, engine="vmap", batch=8)
    assert [p.label for p in pts] == [p.label for p in jpts]
    assert pts[0].label == "R=16,C=8,T=8"
    for p, q in zip(pts, jpts, strict=True):
        assert p.metric == pytest.approx(q.metric, rel=1e-9)


def test_profile_and_hybrid_plan_on_the_zoo_match_reference(R):
    for wl, jwl in zip(get_workload_zoo(), R.configs.get_workload_zoo(),
                       strict=True):
        prof = TM.profile_layers_fast(wl.layers, ROSA_OPTIMAL, batch=8,
                                      device="cpu")
        jprof = R.mapping.profile_layers_fast(
            jwl.layers, R.constants.ROSA_OPTIMAL, batch=8)
        for p, q in zip(prof, jprof, strict=True):
            assert p.name == q.name
            assert p.e_is == pytest.approx(q.e_is, rel=1e-9), wl.name
            assert p.e_ws == pytest.approx(q.e_ws, rel=1e-9), wl.name
        assert {k: v.value for k, v in TM.hybrid_plan(prof).items()} == \
            {k: v.value for k, v in R.mapping.hybrid_plan(jprof).items()}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_architectures_refuse_to_build(arch):
    """Once refused as metadata only, each of the four now builds from the
    registry: `get_config` hands out the zoo's CONFIG, and the full and
    smoke configs build models of a ported family."""
    assert arch in PORTED_ARCHS
    assert get_config(arch) is zoo_config(arch)
    for get in (get_config, get_smoke):
        bundle = build_model(get(arch))
        assert bundle.cfg.family == "dense" in PORTED_FAMILIES
        assert bundle.n_params > 0
    assert (get_config(arch).frontend == "vision") == (
        arch == "phi-3-vision-4.2b")


def test_serve_offers_only_ported_architectures():
    arch = next(a for a in serve.build_parser()._actions if a.dest == "arch")
    assert sorted(arch.choices) == sorted(ARCH_IDS) == [
        "deepseek-67b", "deepseek-v2-236b", "gemma3-12b", "mamba2-1.3b",
        "mistral-large-123b", "phi-3-vision-4.2b", "qwen3-32b",
        "qwen3-moe-235b-a22b", "seamless-m4t-medium", "zamba2-1.2b"]
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--arch", "llama-70b"])
