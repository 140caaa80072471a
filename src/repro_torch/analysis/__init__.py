"""`repro_torch.analysis` — verification of compiled optical programs and
serving steps (PyTorch port of `repro.analysis`, the half that does not
read XLA).

The stack's core invariants are invisible to output-level tests: per-shot
noise draws must be independent (one reused generator state correlates
the whole Monte-Carlo ensemble), serving state must really be updated in
place (or decode doubles its footprint), the CUDA kernels must launch at
every zoo shape, hot loops must stay free of host round trips.  The
reference decides them from jaxprs and optimized HLO; the port runs each
target once under a recorder of the ATen ops it dispatches
(`target.AnalysisTarget.run`) and reads the kernels' `preflight()`s.

Three surfaces:

  * `rosa.compile(..., verify="error"|"warn"|"off")` runs the pass on the
    compiled Program (`verify_program` is the hook);
  * `python -m repro_torch.analysis` scans the model zoo + serving steps,
    exiting non-zero on findings its baseline does not acknowledge;
  * the committed baseline is `src/repro_torch/analysis/baseline.json`
    (the reference's schema and fingerprints).

Check catalog (each module under `checks/` registers itself):

  prng       PRNG001 generator-state reuse / PRNG002 default generator in
             a hot path / PRNG003 generator seeded from a constant /
             PRNG004 loop-invariant key
  donation   DON001 state rebuilt, not updated in place / DON002 hot-path
             step with no declared state
  recompile  REC002 float64 promotion
  kernels    KER001 shared memory over the card's limit / KER002 padding
             waste / KER003 launch contract violation
  purity     PUR001 host round trip in a loop / PUR002 host round trip in
             a hot path
"""

from repro_torch.analysis.baseline import load_baseline, write_baseline
from repro_torch.analysis.findings import (AnalysisReport, Finding, Severity,
                                           VerificationError)
from repro_torch.analysis.registry import all_checks, register, run_checks
from repro_torch.analysis.target import AnalysisTarget, program_target

__all__ = [
    "AnalysisReport", "AnalysisTarget", "Finding", "Severity",
    "VerificationError", "all_checks", "load_baseline", "program_target",
    "register", "run_checks", "verify_program", "write_baseline",
]


def verify_program(program, example_args, *, name: str = "program",
                   checks=None, device=None) -> AnalysisReport:
    """Run the checks over a compiled `rosa.Program`: one call of the
    program on `example_args` (`meta` tensors become zeros on `device`,
    None: CUDA) with a fresh generator as its key — what
    `rosa.compile(verify=...)` calls."""
    return run_checks([program_target(program, example_args, name=name,
                                      device=device)], checks=checks)
