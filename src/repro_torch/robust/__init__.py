"""Monte-Carlo device-variation subsystem (PyTorch port of `repro.robust`).

The paper's noise story at its two time scales:

  per-shot noise       `mrr.NoiseModel`: a fresh DAC/thermal draw every
                       realization (Eq. 8);
  per-device variation `variation`: static fab mismatch, thermal-crosstalk
                       bias and driver offsets, drawn once per chip as
                       `{layer: mrr.StaticVariation}`; an ensemble carries
                       a leading chip axis;
  chip ensembles       `ensemble`: per-chip accuracy, clean agreement and
                       yield; by default antithetic pairs plus a
                       control-variate regression on a weight-realization
                       surrogate (`EstimatorConfig`, `estimate_ensemble`),
                       `FULL_MC` is brute force;
  sensitivity          `sensitivity`: perturb-one-layer degradation
                       matrices through one-hot gates and mapping gates,
                       feeding `mapping.LayerProfile.d_is / d_ws`, and the
                       accuracy-verified hybrid plan search;
  drift + re-trim      `drift`: thermal drift schedules with periodic
                       re-calibration through `mrr.voltage_of_weight`'s
                       `dt_trim` hook;
  reports              `report`: accuracy-vs-sigma and yield curves in the
                       bench schema.

Variation-aware QAT is `training.cnn_train.train_cnn(ensemble=...)`.  CLI:
``python -m repro_torch.robust {ensemble,sensitivity,drift,sweep}``.  Not
ported yet (ROADMAP Queue 1 item 4): `cnn_degradation_source` and the
`smoke` runner, which need `rosa.PlanCache`.
"""

from repro_torch.robust.drift import (DriftModel, DriftResult,
                                      residual_offsets, simulate,
                                      simulate_cnn, trim_voltages)
from repro_torch.robust.ensemble import (FULL_MC, EnsembleResult,
                                         EstimatorConfig, clean_reference,
                                         control_variate_accs,
                                         estimate_ensemble,
                                         evaluate_cnn_ensemble,
                                         evaluate_ensemble, layer_weights,
                                         make_ensemble_eval, make_plan_eval,
                                         surrogate_features)
from repro_torch.robust.sensitivity import (accuracy_guarded_plan,
                                            cnn_degradation_matrix,
                                            cnn_profiles_mc,
                                            degradation_matrix,
                                            params_digest, plan_search,
                                            profile_layers_mc,
                                            refresh_degradation_matrix,
                                            searched_cnn_hybrid_plan,
                                            searched_hybrid_plan)
from repro_torch.robust.variation import (NO_VARIATION, PAPER_VARIATION,
                                          VariationModel, chip_at,
                                          chip_slice, cnn_lane_dims,
                                          ensemble_size, from_reference,
                                          sample_chip, sample_ensemble,
                                          scale_ensemble, shift_thermal)

__all__ = [
    "DriftModel", "DriftResult", "EnsembleResult", "EstimatorConfig",
    "FULL_MC", "NO_VARIATION", "PAPER_VARIATION", "VariationModel",
    "accuracy_guarded_plan", "chip_at", "chip_slice", "clean_reference",
    "cnn_degradation_matrix", "cnn_lane_dims", "cnn_profiles_mc",
    "control_variate_accs", "degradation_matrix", "ensemble_size",
    "estimate_ensemble", "evaluate_cnn_ensemble", "evaluate_ensemble",
    "from_reference", "layer_weights", "make_ensemble_eval",
    "make_plan_eval", "params_digest", "plan_search", "profile_layers_mc",
    "refresh_degradation_matrix", "residual_offsets", "sample_chip",
    "sample_ensemble", "scale_ensemble", "searched_cnn_hybrid_plan",
    "searched_hybrid_plan", "shift_thermal", "simulate", "simulate_cnn",
    "trim_voltages",
]
