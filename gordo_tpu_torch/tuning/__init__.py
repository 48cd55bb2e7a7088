"""
The telemetry-driven tuner (the port of ``gordo_tpu.tuning``): from what
a fleet recorded about itself to measured knob defaults.

- :mod:`.knobs`: the knob registry (flag, variable, default, domain,
  judging signals, and whether the port has the knob);
- :mod:`.corpus`: the schema-tolerant reader of telemetry reports, event
  logs, persisted rollups and sweep results;
- :mod:`.model`: the per-fleet cost model (best measured arm, analytic
  fallback where the corpus is thin);
- :mod:`.profile`: the versioned ``tuning_profile.json`` that
  ``build-fleet`` and ``run-server`` read by default;
- :mod:`.calibrate`: short measurement sweeps for a fleet with no corpus.

Only :mod:`.calibrate` needs torch, and it imports it when it runs.
"""

from gordo_tpu_torch.tuning.corpus import Corpus, Observation, read_corpus
from gordo_tpu_torch.tuning.knobs import (
    KNOBS,
    KNOBS_BY_ENV,
    KNOBS_BY_NAME,
    NON_KNOB_ENV_VARS,
    Knob,
    Signal,
    declared_env_vars,
    get_knob,
    knobs_for_subsystem,
    tunable_knobs,
)
from gordo_tpu_torch.tuning.model import ArmEvidence, Recommendation, fit_recommendations
from gordo_tpu_torch.tuning.profile import (
    PROFILE_VERSION,
    TUNING_PROFILE_FILENAME,
    TuningProfileError,
    UnportedKnobError,
    build_profile,
    load_collection_profile,
    load_profile,
    recommended_values,
    resolve_profile_path,
    validate_profile,
    write_profile,
)

__all__ = [
    "ArmEvidence",
    "Corpus",
    "KNOBS",
    "KNOBS_BY_ENV",
    "KNOBS_BY_NAME",
    "Knob",
    "NON_KNOB_ENV_VARS",
    "Observation",
    "PROFILE_VERSION",
    "Recommendation",
    "Signal",
    "TUNING_PROFILE_FILENAME",
    "TuningProfileError",
    "UnportedKnobError",
    "build_profile",
    "declared_env_vars",
    "fit_recommendations",
    "get_knob",
    "knobs_for_subsystem",
    "load_collection_profile",
    "load_profile",
    "read_corpus",
    "recommended_values",
    "resolve_profile_path",
    "tunable_knobs",
    "validate_profile",
    "write_profile",
]
