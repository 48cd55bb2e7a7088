"""
Re-export of the profiler trace hooks, which live in
``gordo_tpu_torch.observability.profiler`` (the port of
``gordo_tpu.utils.tracing``): ``_active`` is the same object as the
profiler's, so code that sets it steers the real hooks.
"""

from gordo_tpu_torch.observability.profiler import (  # noqa: F401
    PROFILE_DIR_ENV_VAR,
    _active,
    annotate,
    maybe_trace,
    profile_dir,
)

__all__ = ["PROFILE_DIR_ENV_VAR", "annotate", "maybe_trace", "profile_dir"]
