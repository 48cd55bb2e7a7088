"""
Builds every machine of a project config in one process (the port of
``gordo_tpu.builder.local_build``).
"""

import io
from typing import Any, Iterable, Tuple

from gordo_tpu_torch.builder.build_model import ModelBuilder
from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.workflow.config_elements.normalized_config import NormalizedConfig
from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml


def local_build(config_str: str, device: DeviceLike = None) -> Iterable[Tuple[Any, Machine]]:
    """
    ``(model, machine)`` for each machine of a YAML project config, built
    one after another in this process on ``device`` (the card unless
    ``"cpu"`` is asked for), the way a deployed build takes them: read,
    normalized under the project name ``local-build``, then fetched,
    cross-validated and fitted.

    >>> models = list(local_build(config_yaml, device="cpu"))  # doctest: +SKIP
    """
    config = get_dict_from_yaml(io.StringIO(config_str))
    normed = NormalizedConfig(config, project_name="local-build")
    for machine in normed.machines:
        yield ModelBuilder(machine=machine).build(device=device)
