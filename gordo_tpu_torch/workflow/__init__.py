"""
Project configs (the port of ``gordo_tpu.workflow``'s config half): the
YAML reader, ``get_dict_from_yaml``, ``patch_dict`` and
``NormalizedConfig``. The Argo workflow generator is not ported.
"""

from .helpers import patch_dict

__all__ = ["patch_dict"]
