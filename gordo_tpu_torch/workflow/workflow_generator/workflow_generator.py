"""
Project config loading (the port of ``gordo_tpu.workflow.workflow_generator``'s
``get_dict_from_yaml``), through the port's YAML reader. The Argo
workflow templates are not ported.
"""

import io
import os
from typing import Union

from gordo_tpu_torch.workflow.yaml_reader import safe_load


def get_dict_from_yaml(config_file: Union[str, io.StringIO]) -> dict:
    """
    A config file (a path or a file-like object) as a dict, unwrapping the
    Kubernetes custom resource's ``spec.config`` when it is there. Every
    timestamp must carry a timezone (``ValueError`` otherwise).
    """
    if hasattr(config_file, "read"):
        yaml_content = safe_load(config_file, require_timezone=True)
    else:
        path_to_config_file = os.path.abspath(config_file)
        try:
            with open(path_to_config_file, "r") as yamlfile:
                yaml_content = safe_load(yamlfile, require_timezone=True)
        except FileNotFoundError:
            raise FileNotFoundError(f"Unable to find config file <{path_to_config_file}>")
    if isinstance(yaml_content, dict) and "spec" in yaml_content:
        yaml_content = yaml_content["spec"]["config"]
    return yaml_content
