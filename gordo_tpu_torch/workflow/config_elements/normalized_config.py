"""
A loaded project config: its machines with the default globals, the
project's globals and each machine's own blocks laid over one another
(the port of ``gordo_tpu.workflow.config_elements.normalized_config``).

``DEFAULT_CONFIG_GLOBALS`` is the JAX package's, key for key, the
TPU-era builder keys (``machines_per_pod``, ``tpu``) too: they are wire
data that every normalized machine carries.
"""

from typing import List

from gordo_tpu_torch.machine import Machine
from gordo_tpu_torch.machine.validators import fix_runtime
from gordo_tpu_torch.workflow.helpers import patch_dict


def _pod_resources(req_mem: int, req_cpu: int, lim_mem: int, lim_cpu: int) -> dict:
    """A k8s resources block: (requests, limits) x (memory, cpu)."""
    return {
        "resources": {
            "requests": {"memory": req_mem, "cpu": req_cpu},
            "limits": {"memory": lim_mem, "cpu": lim_cpu},
        }
    }


def _calculate_influx_resources(nr_of_machines: int) -> dict:
    """Influx's resources, which grow with the number of machines."""
    memory = 3000 + 220 * nr_of_machines
    return _pod_resources(
        min(memory, 28000),
        min(500 + 10 * nr_of_machines, 4000),
        min(memory, 48000),
        10000 + 20 * nr_of_machines,
    )["resources"]


class NormalizedConfig:

    DEFAULT_CONFIG_GLOBALS: dict = {
        "runtime": {
            "reporters": [],
            "server": _pod_resources(3000, 1000, 6000, 2000),
            "prometheus_metrics_server": _pod_resources(200, 100, 1000, 200),
            "builder": {
                **_pod_resources(3900, 1001, 3900, 1001),
                "remote_logging": {"enable": False},
                "machines_per_pod": 30,
                "tpu": {"enable": False, "accelerator": "v5litepod-16"},
            },
            "client": {
                **_pod_resources(3500, 100, 4000, 2000),
                "max_instances": 30,
            },
            "influx": {"enable": True},
        },
        "evaluation": {
            "cv_mode": "full_build",
            "scoring_scaler": "sklearn.preprocessing.RobustScaler",
            "metrics": [
                "explained_variance_score",
                "r2_score",
                "mean_squared_error",
                "mean_absolute_error",
            ],
        },
    }

    machines: List[Machine]
    globals: dict

    def __init__(self, config: dict, project_name: str):
        default_globals = patch_dict(self.DEFAULT_CONFIG_GLOBALS, {})  # a deep copy
        default_globals["runtime"]["influx"]["resources"] = _calculate_influx_resources(
            len(config["machines"])
        )
        patched_globals = patch_dict(default_globals, config.get("globals", dict()))
        if patched_globals.get("runtime"):
            patched_globals["runtime"] = fix_runtime(patched_globals["runtime"])

        self.project_name = project_name
        self.machines = [
            Machine.from_config(conf, project_name=project_name, config_globals=patched_globals)
            for conf in config["machines"]
        ]
        self.globals = patched_globals
