"""
The port's config layer against the JAX package's: ``NormalizedConfig``
machines (compared as JSON after each side's ``MachineEncoder``), the
``Machine`` round trips, the validators, ``fix_runtime`` and
``patch_dict``; then ``local_build`` of the conftest project on the CPU
against the JAX ``local_build``.

Tolerances: machine dicts exactly; ``local_build`` CV scores rtol 1e-4
and predictions atol 1e-4 (float32 nets in another summation order).
Both builds start from the JAX init (handed to the port through
``BaseTorchEstimator._initial_state``, as ``tests/test_torch_cross_validate.py``
does) with ``shuffle`` off, since threefry and Philox never agree.
"""

import copy
import io
import json
import re
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
import yaml

from gordo_tpu.builder import local_build as jax_local_build
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu.machine import MachineEncoder as JaxMachineEncoder
from gordo_tpu.machine import validators as jax_validators
from gordo_tpu.workflow.config_elements.normalized_config import (
    NormalizedConfig as JaxNormalizedConfig,
)
from gordo_tpu.workflow.config_elements.normalized_config import (
    _calculate_influx_resources as jax_influx_resources,
)
from gordo_tpu.workflow.helpers import patch_dict as jax_patch_dict
from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml as jax_get_dict_from_yaml
from gordo_tpu_torch.builder.local_build import local_build
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.machine import Machine, MachineEncoder, ReporterException, validators
from gordo_tpu_torch.machine.metadata import BuildMetadata, Metadata
from gordo_tpu_torch.models import AutoEncoder
from gordo_tpu_torch.workflow import patch_dict
from gordo_tpu_torch.workflow.config_elements.normalized_config import (
    NormalizedConfig,
    _calculate_influx_resources,
)
from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml
from tests.conftest import CONFIG_STR, GORDO_BASE_TARGETS, GORDO_SINGLE_TARGET
from tests.test_torch_pipeline import _jax_initial_state

REPO_ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = REPO_ROOT / "examples"


def as_json(machine, encoder) -> dict:
    return json.loads(json.dumps(machine.to_dict(), cls=encoder))


def _normalized_pairs(source: str, project: str):
    if source == "conftest":
        config = get_dict_from_yaml(io.StringIO(CONFIG_STR))
        jax_config = jax_get_dict_from_yaml(io.StringIO(CONFIG_STR))
    else:
        config = get_dict_from_yaml(str(EXAMPLES / source))
        jax_config = jax_get_dict_from_yaml(str(EXAMPLES / source))
    return (NormalizedConfig(config, project_name=project),
            JaxNormalizedConfig(jax_config, project_name=project))


@pytest.mark.parametrize("source", ["config.yaml", "conftest"])
def test_normalized_machines_equal_jax(source):
    ours, theirs = _normalized_pairs(source, "plant-a-anomaly")
    assert [m.name for m in ours.machines] == [m.name for m in theirs.machines]
    for got, want in zip(ours.machines, theirs.machines):
        assert as_json(got, MachineEncoder) == as_json(want, JaxMachineEncoder), got.name
    assert ours.globals == theirs.globals
    assert NormalizedConfig.DEFAULT_CONFIG_GLOBALS == JaxNormalizedConfig.DEFAULT_CONFIG_GLOBALS


def _fleet():
    return get_dict_from_yaml(str(EXAMPLES / "machines_fleet.yaml"))


@pytest.mark.parametrize("index", range(4))
def test_fleet_machines_from_config_equal_jax(index):
    raw = _fleet()[index]
    got = Machine.from_config(raw, project_name=raw["project_name"])
    want = JaxMachine.from_config(
        jax_get_dict_from_yaml(str(EXAMPLES / "machines_fleet.yaml"))[index],
        project_name=raw["project_name"],
    )
    assert as_json(got, MachineEncoder) == as_json(want, JaxMachineEncoder)
    # no globals: the default evaluation, unscaled
    assert got.evaluation == want.evaluation == {"cv_mode": "full_build"}
    assert len(got.to_dict()["dataset"]) == 18


@pytest.mark.parametrize("machines", [0, 1, 5, 200])
def test_influx_resources_equal_jax(machines):
    assert _calculate_influx_resources(machines) == jax_influx_resources(machines)


def test_machine_round_trips():
    raw = _fleet()[0]
    machine = Machine.from_config(raw, project_name=raw["project_name"])
    again = Machine.from_dict(machine.to_dict())
    assert again == machine and hash(again) == hash(machine)
    assert again.host == "gordoserver-example-fleet-example-pump-0"
    assert json.loads(str(machine)) == as_json(machine, MachineEncoder)
    copied = Machine.unvalidated(**machine.to_dict())
    assert copied == machine and copied.dataset is not machine.dataset
    assert Metadata.from_dict(machine.metadata.to_dict()) == machine.metadata
    assert BuildMetadata.from_dict({"model": {"model_offset": 3}}).model.model_offset == 3


def test_machine_encoder_writes_datetimes_and_numpy_scalars_as_jax():
    value = {"when": datetime(2019, 1, 2, 3, 4, 5, 6, tzinfo=timezone.utc),
             "f": np.float32(0.5), "i": np.int64(3)}
    assert json.dumps(value, cls=MachineEncoder) == json.dumps(value, cls=JaxMachineEncoder)


def test_machine_report_refuses_configured_reporters():
    raw = copy.deepcopy(_fleet()[0])
    Machine.from_config(raw, project_name="p").report()  # none configured
    raw["runtime"] = {"reporters": [{"gordo_tpu.reporters.postgres.PostgresReporter": {}}]}
    with pytest.raises(ReporterException, match="not ported"):
        Machine.from_config(raw, project_name="p").report()


# -- validators -------------------------------------------------------------


@pytest.mark.parametrize(
    "name", ["a", "pump-4130", "a" * 63, "A", "-a", "a-", "a_b", "a" * 64, "a.b", "", 5]
)
def test_valid_url_string_agrees_with_jax(name):
    def refuses(module):
        try:
            module.ValidUrlString().validate(name)
        except ValueError:
            return True
        return False

    assert refuses(validators) == refuses(jax_validators)


@pytest.mark.parametrize(
    "value,ok",
    [
        ("2019-01-01T00:00:00+00:00", True),
        (datetime(2019, 1, 1, tzinfo=timezone.utc), True),
        ("2019-01-01T00:00:00", False),
        (datetime(2019, 1, 1), False),
        (20190101, False),
    ],
)
def test_valid_datetime_agrees_with_jax(value, ok):
    class Holder:
        ours = validators.ValidDatetime()
        theirs = jax_validators.ValidDatetime()

    holder = Holder()
    for attr in ("ours", "theirs"):
        if ok:
            setattr(holder, attr, value)
            assert getattr(holder, attr).tzinfo is not None
        else:
            with pytest.raises(ValueError):
                setattr(holder, attr, value)


def test_valid_model_refuses_a_model_the_port_lacks():
    raw = copy.deepcopy(_fleet()[0])
    raw["model"] = {"sklearn.decomposition.PCA": {"n_components": 2}}
    JaxMachine.from_config(copy.deepcopy(raw), project_name="p")  # the JAX package has it
    with pytest.raises(ValueError, match="Invalid model config"):
        Machine.from_config(raw, project_name="p")
    raw["model"] = "not a dict"
    for machine_cls in (Machine, JaxMachine):
        with pytest.raises(ValueError, match="Model config must be a dict"):
            machine_cls.from_config(copy.deepcopy(raw), project_name="p")
    Machine.unvalidated(  # the dry run is skipped
        name="a", project_name="p", dataset=raw["dataset"],
        model={"sklearn.decomposition.PCA": {}},
    )


@pytest.mark.parametrize(
    "field,value",
    [("name", "Bad_Name"), ("project_name", "-p"), ("runtime", [1]), ("metadata", 5)],
)
def test_machine_fields_refuse_what_jax_refuses(field, value):
    raw = copy.deepcopy(_fleet()[0])
    kwargs = dict(name=raw["name"], project_name="p", model=raw["model"],
                  dataset=raw["dataset"])
    kwargs[field] = value
    for machine_cls in (Machine, JaxMachine):
        with pytest.raises((ValueError, TypeError)):
            machine_cls(**copy.deepcopy(kwargs))


RUNTIMES = [
    {"builder": {"resources": {"requests": {"memory": 4000, "cpu": 2000},
                               "limits": {"memory": 3900, "cpu": 1001}}}},
    {"server": {"resources": {"requests": {"memory": "100"}, "limits": {"memory": 50}}},
     "influx": {"enable": False}},
    {"client": {"resources": {"limits": {"cpu": 3}}, "max_instances": 4}, "reporters": []},
    {"builder": {"resources": {"requests": {"cpu": "many"}}}},
]


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_fix_runtime_equals_jax(runtime):
    def run(module):
        try:
            return module.fix_runtime(runtime)
        except ValueError as err:
            return ("ValueError", str(err))

    before = copy.deepcopy(runtime)
    assert run(validators) == run(jax_validators)
    assert runtime == before  # the input is not changed


@pytest.mark.parametrize(
    "original,patch",
    [
        ({"a": {"b": 1, "c": 2}}, {"a": {"b": 10}}),
        ({"a": {"b": 1}}, {"a": {"d": 3}, "e": [1, {"f": 2}]}),
        ({"a": [1, 2]}, {"a": {"x": 1}}),
        ({"a": {"b": {"c": 1}}}, {"a": {"b": None}}),
        ({}, {}),
    ],
)
def test_patch_dict_equals_jax(original, patch):
    before = copy.deepcopy((original, patch))
    got = patch_dict(original, patch)
    assert got == jax_patch_dict(original, patch)
    assert (original, patch) == before


# -- local_build --------------------------------------------------------------

# the conftest project with the fits' shuffle off (threefry against Philox)
UNSHUFFLED_CONFIG = re.sub(
    r"( *)kind: feedforward_hourglass\n", r"\g<0>\1shuffle: false\n", CONFIG_STR
)


@pytest.fixture(scope="module")
def local_builds():
    """{name: (port model, port machine, JAX model, JAX machine)} of the
    conftest project built by both packages' ``local_build``."""
    assert UNSHUFFLED_CONFIG.count("shuffle: false") == 2
    assert yaml.safe_load(UNSHUFFLED_CONFIG)["machines"][0]["model"]
    jax_built = {machine.name: (model, machine)
                 for model, machine in jax_local_build(UNSHUFFLED_CONFIG)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
        built = {machine.name: (model, machine)
                 for model, machine in local_build(UNSHUFFLED_CONFIG, device="cpu")}
    assert list(built) == list(jax_built) == [GORDO_SINGLE_TARGET, GORDO_BASE_TARGETS[0]]
    return {name: (*built[name], *jax_built[name]) for name in built}


@pytest.mark.parametrize("name", [GORDO_SINGLE_TARGET, GORDO_BASE_TARGETS[0]])
def test_local_build_cv_scores_match_jax(local_builds, name):
    _, machine, _, jax_machine = local_builds[name]
    assert machine.project_name == jax_machine.project_name == "local-build"
    got = machine.metadata.build_metadata.model.cross_validation
    want = jax_machine.metadata.build_metadata.model.cross_validation
    assert set(got.scores) == set(want.scores) and got.scores
    for metric, stats in want.scores.items():
        for stat, value in stats.items():
            np.testing.assert_allclose(
                got.scores[metric][stat], value, rtol=1e-4, atol=1e-6, err_msg=f"{metric} {stat}"
            )
    assert {k: v if isinstance(v, int) else str(v) for k, v in got.splits.items()} == {
        k: v if isinstance(v, int) else str(v) for k, v in want.splits.items()
    }


@pytest.mark.parametrize("name", [GORDO_SINGLE_TARGET, GORDO_BASE_TARGETS[0]])
def test_local_build_predictions_match_jax(local_builds, name):
    model, machine, jax_model, _ = local_builds[name]
    X, _, _ = _get_dataset(machine.dataset.to_dict()).get_data()
    np.testing.assert_allclose(
        model.predict(X), np.asarray(jax_model.predict(X)), rtol=1e-4, atol=1e-4
    )
    meta = machine.metadata.build_metadata
    assert meta.model.model_offset == 0 and meta.dataset.query_duration_sec > 0
    assert as_json(machine, MachineEncoder)["dataset"] == as_json(
        local_builds[name][3], JaxMachineEncoder
    )["dataset"]
