"""
``build-fleet --resume`` in the port (``FleetModelBuilder.build(resume=True)``)
against the JAX builder's, on the CPU at a small size.

Both builders build ``examples/machines_fleet.yaml`` into a directory of
their own; then in each, one artifact is removed, one machine's model
config is changed, and one machine is recorded as a casualty in
``build_report.json``. The resume scans (``_scan_resumable``) must reuse
and rebuild the same machines in both, and the resumed builds report the
same ``n_resumed``. The CLI flag and ``GORDO_FLEET_RESUME`` turn resume on,
``--no-resume`` off.
"""

import copy
import json
import shutil

import pytest
import torch
import yaml

from gordo_tpu.builder.fleet_build import FleetModelBuilder as JaxFleetModelBuilder
from gordo_tpu_torch import serializer
from gordo_tpu_torch.builder.fleet_build import BUILD_REPORT_FILENAME, FleetModelBuilder
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.machine import Machine
from tests.test_torch_fleet_build import FLEET_YAML, _jax_machines
from tests.test_torch_fleet_env import clear_fleet_env, fleet_env  # noqa: F401

torch.set_num_threads(1)


def _port_machines(configs):
    """Machines as ``build-fleet`` makes them (the definition with its
    defaults)."""
    out = []
    for config in copy.deepcopy(configs):
        config["model"] = {key.replace("gordo_tpu.", "gordo_tpu_torch."): value
                           for key, value in config["model"].items()}
        machine = Machine.from_config(config, project_name=config["project_name"])
        machine.model = serializer.from_definition(machine.model).into_definition()
        out.append(machine)
    return out


def _edited(configs):
    """The configs with example-compressor-0's model changed."""
    configs = copy.deepcopy(configs)
    for config in configs:
        if config["name"] == "example-compressor-0":
            (model,) = config["model"].values()
            model["epochs"] = 3
    return configs


def _damage(base):
    """Remove example-pump-1's artifact and record example-compressor-1
    as quarantined in the build report."""
    shutil.rmtree(base / "example-pump-1")
    report = json.loads((base / BUILD_REPORT_FILENAME).read_text())
    report["quarantined"] = [{"machine": "example-compressor-1", "epoch": 0}]
    (base / BUILD_REPORT_FILENAME).write_text(json.dumps(report))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(configs, port base, JAX base), each built once and then damaged."""
    configs = yaml.safe_load(open(FLEET_YAML).read())
    root = tmp_path_factory.mktemp("resume")
    port_base, jax_base = root / "port", root / "jax"
    FleetModelBuilder(_port_machines(configs), device="cpu").build(port_base)
    JaxFleetModelBuilder(_jax_machines(configs)).build(jax_base)
    for base in (port_base, jax_base):
        _damage(base)
    return configs, port_base, jax_base


REUSED = ["example-pump-0"]
REBUILT = ["example-compressor-0", "example-compressor-1", "example-pump-1"]


def test_resume_scan_matches_jax(built):
    configs, port_base, jax_base = built
    edited = _edited(configs)
    port_reused, port_rest = FleetModelBuilder(_port_machines(edited), device="cpu") \
        ._scan_resumable(_port_machines(edited), port_base)
    jax_reused, jax_rest = JaxFleetModelBuilder(_jax_machines(edited)) \
        ._scan_resumable(_jax_machines(edited), jax_base)
    assert sorted(port_reused) == sorted(jax_reused) == REUSED
    assert sorted(m.name for m in port_rest) == sorted(m.name for m in jax_rest) == REBUILT
    assert FleetModelBuilder._prior_casualties(port_base) == {
        "example-compressor-1": "quarantined"}


def test_resumed_build_reuses_and_rebuilds(built, tmp_path):
    configs, port_base, _ = built
    base = tmp_path / "again"
    shutil.copytree(port_base, base)
    before = (base / "example-pump-0" / "params.npz").stat().st_mtime_ns
    builder = FleetModelBuilder(_port_machines(_edited(configs)), device="cpu")
    results = builder.build(base, resume=True)
    assert [m.name for _, m in results] == [c["name"] for c in configs]
    report = json.loads((base / BUILD_REPORT_FILENAME).read_text())
    assert report["n_resumed"] == 1 and report["n_built"] == 3
    assert report["quarantined"] == []  # the casualty was rebuilt cleanly
    assert (base / "example-pump-0" / "params.npz").stat().st_mtime_ns == before
    assert (base / "example-pump-1" / "metadata.json").is_file()
    stored = serializer.load_metadata(base / "example-compressor-0")
    (model,) = stored["model"].values()
    assert model["epochs"] == 3
    # everything current now: a second resume reuses all four, trains none
    again = FleetModelBuilder(_port_machines(_edited(configs)), device="cpu")
    again.build(base, resume=True)
    assert again.build_report_["n_resumed"] == 4 and again.build_report_["n_built"] == 0
    assert again.telemetry_report_["n_buckets"] == 0


def test_resume_needs_an_output_dir():
    with pytest.raises(ValueError, match="output_dir_base"):
        FleetModelBuilder([], device="cpu").build(None, resume=True)


def _reports(base):
    return json.loads((base / BUILD_REPORT_FILENAME).read_text())


def test_cli_flag_and_env(built, tmp_path, fleet_env, capsys):  # noqa: F811
    monkeypatch = fleet_env
    configs, port_base, _ = built
    text = json.dumps([dict(c, model={k.replace("gordo_tpu.", "gordo_tpu_torch."): v
                                      for k, v in c["model"].items()}) for c in configs])
    base = tmp_path / "cli"
    assert cli.main(["build-fleet", text, str(base), "--device", "cpu"]) == 0
    assert _reports(base)["n_resumed"] == 0
    assert cli.main(["build-fleet", text, str(base), "--device", "cpu", "--resume"]) == 0
    assert _reports(base)["n_resumed"] == 4
    monkeypatch.setenv("GORDO_FLEET_RESUME", "true")
    shutil.rmtree(base / "example-pump-0")
    assert cli.main(["build-fleet", text, str(base), "--device", "cpu"]) == 0
    assert _reports(base)["n_resumed"] == 3 and _reports(base)["n_built"] == 1
    assert cli.main(["build-fleet", text, str(base), "--device", "cpu", "--no-resume"]) == 0
    assert _reports(base)["n_resumed"] == 0 and _reports(base)["n_built"] == 4
