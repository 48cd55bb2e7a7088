"""
The build command's options, the port's against the JAX command's:
``--model-parameter`` (``expand_model``, a model config template's
``{{ name }}`` variables), ``--model-register-dir`` (the build cache: a
second build of the same machine loads the first's artifact and trains
nothing) and ``--exceptions-report-level`` (each level's report file and
the exit code, on the same failing machine).
"""

import json

import pytest
import yaml
from click.testing import CliRunner

from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
from gordo_tpu.cli import cli as jax_cli
from gordo_tpu.machine import Machine as JaxMachine
from gordo_tpu_torch.builder import ModelBuilder
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.models.core import BaseTorchEstimator
from gordo_tpu_torch.utils import disk_registry
from tests.test_torch_cli import BASE_MODEL_YAML

TEMPLATES = [
    ("gordo_tpu.models.AutoEncoder: {kind: '{{ kind }}', epochs: {{epochs}}}",
     {"kind": "feedforward_hourglass", "epochs": "3"}),
    ("gordo_tpu.models.AutoEncoder:\n  kind: {{ kind }}\n  epochs: {{ n }}\n"
     "  batch_size: {{ n }}\n", {"kind": "feedforward_symmetric", "n": "7", "unused": "x"}),
    ("sklearn.pipeline.Pipeline:\n  steps:\n    - sklearn.preprocessing.{{ scaler }}\n"
     "    - gordo_tpu.models.AutoEncoder: {kind: feedforward_hourglass}\n",
     {"scaler": "MinMaxScaler"}),
    ("gordo_tpu.models.AutoEncoder: {kind: feedforward_hourglass}", {}),
]


@pytest.mark.parametrize("template,params", TEMPLATES)
def test_expand_model_matches_jax(template, params):
    assert cli.expand_model(template, params) == jax_cli.expand_model(template, params)


def test_expand_model_refuses_an_undefined_name_as_jax():
    template = "gordo_tpu.models.AutoEncoder: {kind: '{{ kind }}', epochs: {{ epochs }}}"
    with pytest.raises(ValueError) as want:
        jax_cli.expand_model(template, {"kind": "feedforward_hourglass"})
    with pytest.raises(ValueError) as got:
        cli.expand_model(template, {"kind": "feedforward_hourglass"})
    assert str(got.value) == str(want.value) == "Model parameter missing value!"
    with pytest.raises(ValueError, match="jinja2 syntax"):
        cli.expand_model("{% if x %}a{% endif %}: {}", {"x": "1"})


def _templated_machine():
    machine = yaml.safe_load(BASE_MODEL_YAML)
    machine["model"] = ("gordo_tpu.models.AutoEncoder: "
                        "{kind: '{{ kind }}', epochs: {{ epochs }}}")
    return machine


def test_build_expands_the_model_template(tmp_path):
    code = cli.main(["build", json.dumps(_templated_machine(), default=str),
                     str(tmp_path / "out"), "--device", "cpu",
                     "--model-parameter", "kind,feedforward_symmetric",
                     "--model-parameter", "epochs,2"])
    assert code == 0
    definition = json.loads((tmp_path / "out" / "definition.json").read_text())
    (estimator,) = definition.values()
    assert estimator["kind"] == "feedforward_symmetric" and estimator["epochs"] == 2
    # a template with a missing parameter fails as the JAX command fails
    report = tmp_path / "report.json"
    code = cli.main(["build", json.dumps(_templated_machine(), default=str),
                     str(tmp_path / "out2"), "--device", "cpu",
                     "--model-parameter", "kind,feedforward_hourglass",
                     "--exceptions-reporter-file", str(report)])
    assert code == 1
    assert json.loads(report.read_text()) == {
        "type": "ValueError", "message": "Model parameter missing value!"}


def test_model_parameter_needs_a_comma(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["build", "{}", "/nonexistent", "--model-parameter", "kind"])
    assert exit_info.value.code == 2
    assert "Expected 'key,value'" in capsys.readouterr().err


def test_second_build_hits_the_register_and_writes_no_new_artifact(tmp_path, monkeypatch):
    register, out = tmp_path / "register", tmp_path / "out"
    args = ["build", BASE_MODEL_YAML, str(out), "--device", "cpu",
            "--model-register-dir", str(register)]
    assert cli.main(args) == 0
    machine = yaml.safe_load(BASE_MODEL_YAML)
    key = ModelBuilder(machine).cache_key
    assert [p.name for p in register.iterdir()] == [key]
    assert disk_registry.get_value(register, key) == str(out)
    files = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in out.iterdir()}

    def no_training(*args, **kwargs):
        raise AssertionError("a cache hit trains nothing")

    monkeypatch.setattr(BaseTorchEstimator, "fit", no_training)
    assert cli.main(args) == 0
    assert {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in out.iterdir()} == files
    # the same machine through MODEL_REGISTER_DIR, into another directory:
    # the cached model is written there, still without training
    monkeypatch.setenv("MODEL_REGISTER_DIR", str(register))
    assert cli.main(["build", BASE_MODEL_YAML, str(tmp_path / "copy"), "--device", "cpu"]) == 0
    assert (tmp_path / "copy" / "params.npz").read_bytes() == files["params.npz"][1]


def test_cache_keys_never_meet_jax_keys():
    """The port's key takes the JAX fingerprint with the port's package
    name, so a register shared with JAX builds never hands one package
    the other's artifact; a change that does not alter the model (its
    runtime) keeps the key."""
    machine = yaml.safe_load(BASE_MODEL_YAML)
    port_key = ModelBuilder(machine).cache_key
    jax_key = JaxModelBuilder(JaxMachine.from_config(
        yaml.safe_load(BASE_MODEL_YAML), project_name=machine["project_name"])).cache_key
    assert len(port_key) == len(jax_key) == 128 and port_key != jax_key
    assert ModelBuilder(dict(machine, runtime={"x": 1})).cache_key == port_key
    changed = yaml.safe_load(BASE_MODEL_YAML)
    changed["evaluation"] = {"seed": 3}
    assert ModelBuilder(changed).cache_key != port_key


FAILING = yaml.safe_load(BASE_MODEL_YAML)
FAILING["dataset"]["n_samples_threshold"] = 100_000


@pytest.mark.parametrize("level", ["EXIT_CODE", "TYPE", "MESSAGE", "TRACEBACK", "message"])
def test_exceptions_report_level_matches_jax(level, tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_XLA_CACHE_DIR", "")
    want_file, got_file = tmp_path / "jax.json", tmp_path / "port.json"
    result = CliRunner().invoke(jax_cli.gordo, [
        "build", json.dumps(FAILING, default=str), str(tmp_path / "jax-out"),
        "--exceptions-reporter-file", str(want_file), "--exceptions-report-level", level,
    ])
    code = cli.main(["build", json.dumps(FAILING, default=str), str(tmp_path / "port-out"),
                     "--device", "cpu", "--exceptions-reporter-file", str(got_file),
                     "--exceptions-report-level", level])
    assert code == result.exit_code == 80
    got, want = (json.loads(path.read_text()) for path in (got_file, want_file))
    assert list(got) == list(want)
    if "traceback" in want:
        # the frames are each package's own; the raise line names the same
        # error and message
        assert got["type"] == want["type"] == "InsufficientDataError"
        assert (got["traceback"].strip().splitlines()[-1].split(": ", 1)[1]
                == want["traceback"].strip().splitlines()[-1].split(": ", 1)[1])
        assert len(got["traceback"]) <= cli.MAX_MESSAGE_LEN
    else:
        assert got == want


def test_exceptions_report_level_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("EXCEPTIONS_REPORT_LEVEL", "TYPE")
    report = tmp_path / "report.json"
    code = cli.main(["build", json.dumps(FAILING, default=str), str(tmp_path / "out"),
                     "--device", "cpu", "--exceptions-reporter-file", str(report)])
    assert code == 80
    assert json.loads(report.read_text()) == {"type": "InsufficientDataError"}
