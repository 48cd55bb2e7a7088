"""
The environment of the port's ``build-fleet`` tests.

``build-fleet`` reads the environment variables of the JAX command's
options that the port refuses (``cli.UNPORTED_FLEET_OPTIONS``, as the JAX
command reads ``GORDO_WORKER_ID`` and the others), so a variable that an
earlier test in the same process left set makes a later build a usage
error. Every port test that runs ``build-fleet`` or its option check
clears them first: through :func:`fleet_env` (a test's own
``monkeypatch``), or :func:`clear_fleet_env` inside a module fixture's
``MonkeyPatch.context()``. The names come from the tuple itself, so an
entry added there is cleared too.
"""

import json

import pytest

from gordo_tpu_torch.cli import cli

#: the environment variables ``build-fleet`` reads for its refused options
FLEET_ENV_VARS = tuple(env for _, env, _, _ in cli.UNPORTED_FLEET_OPTIONS if env is not None)

ONE_MACHINE = json.dumps([{
    "name": "env-pump",
    "project_name": "env-project",
    "dataset": {
        "type": "RandomDataset",
        "tags": ["tag-0", "tag-1", "tag-2"],
        "train_start_date": "2019-01-01T00:00:00+00:00",
        "train_end_date": "2019-01-01T12:00:00+00:00",
        "asset": "gra",
    },
    "model": {"gordo_tpu.models.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 1, "batch_size": 16}},
}])


def clear_fleet_env(mp: pytest.MonkeyPatch) -> None:
    """Remove every variable of :data:`FLEET_ENV_VARS` through ``mp``."""
    for name in FLEET_ENV_VARS:
        mp.delenv(name, raising=False)


@pytest.fixture
def fleet_env(monkeypatch):
    """The test's ``monkeypatch``, with the fleet variables removed."""
    clear_fleet_env(monkeypatch)
    return monkeypatch


def test_the_names_cover_every_refused_variable():
    assert "GORDO_WORKER_ID" in FLEET_ENV_VARS
    assert len(FLEET_ENV_VARS) == sum(env is not None for _, env, _, _ in cli.UNPORTED_FLEET_OPTIONS)


def test_a_set_worker_id_is_still_refused_and_the_cleared_build_succeeds(tmp_path, monkeypatch,
                                                                          capsys):
    """The CLI keeps reading ``GORDO_WORKER_ID`` as the JAX CLI does: set,
    the bare command is a usage error; cleared by the fixture's helper,
    the same command builds."""
    monkeypatch.setenv("GORDO_WORKER_ID", "0")
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["build-fleet", ONE_MACHINE, str(tmp_path / "refused"), "--device", "cpu"])
    assert exit_info.value.code == 2
    assert ("build-fleet --worker-id is not ported yet (ROADMAP.md queue 1 item 9)"
            in capsys.readouterr().err)
    assert not (tmp_path / "refused").exists()
    clear_fleet_env(monkeypatch)
    code = cli.main(["build-fleet", ONE_MACHINE, str(tmp_path / "built"), "--device", "cpu"])
    assert code == 0
    assert (tmp_path / "built" / "env-pump" / "metadata.json").is_file()
