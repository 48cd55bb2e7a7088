"""
The port's tuner (``gordo_tpu_torch.tuning``, ``cli/tune.py``) and the
commands that read its profile, against the JAX package's on the same
files. Exact unless stated; floats of the fits at rtol 1e-12 (the same
arithmetic in the same order).

- The knob registry is JAX's field by field, apart from ``unported``,
  which names the knobs the port lacks.
- ``read_corpus`` and ``fit_recommendations`` give JAX's observations and
  recommendations on JAX's ``tests/test_tuning.py`` fixtures, on a port
  CPU build's ``telemetry_report.json`` and event log, and on a JAX
  build's of the same machines (the same observations, by knob, arm and
  signal); a knob the port lacks is never recommended.
- ``build_profile`` and ``validate_profile`` agree (the ``generated``
  stamp aside), and so do ``tune plan --as-json``, ``tune plan --check``
  and ``tune fit``.
- Precedence, for ``build-fleet`` and the server: flag (or explicit
  setting), then environment variable, then profile, then default; no
  profile reads nothing and emits nothing; a profile that names a knob
  the port lacks is refused by name.
- ``tune calibrate`` on the CPU at a tiny size writes a
  ``results_calibration.json`` whose rows have the JAX sweeps' keys.
"""

import contextlib
import copy
import dataclasses
import io
import json
from pathlib import Path

import pytest
import yaml
from click.testing import CliRunner

import tests.test_tuning as jax_fixtures
from gordo_tpu.builder.fleet_build import FleetModelBuilder as JaxFleetModelBuilder
from gordo_tpu.cli import gordo as jax_gordo
from gordo_tpu.observability import registry as jax_registry
from gordo_tpu.tuning import corpus as jax_corpus
from gordo_tpu.tuning import knobs as jax_knobs
from gordo_tpu.tuning import model as jax_model
from gordo_tpu.tuning import profile as jax_profile
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.cli import tune as tune_cli
from gordo_tpu_torch.observability import read_events, registry
from gordo_tpu_torch.server.app import build_app
from gordo_tpu_torch.tuning import calibrate, corpus, knobs, model, profile
from tests.test_torch_fleet_build import _jax_machines
from tests.test_torch_fleet_env import clear_fleet_env

REPO = Path(__file__).resolve().parent.parent
FLEET_YAML = REPO / "examples" / "machines_fleet.yaml"
GENERATED = "2026-08-04T00:00:00+00:00"
#: the knobs the port lacks, with what stays out
UNPORTED = {"donate", "aot_cache", "aot_row_buckets", "program_cache_size",
            "program_min_headroom", "server_threads", "server_workers",
            "server_worker_connections", "server_preload", "router_threads"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("GORDO_TPU_EVENT_LOG", profile.PROFILE_ENV_VAR, "GORDO_BATCH_WAIT_MS",
                 "GORDO_BATCH_QUEUE_LIMIT", "GORDO_SCORER_CACHE_SIZE"):
        monkeypatch.delenv(name, raising=False)
    clear_fleet_env(monkeypatch)
    registry.get_registry().reset()
    jax_registry.get_registry().reset()
    yield
    registry.get_registry().reset()
    jax_registry.get_registry().reset()


def _write(path, payload):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(payload if isinstance(payload, str) else json.dumps(payload))
    return path


# -- the registry --------------------------------------------------------------


def test_the_knob_registry_is_jaxs_field_by_field():
    assert [k.name for k in knobs.KNOBS] == [k.name for k in jax_knobs.KNOBS]
    for mine, theirs in zip(knobs.KNOBS, jax_knobs.KNOBS):
        fields = dataclasses.asdict(mine)
        assert fields.pop("unported") == (None if mine.name not in UNPORTED else mine.unported)
        assert fields == dataclasses.asdict(theirs), mine.name
        assert type(mine.domain).__name__ == type(theirs.domain).__name__
    assert knobs.NON_KNOB_ENV_VARS == jax_knobs.NON_KNOB_ENV_VARS
    assert knobs.declared_env_vars() == jax_knobs.declared_env_vars()
    assert [k.name for k in knobs.tunable_knobs()] == [k.name for k in jax_knobs.tunable_knobs()]
    assert [k.name for k in knobs.knobs_for_subsystem("server", "router")] == \
        [k.name for k in jax_knobs.knobs_for_subsystem("server", "router")]
    assert {k.name for k in knobs.KNOBS if k.unported} == UNPORTED
    assert all(isinstance(k.unported, str) and k.unported for k in knobs.KNOBS if k.unported)
    assert set(knobs.KNOBS_BY_ENV) == set(jax_knobs.KNOBS_BY_ENV)
    with pytest.raises(KeyError) as ours:
        knobs.get_knob("nope")
    with pytest.raises(KeyError) as theirs:
        jax_knobs.get_knob("nope")
    assert str(ours.value) == str(theirs.value)


# -- the corpus and the model ----------------------------------------------------


def _corpora():
    """(label, {relative path: payload}) cases: JAX's fixtures."""
    f = jax_fixtures
    chunk_arm = {"epoch_chunk": 1, "n_dispatches": 10, "steady_state_epoch_s": 0.05,
                 "dispatch_overhead_s": 0.5}
    chunked_arm = {"epoch_chunk": 4, "n_dispatches": 4, "steady_state_epoch_s": 0.05,
                   "dispatch_overhead_s": 0.2}
    queue_arm = {
        "batch_wait_ms": 5.0,
        "gordo_serve_batch_queue_wait_seconds": {
            "count": 100, "sum": 0.2, "buckets": {"0.001": 10, "0.005": 95, "0.01": 99,
                                                  "+Inf": 100}},
        "gordo_serve_batch_requests": {"count": 20, "sum": 100, "buckets": {"+Inf": 20}},
    }
    wrapped = {"batch_wait_ms": 2.0, "gordo_serve_batch_queue_wait_seconds": {
        "kind": "histogram", "series": [{"labels": {}, "value": {
            "count": 10, "sum": 0.05, "buckets": {"+Inf": 10}}}]}}
    trajectory = {"trajectory_schema_version": 1, "entries": [
        {"file": "results_fleet_cpu_r05.json", "bench": "fleet", "revision": "r05",
         "headline_metric": "models_per_hour", "value": 1221.6, "units": "models/hour",
         "models_per_hour": 1221.6, "workers": 1},
        {"file": "results_other.json", "bench": "other"}]}
    events = "\n".join([json.dumps({"event": "x", "epoch_chunk": 8,
                                    "steady_state_sensor_timesteps_per_s": 80000.0}),
                        '{"event": "torn-by-a-cra'])
    return [
        ("pr1-era", {"telemetry_report.json": f.PR1_ERA_REPORT}),
        ("current", {"telemetry_report.json": f.CURRENT_REPORT}),
        ("mixed-eras", {"old/telemetry_report.json": f.PR1_ERA_REPORT,
                        "new/telemetry_report.json": f.CURRENT_REPORT}),
        ("unreadable", {"telemetry_report_torn.json": '{"version": 1,',
                        "telemetry_report.json": f.CURRENT_REPORT}),
        ("jsonl-torn-tail", {"events.jsonl": events}),
        ("queue-wait-histogram", {"results_sweep.json": {"arms": [queue_arm]}}),
        ("registry-wrapper", {"results_wrapped.json": wrapped}),
        ("trajectory", {"trajectory.json": trajectory}),
        ("inherited-context", {"results_x.json": {
            "epoch_chunk": 2, "nested": {"deeper": {"steady_state_epoch_s": 0.1}}}}),
        ("best-arm-max", {"results_sweep.json": {"arms": [
            {"epoch_chunk": 1, "steady_state_sensor_timesteps_per_s": 14000.0},
            {"epoch_chunk": 4, "steady_state_sensor_timesteps_per_s": 52000.0},
            {"epoch_chunk": 8, "steady_state_sensor_timesteps_per_s": 81000.0}]}}),
        ("best-arm-min", {"results_sweep.json": {"arms": [
            {"batch_wait_ms": 0.0, "p99_ms": 45.0}, {"batch_wait_ms": 5.0, "p99_ms": 22.0},
            {"batch_wait_ms": 20.0, "p99_ms": 31.0}]}}),
        ("interpolated-default", {"results_sweep.json": {"arms": [
            {"batch_wait_ms": 10.0, "p99_ms": 30.0}, {"batch_wait_ms": 30.0, "p99_ms": 50.0}]}}),
        ("single-arm", {"results_sweep.json": {"arms": [{"batch_wait_ms": 5.0, "p99_ms": 22.0}]}}),
        ("analytic-epoch-chunk", {"results_sweep.json": {"arms": [chunk_arm]}}),
        ("analytic-from-a-chunked-arm", {"results_sweep.json": {"arms": [chunked_arm]}}),
        ("recorded", {"results_chunk_sweep.json": {"bench_schema_version": 1,
                                                   "epoch_chunk_sweep": f.EPOCH_CHUNK_SWEEP},
                      "results_batch_sweep.json": {"bench_schema_version": 1,
                                                   "arms": f.BATCH_WAIT_SWEEP}}),
        ("unported-knob-sweep", {"results_donate.json": {"arms": [
            {"donate": True, "p99_ms": 20.0}, {"donate": False, "p99_ms": 25.0},
            {"aot_row_buckets": "128,256", "padding_waste_ratio": 0.3},
            {"aot_row_buckets": "64,128", "padding_waste_ratio": 0.1}]}}),
        ("empty", {}),
    ]


def _observations(parsed):
    return [(o.knob, o.value, o.metric, o.metric_value, o.source, dict(o.context))
            for o in parsed.observations]


def _notes(parsed):
    return [(n.path, n.kind, n.n_observations, n.error is None) for n in parsed.files]


def _assert_same_recommendations(got: dict, want: dict) -> None:
    """The port's recommendations equal JAX's for the knobs it has (floats
    at rtol 1e-12); JAX's for knobs it lacks are absent."""
    want = {name: rec for name, rec in want.items() if name not in UNPORTED}
    assert sorted(got) == sorted(want)
    for name in want:
        mine, theirs = got[name].to_dict(), want[name].to_dict()
        for key in ("predicted", "predicted_default", "improvement"):
            a, b = mine.pop(key), theirs.pop(key)
            assert (a is None) == (b is None) and (a is None or a == pytest.approx(b, rel=1e-12))
        for arm_a, arm_b in zip(mine["evidence"], theirs["evidence"]):
            assert arm_a.pop("mean") == pytest.approx(arm_b.pop("mean"), rel=1e-12)
        assert mine == theirs, name


@pytest.mark.parametrize("label, files", _corpora(), ids=[c[0] for c in _corpora()])
def test_corpus_and_recommendations_are_jaxs(tmp_path, label, files):
    for relative, payload in files.items():
        _write(tmp_path / relative, payload)
    ours, theirs = corpus.read_corpus([tmp_path]), jax_corpus.read_corpus([tmp_path])
    assert _observations(ours) == _observations(theirs)
    assert _notes(ours) == _notes(theirs)
    assert ours.meta() == theirs.meta()
    got, want = model.fit_recommendations(ours), jax_model.fit_recommendations(theirs)
    _assert_same_recommendations(got, want)
    if label == "unported-knob-sweep":
        assert "aot_row_buckets" in want and not set(got) & UNPORTED


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """A port CPU ``build-fleet`` of examples/machines_fleet.yaml with its
    event log, and the JAX fleet build of the same machines."""
    root = tmp_path_factory.mktemp("tune-builds")
    text = FLEET_YAML.read_text()
    with pytest.MonkeyPatch.context() as mp:
        clear_fleet_env(mp)
        for name in ("port", "jax"):
            mp.setenv("GORDO_TPU_EVENT_LOG", str(root / name / "events.jsonl"))
            if name == "port":
                assert cli.main(["build-fleet", text, str(root / name), "--device", "cpu"]) == 0
            else:
                JaxFleetModelBuilder(_jax_machines(yaml.safe_load(text))).build(
                    output_dir_base=root / name)
    return root / "port", root / "jax"


def test_a_port_builds_corpus_is_read_and_fitted_as_jax_reads_it(builds):
    port_dir, jax_dir = builds
    files = [port_dir / "telemetry_report.json", port_dir / "events.jsonl"]
    ours, theirs = corpus.read_corpus(files), jax_corpus.read_corpus(files)
    assert _observations(ours) == _observations(theirs)
    assert ours.observations and ours.for_knob("epoch_chunk")
    _assert_same_recommendations(model.fit_recommendations(ours),
                                 jax_model.fit_recommendations(theirs))
    # a JAX build of the same machines states the same knobs, arms and
    # signals (the measured values differ)
    from_jax = jax_corpus.read_corpus([jax_dir / "telemetry_report.json"])
    from_port = corpus.read_corpus([port_dir / "telemetry_report.json"])
    assert {(o.knob, o.value, o.metric) for o in from_port.observations} == \
        {(o.knob, o.value, o.metric) for o in from_jax.observations}


# -- the profile -----------------------------------------------------------------


def _minimal_profile(**recommendations):
    return {"profile_version": profile.PROFILE_VERSION, "generated": GENERATED, "corpus": {},
            "recommendations": {name: {"value": value}
                                for name, value in recommendations.items()}}


def test_build_and_validate_profile_are_jaxs(tmp_path):
    for relative, payload in dict(_corpora())["recorded"].items():
        _write(tmp_path / relative, payload)
    ours, theirs = corpus.read_corpus([tmp_path]), jax_corpus.read_corpus([tmp_path])
    built = profile.build_profile(model.fit_recommendations(ours), ours.meta(), GENERATED)
    jax_built = jax_profile.build_profile(jax_model.fit_recommendations(theirs), theirs.meta(),
                                          GENERATED)
    assert built == jax_built
    assert profile.validate_profile(built) == jax_profile.validate_profile(jax_built) == []
    drifted = _minimal_profile(epoch_chunk=9999, renamed_knob=1, max_attempts=3)
    assert profile.validate_profile(drifted) == jax_profile.validate_profile(drifted)
    assert len(profile.validate_profile(drifted)) == 3
    # what only the port refuses: a knob it lacks
    unported = _minimal_profile(donate=True, batch_wait_ms=5.0)
    assert jax_profile.validate_profile(unported) == []
    assert profile.validate_profile(unported) == [
        f"recommendation for knob 'donate' the port lacks ({knobs.get_knob('donate').unported})"]
    assert profile.recommended_values(drifted) == jax_profile.recommended_values(drifted)
    mixed = _minimal_profile(epoch_chunk=8, batch_wait_ms=-4.0, ghost=1, batch_queue_limit=32)
    for subsystems in (None, ("server",)):
        assert profile.recommended_values(mixed, subsystems) == \
            jax_profile.recommended_values(mixed, subsystems)


@pytest.mark.parametrize("change", ["future", "unversioned", "torn", "not-an-object"])
def test_unloadable_profiles_are_refused_as_jax_refuses_them(tmp_path, change):
    payload = _minimal_profile(epoch_chunk=8)
    if change == "future":
        payload["profile_version"] = profile.PROFILE_VERSION + 1
    elif change == "unversioned":
        del payload["profile_version"]
    path = tmp_path / profile.TUNING_PROFILE_FILENAME
    _write(path, {"torn": '{"profile_version": 1,', "not-an-object": "[1, 2]"}.get(
        change, payload))
    with pytest.raises(profile.TuningProfileError) as ours:
        profile.load_profile(path)
    with pytest.raises(jax_profile.TuningProfileError) as theirs:
        jax_profile.load_profile(path)
    assert str(ours.value) == str(theirs.value)
    assert profile.load_collection_profile(tmp_path) is None
    assert jax_profile.load_collection_profile(tmp_path) is None


def test_profile_discovery_is_jaxs(tmp_path, monkeypatch):
    target = _write(tmp_path / "p.json", _minimal_profile())
    for env, directory in ((str(target), None), ("off", tmp_path), (None, tmp_path)):
        if env is None:
            monkeypatch.delenv(profile.PROFILE_ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(profile.PROFILE_ENV_VAR, env)
        assert profile.resolve_profile_path(directory) == \
            jax_profile.resolve_profile_path(directory)
    _write(tmp_path / profile.TUNING_PROFILE_FILENAME, _minimal_profile())
    assert profile.resolve_profile_path(tmp_path) == jax_profile.resolve_profile_path(tmp_path)
    assert profile.resolve_profile_path(tmp_path) is not None


# -- tune plan and fit -------------------------------------------------------------


def _run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = tune_cli.main(argv)
    return code, out.getvalue()


@pytest.mark.parametrize("label", ["recorded", "current", "empty", "unported-knob-sweep"])
def test_tune_plan_is_the_jax_commands(tmp_path, label):
    for relative, payload in dict(_corpora())[label].items():
        _write(tmp_path / relative, payload)
    code, out = _run_port(["plan", "--as-json", str(tmp_path)])
    result = CliRunner().invoke(jax_gordo, ["tune", "plan", "--as-json", str(tmp_path)])
    assert code == result.exit_code == 0
    ours, theirs = json.loads(out), json.loads(result.output)
    assert ours["corpus"] == theirs["corpus"]
    want = {n: r for n, r in theirs["recommendations"].items() if n not in UNPORTED}
    assert json.dumps(ours["recommendations"], sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    if label != "unported-knob-sweep":
        code, text = _run_port(["plan", str(tmp_path)])
        assert text == CliRunner().invoke(jax_gordo, ["tune", "plan", str(tmp_path)]).output


def test_tune_plan_check_exits_as_the_jax_command(tmp_path):
    good = tmp_path / "good"
    _write(good / profile.TUNING_PROFILE_FILENAME, _minimal_profile(epoch_chunk=8))
    bad = tmp_path / "bad"
    future = _minimal_profile(epoch_chunk=8)
    future["profile_version"] = profile.PROFILE_VERSION + 7
    _write(bad / profile.TUNING_PROFILE_FILENAME, future)
    _write(bad / "sub" / profile.TUNING_PROFILE_FILENAME, _minimal_profile(removed_knob=3))
    empty = tmp_path / "empty"
    empty.mkdir()
    for root, expected in ((good, 0), (bad, 2), (empty, 0)):
        code, out = _run_port(["plan", "--check", str(root)])
        result = CliRunner().invoke(jax_gordo, ["tune", "plan", "--check", str(root)])
        assert code == result.exit_code == expected
        assert out == result.output
    unported = tmp_path / "unported"
    _write(unported / profile.TUNING_PROFILE_FILENAME, _minimal_profile(donate=True))
    code, out = _run_port(["plan", "--check", str(unported)])
    assert code == 1 and "FAIL: recommendation for knob 'donate' the port lacks" in out
    with pytest.raises(SystemExit) as usage:
        tune_cli.main(["plan"])
    assert usage.value.code == 2 == CliRunner().invoke(jax_gordo, ["tune", "plan"]).exit_code


def test_tune_fit_writes_the_jax_profile(tmp_path):
    corpus_dir = tmp_path / "corpus"
    for relative, payload in dict(_corpora())["recorded"].items():
        _write(corpus_dir / relative, payload)
    (tmp_path / "port").mkdir()
    code, out = _run_port(["fit", str(corpus_dir), "--out", str(tmp_path / "port")])
    assert code == 0 and "Profile written" in out
    result = CliRunner().invoke(jax_gordo, ["tune", "fit", str(corpus_dir)])
    assert result.exit_code == 0
    ours = json.loads((tmp_path / "port" / profile.TUNING_PROFILE_FILENAME).read_text())
    theirs = json.loads((corpus_dir / profile.TUNING_PROFILE_FILENAME).read_text())
    assert ours.pop("generated") and theirs.pop("generated")
    assert ours == theirs
    assert ours["recommendations"]["epoch_chunk"]["value"] == 2
    assert ours["recommendations"]["batch_wait_ms"]["value"] == 5.0


# -- precedence: build-fleet ----------------------------------------------------------

TUNE_MACHINE = {
    "name": "tune-machine", "project_name": "tune-project",
    "dataset": {"type": "RandomDataset", "tags": ["tag-0", "tag-1", "tag-2"],
                "target_tag_list": ["tag-0", "tag-1", "tag-2"],
                "train_start_date": "2019-01-01T00:00:00+00:00",
                "train_end_date": "2019-01-02T00:00:00+00:00", "asset": "gra"},
    "model": {"gordo_tpu.models.AutoEncoder": {"kind": "feedforward_hourglass", "epochs": 2}},
}


def _machines(n=2):
    return json.dumps([dict(copy.deepcopy(TUNE_MACHINE), name=f"tune-m-{i}") for i in range(n)])


def _applied(event_log):
    if not Path(event_log).exists():
        return []
    return [e for e in read_events(str(event_log)) if e["event"] == "tuning_profile_loaded"]


def _gauge_knobs():
    snap = registry.get_registry().snapshot().get("gordo_tuning_profile_applied")
    return {s["labels"]["knob"] for s in snap["series"] if s["value"] == 1.0} if snap else set()


@pytest.mark.parametrize("source, expected", [
    ("profile", 2), ("flag", 1), ("env", 3), ("default", 1)])
def test_build_fleet_precedence(tmp_path, monkeypatch, source, expected):
    out_dir = tmp_path / "fleet-out"
    if source != "default":
        _write(out_dir / profile.TUNING_PROFILE_FILENAME,
               _minimal_profile(epoch_chunk=2, precision="float32"))
    event_log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(event_log))
    argv = ["build-fleet", _machines(), str(out_dir), "--device", "cpu"]
    if source == "flag":
        argv += ["--epoch-chunk", "1"]
    if source == "env":
        monkeypatch.setenv("GORDO_EPOCH_CHUNK", "3")
    assert cli.main(argv) == 0
    report = json.loads((out_dir / "telemetry_report.json").read_text())
    assert report["buckets"][0]["fit"]["epoch_chunk"] == expected
    events = _applied(event_log)
    if source == "default":
        assert events == [] and _gauge_knobs() == set()
    else:
        (event,) = events
        want = {"precision": "float32"}
        if source == "profile":
            want["epoch_chunk"] = 2
        assert event["applied"] == want and event["subsystem"] == "builder"
        assert _gauge_knobs() == set(want)


def test_build_fleet_without_a_profile_reads_nothing(tmp_path, monkeypatch):
    def must_not_parse(path):
        raise AssertionError(f"parsed {path}")

    monkeypatch.setattr(profile, "load_profile", must_not_parse)
    event_log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(event_log))
    assert cli.main(["build-fleet", _machines(1), str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert _applied(event_log) == [] and _gauge_knobs() == set()


def test_a_ledger_worker_gets_every_tuned_option_and_applies_nothing(tmp_path, monkeypatch):
    """The orchestrator resolves once; its workers' flags leave nothing
    to a profile, so a worker emits no event."""
    out_dir = tmp_path / "out"
    _write(out_dir / profile.TUNING_PROFILE_FILENAME,
           _minimal_profile(epoch_chunk=4, lease_ttl=5.0, build_workers=2))
    event_log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(event_log))
    args = cli._parser().parse_args(["build-fleet", _machines(1), str(out_dir)])
    applied = profile.resolve_tuned_options(vars(args), str(out_dir), cli.FLEET_TUNED_OPTIONS,
                                            "builder")
    assert applied == {"epoch_chunk": 4, "lease_ttl": 5.0, "build_workers": "2"}
    args.n_workers, args.device = 2, "cpu"
    worker = cli._parser().parse_args(["build-fleet", *cli._worker_args(args, 2)])
    assert profile.resolve_tuned_options(vars(worker), str(out_dir), cli.FLEET_TUNED_OPTIONS,
                                         "builder") == {}
    assert (worker.epoch_chunk, worker.lease_ttl, worker.workers) == (4, 5.0, "2")
    assert len(_applied(event_log)) == 1


def test_build_fleet_refuses_a_profile_with_a_knob_the_port_lacks(tmp_path, capsys):
    out_dir = tmp_path / "out"
    _write(out_dir / profile.TUNING_PROFILE_FILENAME,
           _minimal_profile(epoch_chunk=2, aot_row_buckets="64,128"))
    with pytest.raises(SystemExit) as usage:
        cli.main(["build-fleet", _machines(1), str(out_dir), "--device", "cpu"])
    assert usage.value.code == 2
    err = capsys.readouterr().err
    assert "aot_row_buckets" in err and "programs/ stays out" in err
    assert not (out_dir / "telemetry_report.json").exists()


# -- precedence: the server -----------------------------------------------------------


def _settings(app):
    return (app.catalog.batch_wait_s * 1000.0, app.catalog.batch_queue_limit,
            app.catalog.scorer_cache_size)


def test_the_server_resolves_its_knobs_as_the_jax_server(tmp_path, monkeypatch):
    from gordo_tpu.server.app import build_app as jax_build_app

    collection = tmp_path / "collection"
    _write(collection / profile.TUNING_PROFILE_FILENAME,
           _minimal_profile(batch_wait_ms=7.5, batch_queue_limit=32, epoch_chunk=4))
    event_log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(event_log))
    monkeypatch.setenv("MODEL_COLLECTION_DIR", str(collection))

    def jax_settings(config=None):
        app = jax_build_app(config)
        return (app.config["BATCH_WAIT_MS"], app.config["BATCH_QUEUE_LIMIT"],
                app.config["SCORER_CACHE_SIZE"])

    app = build_app(str(collection), device="cpu")
    assert _settings(app) == jax_settings() == (7.5, 32, 16)
    assert app.tuning_applied == {"batch_wait_ms": 7.5, "batch_queue_limit": 32}
    ours = [e for e in _applied(event_log) if e["pid"]]
    assert [(e["subsystem"], e["applied"]) for e in ours] == \
        [("server", {"batch_queue_limit": 32, "batch_wait_ms": 7.5})] * 2  # ours, then JAX's
    assert _gauge_knobs() == {"batch_wait_ms", "batch_queue_limit"}
    monkeypatch.setenv("GORDO_BATCH_WAIT_MS", "3")
    assert _settings(build_app(str(collection), device="cpu")) == jax_settings() == (3.0, 32, 16)
    monkeypatch.delenv("GORDO_BATCH_WAIT_MS")
    assert _settings(build_app(str(collection), device="cpu", batch_wait_ms=11.0)) == \
        jax_settings({"BATCH_WAIT_MS": 11.0}) == (11.0, 32, 16)
    monkeypatch.setenv(profile.PROFILE_ENV_VAR, "off")
    assert _settings(build_app(str(collection), device="cpu")) == jax_settings() == \
        (0.0, 64, 16)


def test_the_server_without_a_profile_reads_nothing(tmp_path, monkeypatch):
    def must_not_parse(path):
        raise AssertionError(f"parsed {path}")

    monkeypatch.setattr(profile, "load_profile", must_not_parse)
    event_log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(event_log))
    app = build_app(str(tmp_path / "absent"), device="cpu")
    assert _settings(app) == (0.0, 64, 16) and app.tuning_applied == {}
    assert _applied(event_log) == [] and _gauge_knobs() == set()


def test_the_server_refuses_a_profile_with_a_knob_the_port_lacks(tmp_path):
    _write(tmp_path / profile.TUNING_PROFILE_FILENAME,
           _minimal_profile(batch_wait_ms=5.0, donate=True))
    with pytest.raises(profile.UnportedKnobError, match="donate"):
        build_app(str(tmp_path), device="cpu")
    # every tuned setting given: the profile is never read
    app = build_app(str(tmp_path), device="cpu", batch_wait_ms=0, batch_queue_limit=64,
                    scorer_cache_size=16)
    assert app.tuning_applied == {}


# -- calibration -------------------------------------------------------------------

#: the keys of the JAX serving sweep's arms (``tuning/calibrate.py``'s
#: ``batch_wait_calibration``), besides p50/p99 and the two histograms
BATCH_ARM_KEYS = {"batch_wait_ms", "queue_limit", "requests", "errors", "sheds", "partials",
                  "achieved_rps", "p50_ms", "p99_ms", "gordo_serve_batch_queue_wait_seconds",
                  "gordo_serve_batch_requests"}


def test_tune_calibrate_writes_the_jax_corpus_on_the_cpu(tmp_path, monkeypatch):
    from gordo_tpu.tuning.calibrate import epoch_chunk_calibration as jax_sweep

    monkeypatch.setenv("MODEL_COLLECTION_DIR", "/caller/collection")
    out_dir = tmp_path / "cal"
    code, out = _run_port(["calibrate", str(out_dir), "--epoch-chunks", "2,1", "--machines", "2",
                           "--rows", "32", "--epochs", "3", "--batch-size", "16",
                           "--batch-wait-sweep", "0,2", "--duration", "1", "--rps", "8",
                           "--device", "cpu"])
    assert code == 0 and "Profile written" in out
    payload = json.loads((out_dir / calibrate.CALIBRATION_FILENAME).read_text())
    assert payload["bench_schema_version"] == calibrate.BENCH_SCHEMA_VERSION
    assert payload["kind"] == "tune_calibration"
    rows = payload["epoch_chunk_sweep"]
    want = jax_sweep([1, 2], n_machines=2, n_rows=32, n_features=4, epochs=3, batch_size=16)
    assert [set(r) for r in rows] == [set(r) for r in want]
    assert [r["epoch_chunk"] for r in rows] == [1, 2]
    assert all(r["losses_bitequal_vs_smallest_chunk"] for r in rows)
    arms = payload["batch_wait_sweep"]
    assert [a["batch_wait_ms"] for a in arms] == [0.0, 2.0]
    assert all(set(a) <= BATCH_ARM_KEYS and a["requests"] > 0 and a["errors"] == 0
               for a in arms)
    assert "gordo_serve_batch_queue_wait_seconds" in arms[1]
    import os

    assert os.environ["MODEL_COLLECTION_DIR"] == "/caller/collection"
    fitted = json.loads((out_dir / profile.TUNING_PROFILE_FILENAME).read_text())
    assert profile.validate_profile(fitted) == []
    assert set(fitted["recommendations"]) <= {"epoch_chunk", "batch_wait_ms"}
