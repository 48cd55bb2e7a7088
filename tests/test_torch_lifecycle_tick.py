"""
Whole lifecycle ticks of the port (``gordo_tpu_torch.lifecycle.manager``
and ``python -m gordo_tpu_torch.cli lifecycle``) against the JAX
package's, each on its own copy of the converted ``lc-m-*`` fixture
(``tests/torch_lifecycle_helpers``), with the refits taking JAX's
shuffle draws.

The fixture's clean machines drift under the default thresholds (ratio
1.3649, exceedance 0.6389 against 1.0 and 0.5: the reference's own
unsteadiness, ROADMAP.md queue 3 item 2), so a test that asserts a
tick's decisions passes explicit thresholds: from a dry tick of each
clean copy, set above both packages' clean statistics, and checked to
sit below the shifted machines' (:func:`thresholds`).
"""

import hashlib
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from werkzeug.test import Client

from gordo_tpu import serializer as jax_serializer
from gordo_tpu.builder.fleet_build import _find_jax_estimator
from gordo_tpu.cli.cli import gordo as jax_cli
from gordo_tpu.lifecycle import LifecycleManager as JaxLifecycleManager
from gordo_tpu.lifecycle import TickResult as JaxTickResult
from gordo_tpu.lifecycle import TornPromotion as JaxTornPromotion
from gordo_tpu.robustness import faults as jax_faults
from gordo_tpu_torch import convert, serializer
from gordo_tpu_torch.builder.fleet_build import _find_torch_estimator
from gordo_tpu_torch.cli.cli import main as port_cli
from gordo_tpu_torch.lifecycle import LifecycleManager, TornPromotion, read_promotion_report
from gordo_tpu_torch.lifecycle.refit import estimator_params
from gordo_tpu_torch.observability import read_events
from gordo_tpu_torch.parallel.fleet import FleetTrainer
from gordo_tpu_torch.robustness import faults
from gordo_tpu_torch.server.app import build_app
from tests.test_lifecycle import BASE_REVISION, NAMES
from tests.torch_lifecycle_helpers import (
    NEVER,
    PROJECT,
    assert_close_tree,
    build_pair,
    copy_pair,
    jax_manager,
    jax_shuffle_noise,
    port_manager,
    revisions,
)

torch.set_num_threads(1)
SHIFTED = ["lc-m-1", "lc-m-2", "lc-m-3"]
E2E_SPEC = ("drift:shift:lc-m-1;drift:shift:lc-m-2;drift:shift:lc-m-3;"
            "refit:degrade:lc-m-2;refit:nan:lc-m-3@epoch:0")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (faults.FAULT_INJECT_ENV_VAR, faults.FAULT_INJECT_FILE_ENV_VAR,
                "GORDO_TPU_EVENT_LOG", "MODEL_COLLECTION_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(FleetTrainer, "_shuffle_noise", jax_shuffle_noise)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _set_faults(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULT_INJECT_ENV_VAR, spec)
    faults.reset()
    jax_faults.reset()


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return build_pair(tmp_path_factory.mktemp("lifecycle-tick"))


@pytest.fixture(scope="module")
def thresholds(template, tmp_path_factory):
    """Explicit drift thresholds for this fixture: a dry tick of each
    clean copy measures every machine's statistics (nothing drifts under
    ``NEVER``), and the thresholds sit above the larger clean ratio and
    exceedance of the two packages."""
    jax_models, port_models = copy_pair(template, tmp_path_factory.mktemp("clean"))
    clean = {}
    for label, result in (("jax", jax_manager(jax_models, promote=False, **NEVER).tick()),
                          ("port", port_manager(port_models, promote=False, **NEVER).tick())):
        assert result.drifted == [] and result.monitored == NAMES
        clean[label] = {n: result.report["decisions"][n]["drift"] for n in NAMES}
    for name in NAMES:
        assert_close_tree(clean["port"][name], clean["jax"][name], RTOL)
    ratio = max(d["ratio"] for stats in clean.values() for d in stats.values())
    exceedance = max(d["exceedance"] for stats in clean.values() for d in stats.values())
    return {"ratio_threshold": 2.0 * ratio, "exceedance_threshold": (1.0 + exceedance) / 2,
            "clean_ratio": ratio, "clean_exceedance": exceedance}


def _config(thresholds, **overrides):
    return dict(ratio_threshold=thresholds["ratio_threshold"],
                exceedance_threshold=thresholds["exceedance_threshold"], **overrides)


@pytest.fixture
def pair(template, tmp_path):
    return copy_pair(template, tmp_path)


def _both_ticks(pair, monkeypatch, tmp_path, spec, **config):
    """The same tick on each package's copy under ``spec``: (JAX result,
    port result), each package's events in its own log."""
    jax_models, port_models = pair
    results = []
    for label, manager in (("jax", jax_manager), ("port", port_manager)):
        _set_faults(monkeypatch, spec)
        monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(tmp_path / f"{label}-events.jsonl"))
        models = jax_models if label == "jax" else port_models
        results.append(manager(models, **config).tick())
    monkeypatch.delenv("GORDO_TPU_EVENT_LOG")
    return results


def _assert_same_decisions(got, want):
    for key in ("base_revision", "n_machines", "monitored", "drifted", "promoted", "rejected",
                "quarantined", "noop"):
        assert got.to_dict()[key] == want.to_dict()[key], key
    for name in NAMES:
        g, w = got.report["decisions"][name], want.report["decisions"][name]
        assert (g["decision"], g["reason"]) == (w["decision"], w["reason"]), name
    assert got.report["counts"] == want.report["counts"]


def _tree_digest(directory):
    digest = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(directory)):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            digest.update(path[len(str(directory)):].encode())
            with open(path, "rb") as fh:
                digest.update(fh.read())
    return digest.hexdigest()


def _post(client, route, body):
    reply = client.post(f"/gordo/v0/{PROJECT}/{route}", json=body)
    return reply.status_code, json.loads(reply.get_data())


def test_e2e_drift_refit_shadow_promote_matches_jax(pair, thresholds, monkeypatch, tmp_path):
    """JAX's acceptance scenario on both packages: three of four machines
    drift; the refit warm-starts exactly those three; the degraded
    candidate is rejected, the poisoned one quarantined, the other
    promoted; the decisions, reasons and both reports agree (statistics
    and scores within 1e-5, the promoted weights within 1e-4); retained
    artifacts are hard links, ``latest`` flips, the base revision is
    untouched, and the port's server answers from the new revision."""
    jax_models, port_models = pair
    base_digest = _tree_digest(port_models / BASE_REVISION)
    jax_result, result = _both_ticks(pair, monkeypatch, tmp_path, E2E_SPEC,
                                     **_config(thresholds))
    assert result.drifted == SHIFTED
    assert (result.promoted, result.rejected, result.quarantined) == (
        ["lc-m-1"], ["lc-m-2"], ["lc-m-3"])
    _assert_same_decisions(result, jax_result)
    # the thresholds' margins: clean machines under both, shifted over one
    for outcome in (result, jax_result):
        decisions = outcome.report["decisions"]
        clean = decisions["lc-m-0"]["drift"]
        assert clean["ratio"] < thresholds["ratio_threshold"]
        assert clean["exceedance"] < thresholds["exceedance_threshold"]
        for name in SHIFTED:
            assert decisions[name]["drift"]["ratio"] > thresholds["ratio_threshold"]

    # the reports, less revision names and with statistics within 1e-5
    new_rev, jax_rev = port_models / result.revision, jax_models / jax_result.revision
    assert_close_tree(read_promotion_report(new_rev), read_promotion_report(jax_rev), RTOL)
    build_report = json.loads((new_rev / "build_report.json").read_text())
    assert_close_tree(build_report, json.loads((jax_rev / "build_report.json").read_text()),
                      RTOL)
    assert [q["machine"] for q in build_report["quarantined"]] == ["lc-m-3"]
    decisions = read_promotion_report(new_rev)["decisions"]
    assert decisions["lc-m-3"]["quarantine"] == {"machine": "lc-m-3", "epoch": 0}
    assert decisions["lc-m-2"]["shadow"]["candidate_score"] > (
        decisions["lc-m-2"]["shadow"]["live_score"])
    assert decisions["lc-m-1"]["shadow"]["promote"] is True

    # blue/green: a sibling revision, latest flipped, the base untouched
    assert revisions(port_models) == sorted([BASE_REVISION, result.revision])
    assert os.readlink(port_models / "latest") == result.revision
    assert _tree_digest(port_models / BASE_REVISION) == base_digest
    for name in ("lc-m-0", "lc-m-2", "lc-m-3"):
        for fname in serializer.ARTIFACT_FILES:
            assert os.path.samefile(port_models / BASE_REVISION / name / fname,
                                    new_rev / name / fname)
    # the promoted machine: new weights, JAX's within 1e-4
    promoted = estimator_params(_find_torch_estimator(serializer.load(new_rev / "lc-m-1", "cpu")))
    old = estimator_params(_find_torch_estimator(
        serializer.load(port_models / BASE_REVISION / "lc-m-1", "cpu")))
    assert any(not np.array_equal(promoted[k], old[k]) for k in promoted)
    want = convert.state_dict_from_flax(
        _find_jax_estimator(jax_serializer.load(jax_rev / "lc-m-1")).params_, "AutoEncoder")
    for key in want:
        np.testing.assert_allclose(promoted[key], want[key], rtol=0, atol=1e-4)

    # the event log tells the same story as JAX's
    events = read_events(str(tmp_path / "port-events.jsonl"))
    kinds = {e["event"] for e in events}
    assert {"machine_drifted", "refit_rejected", "revision_promoted",
            "lifecycle_tick_finished", "fault_injected"} <= kinds
    # every kind of event the port logs, its refit build's among them, JAX logs too
    assert kinds <= {e["event"] for e in read_events(str(tmp_path / "jax-events.jsonl"))}
    assert {e["machine"] for e in events if e["event"] == "machine_drifted"} == set(SHIFTED)
    promoted_event = [e for e in events if e["event"] == "revision_promoted"][-1]
    assert (promoted_event["revision"], promoted_event["base_revision"]) == (
        result.revision, BASE_REVISION)
    snapshot = json.loads((port_models / ".lifecycle" / "last_tick.json").read_text())
    jax_snapshot = json.loads((jax_models / ".lifecycle" / "last_tick.json").read_text())
    assert set(snapshot) == set(jax_snapshot) and set(snapshot["status"]) == set(
        jax_snapshot["status"])
    assert snapshot["role"] == "lifecycle"
    # the metrics block is the process registry, the tick's series in it as in JAX's
    lifecycle_series = {"gordo_lifecycle_tick_seconds", "gordo_lifecycle_machines_total",
                        "gordo_lifecycle_drifted_machines"}
    assert lifecycle_series <= set(snapshot["metrics"]) and lifecycle_series <= set(
        jax_snapshot["metrics"])
    for name in lifecycle_series:
        assert (snapshot["metrics"][name]["labelnames"]
                == jax_snapshot["metrics"][name]["labelnames"]), name

    # serving rolls to the new revision through latest
    client = Client(build_app(str(port_models / "latest"), device="cpu"))
    body = json.loads(client.get(f"/gordo/v0/{PROJECT}/models").get_data())
    assert body["revision"] == result.revision
    assert set(body["models"]) == {"lc-m-0", "lc-m-1", "lc-m-2"}
    assert body["unavailable"]["lc-m-3"]["reason"] == "quarantined"
    assert _post(client, "lc-m-3/anomaly/prediction", {})[0] == 409
    X = np.random.default_rng(0).random((8, 3)).tolist()
    assert _post(client, "lc-m-1/prediction", {"X": X})[0] == 200


def test_torn_promotion_tick_leaves_latest_untouched(pair, thresholds, monkeypatch, tmp_path):
    """promote:torn at the tick: both packages raise, ``latest`` and the
    published revisions stay as they were with the staging directory
    left; the retry (the tear spent) promotes as JAX's does."""
    jax_models, port_models = pair
    spec = "drift:shift:lc-m-1;promote:torn@attempts:1"
    _set_faults(monkeypatch, spec)
    with pytest.raises(JaxTornPromotion):
        jax_manager(jax_models, **_config(thresholds)).tick()
    with pytest.raises(TornPromotion) as err:
        port_manager(port_models, **_config(thresholds)).tick()
    assert os.readlink(port_models / "latest") == BASE_REVISION
    assert revisions(port_models) == [BASE_REVISION]
    staging = [n for n in os.listdir(port_models) if n.startswith(".promote-")]
    assert len(staging) == 1 and err.value.staging_dir.endswith(staging[0])
    # the retry: fresh managers, the same state directories
    jax_result = jax_manager(jax_models, **_config(thresholds)).tick()
    result = port_manager(port_models, **_config(thresholds)).tick()
    _assert_same_decisions(result, jax_result)
    assert result.promoted == ["lc-m-1"]
    assert os.readlink(port_models / "latest") == result.revision
    assert result.report["decisions"]["lc-m-1"]["drift"]["n_observations"] == 2


def test_refit_fetch_failure_retains_machine(pair, thresholds, monkeypatch, tmp_path):
    """A drifted machine whose refit fetch dies is retained (refit_failed)
    and is no casualty of the new revision, as in JAX."""
    jax_result, result = _both_ticks(
        pair, monkeypatch, tmp_path, "drift:shift:lc-m-1;drift:shift:lc-m-2;fetch:raise:lc-m-2",
        **_config(thresholds, fetch_retries=0))
    _assert_same_decisions(result, jax_result)
    assert result.drifted == ["lc-m-1", "lc-m-2"] and result.promoted == ["lc-m-1"]
    record = result.report["decisions"]["lc-m-2"]
    assert (record["decision"], record["reason"]) == ("retained", "refit_failed")
    assert record["error"] == jax_result.report["decisions"]["lc-m-2"]["error"]
    assert "InjectedFault" in record["error"]
    build_report = json.loads((pair[1] / result.revision / "build_report.json").read_text())
    assert build_report["quarantined"] == [] and build_report["failed"] == []


def test_drift_scan_failure_isolated_to_machine(pair, thresholds, monkeypatch, tmp_path):
    """One machine's window fetch dying is recorded on it; the others are
    scored, the shifted one still refits, and the observations made are
    saved: on both packages alike."""
    for manager_cls in (JaxLifecycleManager, LifecycleManager):
        real = manager_cls._fetch_window

        def flaky(meta, start, end, real=real):
            if meta["name"] == "lc-m-2":
                raise IOError("sensor backend down")
            return real(meta, start, end)

        monkeypatch.setattr(manager_cls, "_fetch_window", staticmethod(flaky))
    jax_result, result = _both_ticks(pair, monkeypatch, tmp_path, "drift:shift:lc-m-1",
                                     **_config(thresholds, promote=False))
    _assert_same_decisions(result, jax_result)
    assert result.monitored == ["lc-m-0", "lc-m-1", "lc-m-3"]
    assert result.drifted == ["lc-m-1"] and result.promoted == ["lc-m-1"]
    record = result.report["decisions"]["lc-m-2"]
    assert (record["reason"], record["error"]) == ("drift_scan_failed", "sensor backend down")
    for models in pair:
        saved = json.loads((models / ".lifecycle" / "drift_state.json").read_text())
        assert sorted(saved["machines"]) == ["lc-m-0", "lc-m-1", "lc-m-3"]


def test_tick_no_promote_is_dry_run(pair, thresholds, monkeypatch, tmp_path):
    jax_result, result = _both_ticks(pair, monkeypatch, tmp_path, "drift:shift:lc-m-1",
                                     **_config(thresholds, promote=False))
    _assert_same_decisions(result, jax_result)
    assert result.drifted == ["lc-m-1"] and result.revision is None and result.noop
    assert revisions(pair[1]) == [BASE_REVISION]
    assert_close_tree(result.report, jax_result.report, RTOL)
    assert "shadow" in result.report["decisions"]["lc-m-1"]


def test_tick_without_drift_is_noop(pair, thresholds, monkeypatch, tmp_path):
    jax_result, result = _both_ticks(pair, monkeypatch, tmp_path, "", **_config(thresholds))
    _assert_same_decisions(result, jax_result)
    assert result.noop and result.monitored == NAMES and result.drifted == []
    assert os.readlink(pair[1] / "latest") == BASE_REVISION
    assert (pair[1] / ".lifecycle" / "drift_state.json").is_file()
    finishes = [e for e in read_events(str(tmp_path / "port-events.jsonl"))
                if e["event"] == "lifecycle_tick_finished"]
    assert finishes[-1]["n_drifted"] == 0 and finishes[-1]["revision"] is None


def test_base_casualties_carry_forward(pair, thresholds, monkeypatch, tmp_path):
    """A machine the base revision records as a casualty is not scored,
    is decided ``carried``, and stays a casualty of the promoted
    revision, as in JAX."""
    for models in pair:
        path = models / BASE_REVISION / "build_report.json"
        report = json.loads(path.read_text())
        report["quarantined"] = [{"machine": "lc-m-0", "epoch": 1}]
        report["failed"] = [{"machine": "lc-m-2", "phase": "fetch", "error": "x"}]
        path.write_text(json.dumps(report))
    jax_result, result = _both_ticks(pair, monkeypatch, tmp_path, "drift:shift:lc-m-1",
                                     **_config(thresholds))
    _assert_same_decisions(result, jax_result)
    assert result.n_machines == 2 and result.promoted == ["lc-m-1"]
    decisions = result.report["decisions"]
    assert decisions["lc-m-0"] == {"decision": "carried", "reason": "quarantined"}
    assert decisions["lc-m-2"] == {"decision": "carried", "reason": "fetch_failed"}
    got = json.loads((pair[1] / result.revision / "build_report.json").read_text())
    want = json.loads((pair[0] / jax_result.revision / "build_report.json").read_text())
    assert_close_tree(got, want, RTOL)
    assert [q["machine"] for q in got["quarantined"]] == ["lc-m-0"]


def _cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        code = port_cli(argv)
    return code, out.getvalue()


def _threshold_args(thresholds):
    return ["--ratio-threshold", str(thresholds["ratio_threshold"]),
            "--exceedance-threshold", str(thresholds["exceedance_threshold"])]


def test_cli_tick_and_report(pair, thresholds, monkeypatch):
    """``lifecycle tick`` prints JAX's summary keys; ``report`` renders
    the revision as JAX's command renders the same report, and exits 1
    for a revision with no promotion trail."""
    port_models = pair[1]
    _set_faults(monkeypatch, "drift:shift:lc-m-1")
    code, out = _cli(["lifecycle", "tick", "--model-collection-dir",
                      str(port_models / "latest"), "--device", "cpu",
                      *_threshold_args(thresholds)])
    assert code == 0
    summary = json.loads(out)
    jax_keys = {f for f in JaxTickResult.__dataclass_fields__} | {"noop"}
    assert set(summary) == jax_keys
    assert summary["drifted"] == summary["promoted"] == ["lc-m-1"] and summary["revision"]
    code, rendered = _cli(["lifecycle", "report", str(port_models / summary["revision"])])
    assert code == 0 and "lc-m-1" in rendered and "promoted" in rendered
    jax_rendered = CliRunner().invoke(
        jax_cli, ["lifecycle", "report", str(port_models / summary["revision"])],
        catch_exceptions=False)
    assert rendered == jax_rendered.output
    assert _cli(["lifecycle", "report", str(port_models / BASE_REVISION)])[0] == 1
    with pytest.raises(SystemExit):
        _cli(["lifecycle", "tick", "--model-collection-dir", str(port_models / "nowhere")])


def test_watch_multi_cycle_converges(pair, thresholds, monkeypatch):
    """JAX's watch test on the port: a tick promotes the shifted machine;
    two watch cycles without the fault then change nothing against the
    new revision."""
    port_models = pair[1]
    _set_faults(monkeypatch, "drift:shift:lc-m-1")
    first = port_manager(port_models, **_config(thresholds)).tick()
    assert first.promoted == ["lc-m-1"]
    monkeypatch.delenv(faults.FAULT_INJECT_ENV_VAR)
    faults.reset()
    code, out = _cli(["lifecycle", "watch", "--model-collection-dir",
                      str(port_models / "latest"), "--interval-s", "0.01", "--max-cycles", "2",
                      "--device", "cpu", *_threshold_args(thresholds)])
    assert code == 0
    lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert [line["cycle"] for line in lines] == [1, 2]
    assert all(line["noop"] for line in lines)
    assert all(line["base_revision"] == first.revision for line in lines)
    assert revisions(port_models) == sorted([BASE_REVISION, first.revision])


def test_watch_stops_when_revision_not_adopted(pair, thresholds, monkeypatch):
    """``watch --no-repoint`` publishes a revision the pointer never
    adopts: the daemon stops after that cycle, as JAX's does."""
    port_models = pair[1]
    _set_faults(monkeypatch, "drift:shift:lc-m-1")
    code, out = _cli(["lifecycle", "watch", "--model-collection-dir",
                      str(port_models / "latest"), "--no-repoint", "--interval-s", "0",
                      "--max-cycles", "5", "--device", "cpu", *_threshold_args(thresholds)])
    assert code == 0
    cycles = [json.loads(line) for line in out.splitlines()]
    assert len(cycles) == 1 and cycles[0]["revision"]
    assert len(revisions(port_models)) == 2
    assert os.readlink(port_models / "latest") == BASE_REVISION


def _observation(machine, n, ratio, exceedance, revision=BASE_REVISION):
    return json.dumps({"event": "stream_observation", "machine": machine, "n": n,
                       "ratio_mean": ratio, "exceedance": exceedance,
                       "revision": revision, "session": "s"}) + "\n"


def test_stream_log_consumption_matches_jax(pair, tmp_path):
    """The same event log gives both packages the same per-machine
    statistics and the same cursor: other revisions dropped, a torn last
    line left for the next tick, the cursor committed only when asked,
    and a log that shrank read from its start."""
    log = tmp_path / "events.jsonl"
    log.write_text(
        _observation("lc-m-0", 10, 0.5, 0.1) + _observation("lc-m-0", 30, 1.5, 0.6)
        + json.dumps({"event": "other"}) + "\n" + "not json\n"
        + _observation("lc-m-1", 5, 2.0, 1.0, revision="999")
        + _observation("lc-m-1", 0, 2.0, 1.0) + _observation("lc-m-2", 4, 0.25, 0.0)
        + _observation("lc-m-3", 7, 9.0, 1.0)[:-20])
    managers = [jax_manager(pair[0], stream_observations=str(log)),
                port_manager(pair[1], stream_observations=str(log))]

    def consume():
        out = [m._consume_stream_observations(BASE_REVISION) for m in managers]
        assert out[1] == out[0]
        cursors = [m._pending_stream_cursor for m in managers]
        assert (cursors[1] or (None, None))[1] == (cursors[0] or (None, None))[1]
        return out[1], cursors[1]

    stats, cursor = consume()
    assert sorted(stats) == ["lc-m-0", "lc-m-2"]
    assert stats["lc-m-0"] == {"n": 40, "ratio": (10 * 0.5 + 30 * 1.5) / 40,
                               "exceedance": (10 * 0.1 + 30 * 0.6) / 40}
    assert cursor[1]["offset"] == len(log.read_bytes()) - len(
        _observation("lc-m-3", 7, 9.0, 1.0)[:-20].encode())
    # uncommitted: the same bytes drain again
    assert consume()[0] == stats
    for manager in managers:
        manager._commit_stream_cursor()
    # the torn line completed: only it drains now
    with open(log, "a") as fh:
        fh.write(_observation("lc-m-3", 7, 9.0, 1.0)[-20:])
    stats, _ = consume()
    assert stats == {"lc-m-3": {"n": 7, "ratio": 9.0, "exceedance": 1.0}}
    for manager in managers:
        manager._commit_stream_cursor()
    assert consume() == ({}, None)
    # rotated (shrank): read from the start
    log.write_text(_observation("lc-m-2", 2, 1.0, 0.5))
    assert consume()[0] == {"lc-m-2": {"n": 2, "ratio": 1.0, "exceedance": 0.5}}


def test_stream_session_feeds_a_scan_free_tick(pair, thresholds, monkeypatch, tmp_path):
    """A port stream session over a monitorable machine writes
    ``stream_observation`` events; a port tick reading them assesses that
    machine from the stream (``source: stream``) with no window fetch for
    it, to the statistic a scan of the same rows gives (rtol 1e-5)."""
    port_models = pair[1]
    log = tmp_path / "serve-events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(log))
    client = Client(build_app(str(port_models / "latest"), device="cpu"))
    code, body = _post(client, "stream/open", {"machines": ["lc-m-0"]})
    assert code == 201 and body["machines"]["lc-m-0"]["monitored"] is True
    manager = port_manager(port_models, stream_observations=str(log), promote=False,
                           **_config(thresholds))
    meta = manager._load_metadata(str(port_models / BASE_REVISION), "lc-m-0")
    window = manager._machine_window(meta)
    X, _ = manager._fetch_window(meta, window["start"], window["end"])
    seq = 0
    for k in (50, 50, len(X.values) - 100):
        code, _ = _post(client, f"stream/{body['session']}/update",
                        {"updates": {"lc-m-0": {"rows": X.values[seq:seq + k].tolist(),
                                                "seq": seq}}})
        assert code == 200
        seq += k
    monkeypatch.delenv("GORDO_TPU_EVENT_LOG")
    observations = [e for e in read_events(str(log)) if e["event"] == "stream_observation"]
    assert [e["n"] for e in observations] == [50, 50, len(X.values) - 100]
    assert {(e["machine"], e["revision"]) for e in observations} == {("lc-m-0", BASE_REVISION)}
    assert all(set(e) >= {"session", "ratio_mean", "exceedance"} for e in observations)

    fetches = []
    real = LifecycleManager._fetch_window

    def counting(meta, start, end):
        fetches.append(meta["name"])
        return real(meta, start, end)

    monkeypatch.setattr(LifecycleManager, "_fetch_window", staticmethod(counting))
    result = manager.tick()
    streamed = result.report["decisions"]["lc-m-0"]
    assert streamed["source"] == "stream" and "lc-m-0" not in fetches
    assert sorted(fetches) == ["lc-m-1", "lc-m-2", "lc-m-3"]
    # lc-m-1 is the same model over the same rows: the scan's statistic
    scanned = result.report["decisions"]["lc-m-1"]["drift"]
    np.testing.assert_allclose(streamed["drift"]["ratio"], scanned["ratio"], rtol=RTOL)
    assert streamed["drift"]["exceedance"] == pytest.approx(scanned["exceedance"], rel=RTOL)
    # the cursor advanced: the next tick scans lc-m-0 again
    fetches.clear()
    manager.tick()
    assert "lc-m-0" in fetches
