"""
Game days in the port (``gordo_tpu_torch.scenario`` and ``gameday``)
against the JAX package's ``gordo_tpu.scenario``:

- the grammar: durations, every shipped document's ``to_dict`` and every
  JAX rejection reproduced by ``ScenarioError``;
- the catalogue: the six documents and ``examples/scenarios/*.yaml``
  (read by the port's YAML reader) equal JAX's;
- the synthetic harness: the event loop's order and counts, streams on
  the stub plane;
- the verdict composed from the same recorded evidence as JAX's runner
  composes it;
- ``gameday list|run`` (``rolling-upgrade`` marked, skipped and, named,
  refused with exit 2);
- one compressed real run on the CPU: JAX's mini region-loss (2
  replicas, 4 s) through the port's plane, its report ``ok`` with every
  stream bitwise the port's own one-shot.
"""

import json
import os
import signal
import threading

import pytest

from gordo_tpu import scenario as jax_scenario
from gordo_tpu.observability import slo as jax_slo
from gordo_tpu_torch import scenario
from gordo_tpu_torch.cli import gameday
from gordo_tpu_torch.robustness import faults
from gordo_tpu_torch.router.ring import HashRing
from gordo_tpu_torch.scenario.plane import GAMEDAY_MACHINES
from gordo_tpu_torch.scenario.runner import judge

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "scenarios")
NAMES = sorted(jax_scenario.scenario_documents())


def minimal_doc(**overrides):
    doc = {"name": "mini", "duration_s": 5,
           "slo": {"objectives": [{"signal": "unstructured_error_rate", "threshold": 0.0,
                                   "budget": 0.001}]}}
    doc.update(overrides)
    return doc


# -- the grammar -------------------------------------------------------------------

@pytest.mark.parametrize("value", [30, 2.5, "30s", "450ms", "1.5m", "2h", "7", " 3 s "])
def test_parse_duration_equals_jax(value):
    assert scenario.parse_duration(value) == jax_scenario.parse_duration(value)


@pytest.mark.parametrize("value", ["", "abc", "3 weeks", "-4s", -1, True])
def test_bad_durations_are_refused_as_in_jax(value):
    with pytest.raises(jax_scenario.ScenarioError):
        jax_scenario.parse_duration(value)
    with pytest.raises(scenario.ScenarioError):
        scenario.parse_duration(value)


@pytest.mark.parametrize("name", NAMES)
def test_every_document_parses_to_jaxs_dict(name):
    doc = scenario.scenario_documents()[name]
    assert doc == jax_scenario.scenario_documents()[name]
    assert (scenario.parse_scenario(doc, name=name).to_dict()
            == jax_scenario.parse_scenario(doc, name=name).to_dict())


BAD_DOCS = [
    (minimal_doc(surprise=1), "Unknown scenario key"),
    (minimal_doc(plane={"replica": 3}), "Unknown plane key"),
    (minimal_doc(plane={"replicas": 0}), "replicas must be >= 1"),
    (minimal_doc(workload={"stream": 4}), "Unknown workload key"),
    (minimal_doc(expect={"resumes": 1}), "Unknown expect key"),
    (minimal_doc(duration_s=0), "duration_s must be > 0"),
    (minimal_doc(timeline={"at": "1s"}), "timeline must be a list"),
    (minimal_doc(timeline=["kill"]), "must be a mapping"),
    (minimal_doc(timeline=[{"at": "1s", "action": "explode"}]), "Unknown timeline action"),
    (minimal_doc(timeline=[{"at": "1s", "action": "kill_replica"}]), r"missing \['replica'\]"),
    (minimal_doc(timeline=[{"at": "1s", "action": "kill_replica", "replica": "r0",
                            "blast_radius": "all"}]), "parameter key"),
    (minimal_doc(timeline=[{"action": "disarm_faults"}]), "needs an 'at'"),
    (minimal_doc(timeline=[{"at": "9s", "action": "disarm_faults"}]), "past the scenario"),
    (minimal_doc(timeline=[{"at": "1s", "action": "arm_faults", "spec": "strem:drop"}]),
     "unknown site"),
    (minimal_doc(slo={"objectives": [{"signal": "made_up_signal"}]}), "Bad slo block"),
    ({"name": "x", "duration_s": 5}, "needs an 'slo' block"),
    (minimal_doc(expect={"fault_sites": ["strem"]}), "unknown site"),
    ("not a mapping", "must be a mapping"),
]


@pytest.mark.parametrize("doc,match", BAD_DOCS)
def test_jax_rejections_are_reproduced(doc, match):
    with pytest.raises(jax_scenario.ScenarioError, match=match):
        jax_scenario.parse_scenario(doc)
    with pytest.raises(scenario.ScenarioError, match=match):
        scenario.parse_scenario(doc)


def test_unwired_fault_sites_are_refused_at_parse_time():
    """``program`` parses in JAX; the port refuses it before anything runs."""
    doc = minimal_doc(timeline=[{"at": "1s", "action": "arm_faults", "spec": "program:corrupt"}])
    jax_scenario.parse_scenario(doc)
    with pytest.raises(scenario.ScenarioError, match="programs/"):
        scenario.parse_scenario(doc)


def test_timeline_sorted_and_rolling_upgrade_marked():
    parsed = scenario.parse_scenario(minimal_doc(timeline=[
        {"at": "4s", "action": "disarm_faults"}, {"at": "1500ms", "action": "lifecycle_tick"}]))
    assert [e.at_s for e in parsed.timeline] == [1.5, 4.0] and parsed.unported() is None
    upgrade = scenario.get_scenario("rolling-upgrade")
    assert "programs/" in upgrade.unported() and "queue 1 item 9" in upgrade.unported()
    assert [n for n, s in scenario.builtin_scenarios().items() if s.unported()] == [
        "rolling-upgrade"]
    with pytest.raises(KeyError, match="Unknown scenario"):
        scenario.get_scenario("nope")


# -- the catalogue -----------------------------------------------------------------

def test_builtins_cover_the_fault_sites_and_their_victims_are_ring_owners():
    armed = " ".join(str(e.params.get("spec", "")) for s in scenario.builtin_scenarios().values()
                     for e in s.timeline if e.action == "arm_faults")
    for site in ("stream", "drift", "replica", "promote"):
        assert f"{site}:" in armed
    docs = scenario.scenario_documents()
    assert docs["region-loss"]["timeline"][0]["replica"] == HashRing(
        ["r0", "r1", "r2"]).owner(GAMEDAY_MACHINES[0])


@pytest.mark.parametrize("filename", sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".yaml")))
def test_example_files_are_the_builtins(filename):
    """The YAML files users copy from are what ``gameday run`` runs, read
    by the port's YAML reader as JAX reads them with PyYAML."""
    loaded = scenario.load_scenario(os.path.join(EXAMPLES, filename))
    assert loaded == scenario.builtin_scenarios()[loaded.name]
    jax_loaded = jax_scenario.load_scenario(os.path.join(EXAMPLES, filename))
    assert loaded.to_dict() == jax_loaded.to_dict()


# -- the synthetic harness ---------------------------------------------------------

def _loop_run(pkg):
    loop = pkg.EventLoop()
    fired = []
    loop.call_at(2.0, fired.append, "b")
    loop.call_at(1.0, fired.append, "a")
    loop.call_later(3.0, fired.append, "c")
    loop.call_at(1.0, fired.append, "a2")  # ties fire in arrival order
    first = loop.run_until(2.5), list(fired), loop.now
    loop.call_at(4.0, lambda: (fired.append("d"), loop.stop()))
    loop.call_at(5.0, fired.append, "e")
    second = loop.run_until(10.0), list(fired)
    third = loop.run_until(10.0), list(fired), loop.now
    return first, second, third


def test_event_loop_orders_and_counts_as_jax():
    assert _loop_run(scenario) == _loop_run(jax_scenario)
    assert _loop_run(scenario)[0] == (3, ["a", "a2", "b"], 2.5)


@pytest.mark.parametrize("n,interval,until", [(10, 0.5, 2.0), (37, 0.3, 5.0), (1, 2.0, 1.0)])
def test_synthetic_streams_on_the_stub_plane_as_jax(n, interval, until):
    def run(pkg):
        loop, plane = pkg.EventLoop(), pkg.StubPlane()
        streams = [pkg.SyntheticStream(f"s{i}", f"m-{i % 3}", interval, 4, plane)
                   for i in range(n)]
        for i, stream in enumerate(streams):
            stream.start(loop, at=(i % 7) / 10.0)
        fired = loop.run_until(until)
        peak = plane.peak_live
        for stream in streams:
            stream.close()
        return (fired, peak, plane.live, plane.updates, plane.rows, dict(plane.sessions),
                [(s.updates, s.seq, s.rows_sent, s.session) for s in streams])

    assert run(scenario) == run(jax_scenario)


def test_many_streams_need_no_thread():
    threads = threading.active_count()
    loop, plane = scenario.EventLoop(), scenario.StubPlane()
    for i in range(20_000):
        scenario.SyntheticStream(f"s{i}", "m", 60.0, 4, plane).start(loop, at=(i % 100) / 100)
    assert loop.run_until(61.0) == 40_000
    assert plane.peak_live == plane.updates == 20_000
    assert threading.active_count() == threads


# -- the verdict -------------------------------------------------------------------

def _snapshot(t, **signals):
    return {"unix_ms": int(t * 1000), "signals": signals}


EVIDENCE = [
    # (scenario, snapshots, unstructured, fired, reconnects, sheds, promotions, mismatches,
    #  checked, ok, expect failures)
    ("region-loss", [_snapshot(1, unstructured_error_rate=0.0, shed_rate=0.0)], [], {}, 2, 0, 0,
     [], 3, True, []),
    ("region-loss", [_snapshot(1, unstructured_error_rate=0.0)], [], {}, 0, 0, 0, [], 0, False,
     ["expected >= 1 stream resumes, saw 0", "bit identity broken: no stream completed"]),
    ("region-loss", [_snapshot(1, unstructured_error_rate=0.2),
                     _snapshot(2, unstructured_error_rate=0.3)],
     ["request[gd-m-0]: HTTP 500"], {}, 1, 0, 0, ["stream[0/gd-m-0]: (4, 3) vs reference (8, 3)"],
     1, False, ["bit identity broken: stream[0/gd-m-0]: (4, 3) vs reference (8, 3)"]),
    ("thundering-herd", [_snapshot(1, shed_rate=0.5)], [], {"stream": 2.0}, 0, 2, 0, [], 5, True,
     []),
    ("thundering-herd", [_snapshot(1, shed_rate=0.99)], [], {}, 0, 0, 0, [], 5, False,
     ["expected fault site 'stream' to fire; it never did",
      "expected >= 1 honored sheds, saw 0"]),
    ("slow-drip-drift", [_snapshot(1, predict_p99_ms=3000.0)], [], {"drift": 1.0}, 0, 0, 2, [], 0,
     False, ["expected 1 promotion(s), saw 2"]),
    ("torn-promotion", [], [], {"drift": 2.0, "promote": 1.0}, 0, 0, 1, [], 0, True, []),
]


@pytest.mark.parametrize("evidence", EVIDENCE)
def test_the_verdict_composes_as_jaxs_runner(evidence):
    (name, snapshots, unstructured, fired, reconnects, sheds, promotions, mismatches, checked,
     ok, failures) = evidence
    verdict = judge(scenario.get_scenario(name), snapshots, unstructured, fired, reconnects,
                    sheds, promotions, mismatches, checked)
    want_slo = jax_slo.evaluate(jax_scenario.get_scenario(name).slo, snapshots)
    assert verdict["slo"].to_dict() == want_slo.to_dict()
    assert verdict["expect_failures"] == failures
    assert verdict["ok"] is (ok and want_slo.ok)


# -- the command -------------------------------------------------------------------

def test_gameday_list_marks_rolling_upgrade(capsys):
    assert gameday.main(["list"]) == 0
    out = capsys.readouterr().out
    for name in NAMES:
        assert name in out
    assert "timeline:" in out and "slo:" in out
    assert out.count("not ported:") == 1 and "programs/" in out
    assert gameday.main(["list", "--as-json"]) == 0
    assert json.loads(capsys.readouterr().out) == jax_scenario.scenario_documents()


@pytest.mark.parametrize("argv,message", [
    (["run", "rolling-upgrade"], "programs/"),
    (["run", "--scenario-file", os.path.join(EXAMPLES, "rolling-upgrade.yaml")], "queue 1 item 9"),
    (["run", "not-a-scenario"], "Unknown scenario"),
])
def test_gameday_run_refuses_before_training(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        gameday.main(argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err


# -- one compressed real run on the CPU --------------------------------------------

@pytest.fixture
def time_limit():
    """This test's own limit: it fails rather than outlive 300 s."""
    def expire(signum, frame):
        raise TimeoutError("the compressed game day outran its 300 s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(300)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def test_run_scenario_region_loss_mini(time_limit, tmp_path, monkeypatch):
    """JAX's compressed region-loss through the port's in-process plane:
    the ring owner of a streamed machine dies and comes back; the SLO
    budget, no unstructured error, a resume, and every stream bitwise its
    own one-shot through the same plane."""
    for var in (faults.FAULT_INJECT_ENV_VAR, faults.FAULT_INJECT_FILE_ENV_VAR,
                "GORDO_BATCH_WAIT_MS", "GORDO_TPU_EVENT_LOG"):
        monkeypatch.delenv(var, raising=False)
    collection = scenario.build_gameday_collection(tmp_path / "collection", device="cpu")
    victim = HashRing(["r0", "r1"]).owner(GAMEDAY_MACHINES[0])
    library = jax_scenario.library._BASE_OBJECTIVES  # the lenient CPU budget
    mini = scenario.parse_scenario({
        "name": "mini-region-loss",
        "plane": {"replicas": 2},
        "workload": {"streams": 2, "stream_interval_s": "300ms", "rows_per_update": 4,
                     "requests_per_s": 2},
        "duration_s": "4s",
        "timeline": [{"at": "1s", "action": "kill_replica", "replica": victim},
                     {"at": "2s", "action": "restart_replica", "replica": victim}],
        "slo": {"objectives": [*library, {"signal": "shed_rate", "threshold": 0.9,
                                          "budget": 0.5, "window_s": 300}]},
        "expect": {"min_stream_resumes": 1, "bit_identity": True},
    })
    report = scenario.run_scenario(mini, collection, str(tmp_path / "work"),
                                   poll_interval_s=0.5, device="cpu")
    assert report["ok"], (report["unstructured_errors"], report["expect_failures"],
                          report["slo"])
    assert report["streams"]["reconnects"] >= 1 and report["streams"]["broken"] == 0
    assert report["bit_identity"] == {"checked_streams": 2, "ok": True, "mismatches": []}
    assert report["n_snapshots"] >= 2 and report["slo"]["ok"]
    assert [e["action"] for e in report["timeline_executed"]] == ["kill_replica",
                                                                  "restart_replica"]
    # the run leaves no armed fault and no variable behind
    assert faults.active_registry() is None
    assert os.environ.get(faults.FAULT_INJECT_FILE_ENV_VAR) is None
