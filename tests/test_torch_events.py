"""
The port's JSONL event log (``gordo_tpu_torch.observability.events``)
against the JAX package's: a record round-trips, its keys are JAX's for
the same event (less ``ts`` and the trace fields the port does not have
yet), rotation keeps one generation, and emitting never raises.
"""

import json
import os

import pytest

from gordo_tpu.observability import events as jax_events
from gordo_tpu.robustness import faults as jax_faults
from gordo_tpu_torch.observability import EventEmitter, emit_event, events, read_events
from gordo_tpu_torch.robustness import faults

#: the JAX record's trace correlation, which the port leaves out
TRACE_KEYS = {"trace_id", "span_id", "parent_span_id"}


def _comparable(record):
    return {k: v for k, v in record.items() if k not in {"ts", "unix_ms"} | TRACE_KEYS}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for var in (events.EVENT_LOG_ENV_VAR, events.EVENT_LOG_MAX_MB_ENV_VAR,
                faults.FAULT_INJECT_ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def test_off_without_a_path(tmp_path):
    assert emit_event("anything", x=1) is None
    assert EventEmitter().target_path() == ""
    assert os.listdir(tmp_path) == []


def test_record_round_trips(tmp_path, monkeypatch):
    log = tmp_path / "sub" / "events.jsonl"
    monkeypatch.setenv(events.EVENT_LOG_ENV_VAR, str(log))
    written = emit_event("stream_observation", machine="m", n=3, ratio_mean=0.5,
                         exceedance=0.25, revision="r", session="s")
    assert written is not None
    (read,) = read_events(str(log))
    assert read == written
    assert read["event"] == "stream_observation" and read["pid"] == os.getpid()
    # an explicit emitter path wins over the environment
    other = tmp_path / "other.jsonl"
    EventEmitter(str(other)).emit("x", value=object())  # default=str serializes it
    assert read_events(str(other))[0]["event"] == "x"
    assert len(read_events(str(log))) == 1


@pytest.mark.parametrize("event, fields", [
    ("machine_drifted", {"machine": "m", "revision": "r", "ewma_ratio": 1.5,
                         "ewma_exceedance": 0.75, "n_observations": 2}),
    ("lifecycle_tick_finished", {"base_revision": "r", "revision": None, "n_machines": 4,
                                 "n_monitored": 4, "n_drifted": 0, "n_promoted": 0,
                                 "n_rejected": 0, "n_quarantined": 0, "wall_time_s": 0.5}),
    ("stream_observation", {"revision": "r", "session": "s", "machine": "m", "n": 3,
                            "ratio_mean": 0.5, "exceedance": 0.0}),
])
def test_keys_match_jax(tmp_path, event, fields):
    port = EventEmitter(str(tmp_path / "port.jsonl")).emit(event, **fields)
    jax = jax_events.EventEmitter(str(tmp_path / "jax.jsonl")).emit(event, **fields)
    assert _comparable(port) == {**_comparable(jax), "pid": port["pid"]}
    assert set(port) == set(jax) - TRACE_KEYS
    assert read_events(str(tmp_path / "port.jsonl")) == [port]


def test_fault_injected_record_matches_jax(tmp_path, monkeypatch):
    spec = "drift:shift:m-1@scale:3;promote:torn"
    monkeypatch.setenv(faults.FAULT_INJECT_ENV_VAR, spec)
    monkeypatch.setenv(events.EVENT_LOG_ENV_VAR, str(tmp_path / "port.jsonl"))
    faults.drift_shift_scale("m-1")
    with pytest.raises(faults.InjectedFault):
        faults.inject_promotion_tear(2)
    monkeypatch.setenv(events.EVENT_LOG_ENV_VAR, str(tmp_path / "jax.jsonl"))
    jax_faults.drift_shift_scale("m-1")
    with pytest.raises(jax_faults.InjectedFault):
        jax_faults.inject_promotion_tear(2)
    port = read_events(str(tmp_path / "port.jsonl"))
    jax = read_events(str(tmp_path / "jax.jsonl"))
    assert [_comparable(r) for r in port] == [_comparable(r) for r in jax]


def test_rotation_keeps_one_generation(tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv(events.EVENT_LOG_ENV_VAR, str(log))
    monkeypatch.setenv(events.EVENT_LOG_MAX_MB_ENV_VAR, str(300 / (1024 * 1024)))
    for i in range(12):
        emit_event("tick", i=i, pad="x" * 40)
    rotated = read_events(str(log) + ".1")
    current = read_events(str(log))
    assert rotated and current
    # whole records only, the newest last, nothing older than one generation
    assert [r["i"] for r in rotated + current] == list(range(12 - len(rotated) - len(current), 12))
    assert os.path.getsize(log) <= 300 + 200
    assert not os.path.exists(str(log) + ".2")
    # a cap that does not parse turns rotation off, as in JAX
    monkeypatch.setenv(events.EVENT_LOG_MAX_MB_ENV_VAR, "lots")
    assert events._rotate_cap_bytes() == jax_events._rotate_cap_bytes() == 0


def test_emission_never_raises(tmp_path, monkeypatch):
    # the log path is a directory: the write fails, the caller goes on
    monkeypatch.setenv(events.EVENT_LOG_ENV_VAR, str(tmp_path))
    assert emit_event("x") is None

    class Unprintable:
        def __str__(self):
            raise RuntimeError("no")

    monkeypatch.setenv(events.EVENT_LOG_ENV_VAR, str(tmp_path / "events.jsonl"))
    assert emit_event("x", value=Unprintable()) is None
    assert not (tmp_path / "events.jsonl").exists()


def test_read_events_skips_a_torn_line(tmp_path):
    log = tmp_path / "events.jsonl"
    log.write_text(json.dumps({"event": "a"}) + "\n\n" + '{"event": "b", "torn')
    assert read_events(str(log)) == [{"event": "a"}]
    assert jax_events.read_events(str(log)) == [{"event": "a"}]
