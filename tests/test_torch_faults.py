"""
The port's fault-injection registry (``gordo_tpu_torch.robustness.faults``)
against the JAX package's: the spec grammar, ``@attempts`` budgets and
``reset()``, the file channel, the seams the port wires (the router's
``replica`` and the streams' ``stream`` actions call by call), and the
loud refusal of ``program``, the one site it does not wire. With no
fault variable set, no seam touches the file system.
"""

import builtins
import json
import os

import numpy as np
import pytest

from gordo_tpu.robustness import faults as jax_faults
from gordo_tpu_torch.observability import read_events
from gordo_tpu_torch.robustness import faults

WIRED_SPECS = [
    "fetch:raise:machine-3",
    "train:nan:machine-7@epoch:2",
    "drift:shift:m-1@scale:3;refit:nan:m-2@epoch:1;refit:degrade:m-3;promote:torn@attempts:1",
    " fetch:raise ; train:nan:0@epoch:0@attempts:4 ;",
    "drift:shift",
    "",
]


@pytest.fixture(autouse=True)
def _fresh_faults(monkeypatch):
    for var in (faults.FAULT_INJECT_ENV_VAR, faults.FAULT_INJECT_FILE_ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _fields(specs):
    return [(s.site, s.mode, s.target, s.params) for s in specs]


def _set_spec(monkeypatch, spec):
    monkeypatch.setenv(faults.FAULT_INJECT_ENV_VAR, spec)
    monkeypatch.setenv(jax_faults.FAULT_INJECT_ENV_VAR, spec)
    faults.reset()
    jax_faults.reset()


@pytest.mark.parametrize("spec", WIRED_SPECS)
def test_parse_spec_matches_jax(spec):
    assert _fields(faults.parse_spec(spec)) == _fields(jax_faults.parse_spec(spec))


@pytest.mark.parametrize("spec", ["fetch", "fetch:raise:a:b", "fetch:raise@attempts", "bogus:raise"])
def test_bad_specs_raise_as_in_jax(spec):
    with pytest.raises(ValueError):
        jax_faults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)


def test_sites_partition_the_jax_grammar():
    assert faults.WIRED_SITES | faults.UNWIRED_SITES == jax_faults._KNOWN_SITES
    assert not faults.WIRED_SITES & faults.UNWIRED_SITES


#: the JAX grammar's sites that the port once refused: the build
#: plane's, the checkpoint's and the calibration's, then the serving
#: plane's; ``program`` is refused still
REFUSED_BEFORE_THEIR_SEAMS = sorted(
    faults.UNWIRED_SITES | {"ckpt", "worker", "lease", "precision", "serve", "batch", "replica",
                            "stream"})


def test_only_program_stays_unwired():
    assert faults.UNWIRED_SITES == {"program"}
    with pytest.raises(ValueError, match="programs/"):
        faults.parse_spec("program:corrupt")


@pytest.mark.parametrize("site", REFUSED_BEFORE_THEIR_SEAMS)
def test_unwired_site_fails_loudly(site, monkeypatch, tmp_path):
    """A site of the JAX grammar with no seam in the port raises at
    parse time, naming the ROADMAP item, from the parser, the env
    variable and the file channel alike: never a chaos run that injects
    nothing in silence. A site the port has since wired parses as JAX's
    does."""
    spec = f"{site}:raise:m-0"
    jax_faults.parse_spec(spec)  # the JAX grammar knows it
    if site in faults.WIRED_SITES:
        assert _fields(faults.parse_spec(spec)) == _fields(jax_faults.parse_spec(spec))
        faults.arm_file(tmp_path / "faults.spec", spec)
        assert (tmp_path / "faults.spec").read_text() == spec
        return
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 9"):
        faults.parse_spec(spec)
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 9"):
        faults.parse_spec(f"fetch:raise:m-1;{spec}")
    monkeypatch.setenv(faults.FAULT_INJECT_ENV_VAR, spec)
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 9"):
        faults.inject("fetch", "m-0")
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 9"):
        faults.arm_file(tmp_path / "faults.spec", spec)
    assert not (tmp_path / "faults.spec").exists()


def test_unset_seams_touch_no_file_system(monkeypatch):
    """JAX's hot-path rule: with neither variable set, every seam is two
    environment lookups: no stat, no open, no listing, no parse."""
    def refuse(*args, **kwargs):
        raise AssertionError("a seam touched the file system with faults off")

    monkeypatch.setattr(os, "stat", refuse)
    monkeypatch.setattr(os, "listdir", refuse)
    monkeypatch.setattr(builtins, "open", refuse)
    monkeypatch.setattr(faults, "parse_spec", refuse)
    assert faults.active_registry() is None
    assert faults.inject("fetch", "m") is None
    assert faults.train_nan_injection(["m"], 1, sites=("train", "refit")) is None
    assert faults.drift_shift_scale("m") is None
    assert faults.refit_degrade_scale("m") is None
    assert faults.inject_promotion_tear(3) is None
    assert faults.replica_fault_action("r0") is None
    assert faults.stream_fault_action(["m"]) is None


def _raises(fn, *args):
    try:
        fn(*args)
    except Exception as exc:  # noqa: BLE001 - the outcome is compared
        return type(exc).__name__
    return None


def test_attempts_budget_and_reset_match_jax(monkeypatch):
    _set_spec(monkeypatch, "fetch:raise:m-1@attempts:2")
    for pkg in (faults, jax_faults):
        outcomes = [_raises(pkg.inject, "fetch", "m-1") for _ in range(3)]
        assert outcomes == ["InjectedFault", "InjectedFault", None]
        assert _raises(pkg.inject, "fetch", "m-2") is None  # another machine
        pkg.reset()  # a fresh scenario: the budget starts again
        assert _raises(pkg.inject, "fetch", "m-1") == "InjectedFault"


def test_inject_only_fires_raise_mode(monkeypatch):
    _set_spec(monkeypatch, "fetch:stall:m-1;promote:torn")
    for pkg in (faults, jax_faults):
        assert _raises(pkg.inject, "fetch", "m-1") is None
        assert _raises(pkg.inject, "promote", None) is None


def test_file_channel_arms_and_disarms(tmp_path, monkeypatch):
    path = tmp_path / "faults.spec"
    monkeypatch.setenv(faults.FAULT_INJECT_FILE_ENV_VAR, str(path))
    monkeypatch.setenv(jax_faults.FAULT_INJECT_FILE_ENV_VAR, str(path))
    # a missing file is disarmed
    assert faults.active_registry() is None
    faults.arm_file(path, "fetch:raise:m-1@attempts:1")
    assert path.read_text() == "fetch:raise:m-1@attempts:1"
    assert _raises(faults.inject, "fetch", "m-1") == "InjectedFault"
    assert _raises(faults.inject, "fetch", "m-1") is None  # budget spent
    # re-arming the same string restarts the budget
    faults.arm_file(path, "fetch:raise:m-1@attempts:1")
    assert _raises(faults.inject, "fetch", "m-1") == "InjectedFault"
    # the JAX reader reads the port's file the same way
    jax_faults.reset()
    assert _raises(jax_faults.inject, "fetch", "m-1") == "InjectedFault"
    faults.disarm_file(path)
    assert path.read_text() == ""
    assert faults.active_registry() is None
    assert _raises(faults.inject, "fetch", "m-1") is None
    # the env grammar wins over the file
    faults.arm_file(path, "fetch:raise:m-1")
    monkeypatch.setenv(faults.FAULT_INJECT_ENV_VAR, "drift:shift:m-1")
    assert _raises(faults.inject, "fetch", "m-1") is None
    with pytest.raises(ValueError):
        faults.arm_file(path, "nowhere:raise")


@pytest.mark.parametrize("names", [["m-0", "m-1", "m-2"], None])
def test_train_nan_injection_matches_jax(monkeypatch, names):
    spec = "train:nan:m-1@epoch:2;refit:nan:m-2;train:nan:2@epoch:3;refit:nan:0@epoch:1"
    _set_spec(monkeypatch, spec)
    for sites in (("train",), ("refit",), ("train", "refit")):
        got = faults.train_nan_injection(names, 3, sites=sites)
        want = jax_faults.train_nan_injection(names, 3, sites=sites)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


def test_refit_nan_does_not_poison_ordinary_training(monkeypatch):
    _set_spec(monkeypatch, "refit:nan:m-0")
    assert faults.train_nan_injection(["m-0"], 1) is None
    got = faults.train_nan_injection(["m-0"], 1, sites=("train", "refit"))
    assert got is not None and got[0].tolist() == [True]


def test_scale_seams_match_jax(monkeypatch):
    _set_spec(monkeypatch, "drift:shift:m-1@scale:3;refit:degrade:m-2;drift:shift:m-3")
    for name in ("m-1", "m-2", "m-3", None):
        assert faults.drift_shift_scale(name) == jax_faults.drift_shift_scale(name)
        assert faults.refit_degrade_scale(name) == jax_faults.refit_degrade_scale(name)
    assert faults.drift_shift_scale("m-3") == 5.0
    assert faults.refit_degrade_scale("m-2") == 10.0
    _set_spec(monkeypatch, "drift:shift:m-1@scale:big")
    with pytest.raises(ValueError, match="@scale"):
        faults.drift_shift_scale("m-1")


def test_promotion_tear_budget_matches_jax(monkeypatch):
    _set_spec(monkeypatch, "promote:torn@attempts:2")
    for pkg in (faults, jax_faults):
        assert [_raises(pkg.inject_promotion_tear, i) for i in (1, 1, 1)] == [
            "InjectedFault", "InjectedFault", None]
    _set_spec(monkeypatch, "promote:torn:m-1")  # a targeted tear never matches
    for pkg in (faults, jax_faults):
        assert _raises(pkg.inject_promotion_tear, 1) is None


def test_firings_emit_fault_injected_events(tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(log))
    _set_spec(monkeypatch, "drift:shift:m-1@scale:2;fetch:raise:m-1@attempts:1")
    faults.drift_shift_scale("m-1")
    with pytest.raises(faults.InjectedFault):
        faults.inject("fetch", "m-1")
    faults.inject("fetch", "m-1")  # spent: no event
    records = read_events(str(log))
    assert [(r["event"], r["site"], r["fire_count"]) for r in records] == [
        ("fault_injected", "drift", 1), ("fault_injected", "fetch", 1)]
    assert records[0]["scale"] == 2.0 and records[0]["machine"] == "m-1"
    assert json.loads(log.read_text().splitlines()[1])["mode"] == "raise"


def _actions(pkg, call, args, n):
    """``n`` calls of a seam: the actions, then the spec's fire counts."""
    out = []
    for _ in range(n):
        try:
            out.append(call(pkg)(*args))
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            out.append(type(exc).__name__)
    registry = pkg.active_registry()
    return out, [spec.fires for spec in registry.specs]


@pytest.mark.parametrize("spec,args", [
    ("replica:die:r1", ("r1",)),
    ("replica:die:r1@attempts:2", ("r1",)),
    ("replica:die:r1@attempts:2", ("r0",)),
    ("replica:die", ("r0",)),
    ("replica:slow:r0@ms:40", ("r0",)),
    ("replica:slow:r0@attempts:1", ("r0",)),
    ("replica:slow:r0@ms:soon", ("r0",)),
    ("replica:flap:r1@burst:3", ("r1",)),
    ("replica:flap:r1", ("r1",)),
    ("replica:flap:r1@burst:2;replica:die:r1@attempts:1", ("r1",)),
    ("replica:slow:r0@ms:5;replica:flap:r0@burst:1", ("r0",)),
])
def test_replica_fault_actions_match_jax(monkeypatch, spec, args):
    """The router's seam: the same spec gives the same action call by
    call, and the same fire counts, in both packages."""
    _set_spec(monkeypatch, spec)
    got = _actions(faults, lambda pkg: pkg.replica_fault_action, args, 8)
    want = _actions(jax_faults, lambda pkg: pkg.replica_fault_action, args, 8)
    assert got == want


@pytest.mark.parametrize("spec,names", [
    ("stream:drop:m-1", ["m-1", "m-2"]),
    ("stream:drop:m-1@attempts:1", ["m-1"]),
    ("stream:drop:m-1", ["m-3"]),
    ("stream:drop", ["m-3"]),
    ("stream:stall:m-1@ms:30@attempts:2", ["m-1"]),
    ("stream:stall:m-1", ["m-1"]),
    ("stream:burst:m-1@rate:12@attempts:2", ["m-1"]),
    ("stream:burst:m-1", ["m-1"]),
    ("stream:burst:m-1@rate:lots", ["m-1"]),
    ("stream:drop:m-1@attempts:1;stream:burst:m-1@rate:3@attempts:2", ["m-1"]),
])
def test_stream_fault_actions_match_jax(monkeypatch, spec, names):
    """The streams' seam, matched against a session's machines."""
    _set_spec(monkeypatch, spec)
    got = _actions(faults, lambda pkg: pkg.stream_fault_action, (names,), 5)
    want = _actions(jax_faults, lambda pkg: pkg.stream_fault_action, (names,), 5)
    assert got == want


def test_replica_and_stream_firings_count_by_site(tmp_path, monkeypatch):
    """A flap's failing calls and each suffered update fire
    ``fault_injected`` events and ``gordo_fault_fired_total{site}``."""
    from gordo_tpu_torch.observability.registry import get_registry

    def fired(site):
        dump = get_registry().snapshot().get("gordo_fault_fired_total") or {}
        return sum(s["value"] for s in dump.get("series", []) if s["labels"]["site"] == site)

    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("GORDO_TPU_EVENT_LOG", str(log))
    _set_spec(monkeypatch, "replica:flap:r1@burst:2;stream:burst:m-1@rate:4@attempts:1")
    before = fired("replica"), fired("stream")
    actions = [faults.replica_fault_action("r1") for _ in range(6)]
    assert actions == [("die", 0.0), ("die", 0.0), None, None, ("die", 0.0), ("die", 0.0)]
    assert faults.stream_fault_action(["m-1"]) == ("burst", 4.0)
    assert faults.stream_fault_action(["m-1"]) is None
    assert (fired("replica") - before[0], fired("stream") - before[1]) == (4, 1)
    records = read_events(str(log))
    assert [(r["site"], r["mode"], r["fire_count"]) for r in records] == [
        ("replica", "flap", 1), ("replica", "flap", 2), ("replica", "flap", 5),
        ("replica", "flap", 6), ("stream", "burst", 1)]
    assert records[0]["replica"] == "r1" and records[-1]["machines"] == ["m-1"]
