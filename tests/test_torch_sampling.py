"""
The port's sampling wall profiler (``observability/sampling.py``), its
hook in the phase ledger, and the ``profile`` command, against the JAX
package's: the dump's keys, ``folded_lines``, the sampler-off path (one
module-global read: the phase map is never touched, pinned by call count
as ``tests/test_attribution.py`` pins JAX's), and ``profile report`` and
``profile flame`` printing exactly what JAX's click commands print on one
dump. A ``run-server`` stopped with SIGTERM exits 0 and writes its dump.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
from click.testing import CliRunner

from gordo_tpu.cli.profile import profile_cli as jax_profile_cli
from gordo_tpu.cli.profile import render_report as jax_render_report
from gordo_tpu.observability import sampling as jax_sampling
from gordo_tpu_torch.cli import profile
from gordo_tpu_torch.observability import sampling
from gordo_tpu_torch.observability.attribution import PhaseLedger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAYLOAD = {
    "profile_version": 1,
    "hz": 97.0,
    "n_samples": 100,
    "duration_s": 2.0,
    "per_phase": {"server/transform": 60, "server/device": 30, "-/unattributed": 10,
                  "stream/parse": 7},
    "modules_by_phase": {
        "server/transform": {"numpy": 40, "gordo_tpu_torch.models.pipeline": 20, "json": 3},
        "server/device": {"torch.cuda": 30},
        "-/unattributed": {"selectors": 10},
        "stream/parse": {"json": 7},
    },
    "folded": {"a:f;b:g": 3, "a:f;c:h": 9, "a:f": 1},
    "phase_seconds": {
        "server/transform": {"count": 10, "sum": 6.0},
        "server/device": {"count": 10, "sum": 4.0},
        "stream/parse": {"count": 3, "sum": 0.25},
    },
}


def _sampled_report(package):
    """One sampler's report with a thread inside a ledger bracket."""
    from gordo_tpu.observability.attribution import PhaseLedger as JaxPhaseLedger

    ledger_cls = PhaseLedger if package is sampling else JaxPhaseLedger
    sampler = package.WallSampler(hz=50)
    release, inside = threading.Event(), threading.Event()

    def bracketed():
        with ledger_cls("server").phase("transform"):
            inside.set()
            release.wait(timeout=10)

    worker = threading.Thread(target=bracketed)
    sampler.start()
    try:
        assert package.profiler_active()
        worker.start()
        assert inside.wait(timeout=10)
        for _ in range(5):
            sampler.sample_once()
    finally:
        release.set()
        worker.join()
        sampler.stop()
    assert not package.profiler_active()
    assert package._PHASES == {}
    return sampler.report()


def test_dump_keys_and_attribution_match_jax():
    report, jax_report = _sampled_report(sampling), _sampled_report(jax_sampling)
    assert sorted(report) == sorted(jax_report)
    assert report["profile_version"] == jax_report["profile_version"] == 1
    assert report["n_samples"] >= 5
    assert report["per_phase"].get("server/transform", 0) >= 1
    assert sampling.UNATTRIBUTED == jax_sampling.UNATTRIBUTED
    assert sampling.UNATTRIBUTED in report["per_phase"]
    modules = report["modules_by_phase"]["server/transform"]
    assert any("threading" in m or "test_torch_sampling" in m for m in modules)


def test_folded_lines_match_jax():
    assert sampling.folded_lines(PAYLOAD) == jax_sampling.folded_lines(PAYLOAD)
    assert sampling.folded_lines(PAYLOAD) == ["a:f;c:h 9", "a:f;b:g 3", "a:f 1"]
    assert sampling.folded_lines({}) == jax_sampling.folded_lines({}) == []


def test_sampler_hook_is_one_global_read_when_inactive(monkeypatch):
    monkeypatch.delenv(sampling.PROFILE_HZ_ENV_VAR, raising=False)
    assert sampling.maybe_start_from_env() is None
    assert not sampling.profiler_active()

    def _bomb(*args, **kwargs):  # pragma: no cover - the assertion is the test
        raise AssertionError("sampling map touched while the profiler is inactive")

    monkeypatch.setattr(sampling, "set_phase", _bomb)
    monkeypatch.setattr(sampling, "clear_phase", _bomb)
    monkeypatch.setattr(sampling, "current_phase", _bomb)
    ledger = PhaseLedger("server")
    with ledger.phase("parse"):
        pass
    assert "parse" in ledger.phases


def test_nested_brackets_restore_the_outer_phase():
    sampler = sampling.WallSampler(hz=50)
    sampler.start()
    try:
        ledger = PhaseLedger("stream")
        with ledger.phase("parse"):
            with ledger.phase("transform"):
                assert sampling.current_phase() == ("stream", "transform")
            assert sampling.current_phase() == ("stream", "parse")
        assert sampling.current_phase() is None
    finally:
        sampler.stop()


def test_flush_and_env_start(tmp_path, monkeypatch):
    out = tmp_path / "profile.json"
    monkeypatch.setenv(sampling.PROFILE_HZ_ENV_VAR, "200")
    monkeypatch.setenv(sampling.PROFILE_OUT_ENV_VAR, str(out))
    monkeypatch.setattr(sampling, "_SAMPLER", None)
    sampler = sampling.maybe_start_from_env()
    try:
        assert sampler is not None
        assert sampling.maybe_start_from_env() is sampler
        assert sampling.active_sampler() is sampler
        sampler.sample_once()
    finally:
        sampler.stop()
        sampler.flush()
        monkeypatch.setattr(sampling, "_SAMPLER", None)
    payload = json.loads(out.read_text())
    assert payload["profile_version"] == sampling.PROFILE_VERSION
    assert payload["hz"] == 200.0
    assert "phase_seconds" in payload


@pytest.mark.parametrize("raw", ("not-a-rate", "0", "-3", ""))
def test_env_start_rejects_garbage(monkeypatch, raw):
    monkeypatch.setattr(sampling, "_SAMPLER", None)
    monkeypatch.setenv(sampling.PROFILE_HZ_ENV_VAR, raw)
    assert sampling.maybe_start_from_env() is None
    assert not sampling.profiler_active()


def _port(argv):
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        code = profile.main(argv)
    return code, buffer.getvalue()


@pytest.mark.parametrize("top", (1, 2, 5))
def test_profile_report_prints_jax_text(tmp_path, top):
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps(PAYLOAD))
    jax_out = CliRunner().invoke(jax_profile_cli, ["report", str(dump), "--top", str(top)])
    assert jax_out.exit_code == 0
    assert _port(["report", str(dump), "--top", str(top)]) == (0, jax_out.output)
    assert profile.render_report(PAYLOAD, top=top) == jax_render_report(PAYLOAD, top=top)


def test_profile_report_of_a_sampled_dump_prints_jax_text(tmp_path):
    dump = tmp_path / "dump.json"
    sampler = sampling.WallSampler(hz=100)
    sampler.start()
    with PhaseLedger("server").phase("parse"):
        sampler.sample_once()
    sampler.stop()
    assert sampler.flush(str(dump)) == str(dump)
    jax_out = CliRunner().invoke(jax_profile_cli, ["report", str(dump)])
    assert _port(["report", str(dump)]) == (0, jax_out.output)


def test_profile_flame_prints_jax_text(tmp_path):
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps(PAYLOAD))
    jax_out = CliRunner().invoke(jax_profile_cli, ["flame", str(dump)])
    assert _port(["flame", str(dump)]) == (0, jax_out.output)
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    jax_file = CliRunner().invoke(jax_profile_cli, ["flame", str(dump), "-o", str(theirs)])
    code, text = _port(["flame", str(dump), "-o", str(ours)])
    assert code == 0 and text == jax_file.output.replace(str(theirs), str(ours))
    assert ours.read_text() == theirs.read_text()


def test_profile_refuses_a_file_that_is_no_dump(tmp_path, capsys):
    bogus = tmp_path / "not_a_profile.json"
    bogus.write_text("{}")
    jax_out = CliRunner().invoke(jax_profile_cli, ["report", str(bogus)])
    assert jax_out.exit_code == 1
    assert profile.main(["report", str(bogus)]) == 1
    assert capsys.readouterr().err == jax_out.output
    with pytest.raises(SystemExit) as missing:
        profile.main(["flame", str(tmp_path / "absent.json")])
    assert missing.value.code == 2


def test_the_cli_registers_profile(tmp_path):
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps(PAYLOAD))
    run = subprocess.run([sys.executable, "-m", "gordo_tpu_torch.cli", "profile", "flame",
                          str(dump)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout == "a:f;c:h 9\na:f;b:g 3\na:f 1\n"


def test_sigterm_stops_the_runner_and_writes_the_dump(tmp_path):
    """run-server under GORDO_PROFILE_HZ, stopped by SIGTERM: a clean exit
    (0), so the exit handler flushes the sampler's dump."""
    collection = tmp_path / "collection"
    collection.mkdir()
    dump = tmp_path / "gordo_profile.json"
    env = dict(os.environ, GORDO_PROFILE_HZ="50", GORDO_PROFILE_OUT=str(dump))
    server = subprocess.Popen(
        [sys.executable, "-m", "gordo_tpu_torch.cli", "run-server", "--collection-dir",
         str(collection), "--device", "cpu", "--host", "127.0.0.1", "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = server.stdout.readline()
            lines.append(line)
            if "Serving on" in line or not line:
                break
        assert any("Serving on" in line for line in lines), "".join(lines)
        time.sleep(0.3)  # a few samples
        server.send_signal(signal.SIGTERM)
        assert server.wait(timeout=60) == 0
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    payload = json.loads(dump.read_text())
    assert payload["profile_version"] == 1 and payload["hz"] == 50.0
    assert payload["n_samples"] > 0
