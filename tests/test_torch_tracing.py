"""
The port's tracing (``gordo_tpu_torch.observability.tracing``) and phase
ledger (``attribution``) against the JAX package's on the same inputs:
``traceparent`` formatting and parsing (malformed headers too), the
head-sampling verdict, the records a nesting of spans writes (all but
ids and times), the Chrome-trace export and summary of one JAX-written
span file, the strict no-op while tracing is off (by call count, as the
JAX test pins it), the ledger's no-op and its span attributes, and the
trace fields an event emitted inside a span carries. Every test sets or
clears ``GORDO_TPU_TRACE_LOG`` itself and writes under ``tmp_path``.
"""

import json
import random

import pytest

from gordo_tpu.observability import attribution as jax_attribution
from gordo_tpu.observability import events as jax_events
from gordo_tpu.observability import tracing as jax_tracing
from gordo_tpu_torch.observability import attribution, events, tracing

HEADERS = [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
    " 00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01 ",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01-extra",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01-extra",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-1",
    "00-0af7651916cd43dd8448eb211c80319g-b7ad6b7169203331-01",
    "0-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-zz",
    "garbage",
    "",
    None,
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parsing_matches_jax(header):
    got, want = tracing.parse_traceparent(header), jax_tracing.parse_traceparent(header)
    assert (None if got is None else tuple(got)) == (None if want is None else tuple(want))
    if got is not None:
        assert tracing.format_traceparent(got) == jax_tracing.format_traceparent(want)


@pytest.mark.parametrize("rate", ["0", "0.3", "1", "", "nonsense", "7"])
def test_sampling_verdicts_match_jax(rate, monkeypatch):
    monkeypatch.setenv(tracing.TRACE_SAMPLE_ENV_VAR, rate)
    rng = random.Random(1234)
    ids = ["%032x" % rng.getrandbits(128) for _ in range(1000)]
    got = [tracing._sampled(i) for i in ids]
    assert got == [jax_tracing._sampled(i) for i in ids]
    if rate == "0.3":
        assert 200 < sum(got) < 400


def _nest(module, log, tmp_path, monkeypatch):
    """root > child(machine) > grandchild (raises), a recorded phase and
    an unsampled-parent span, in ``module``'s tracing; its records."""
    monkeypatch.setenv(module.TRACE_LOG_ENV_VAR, str(tmp_path / log))
    monkeypatch.delenv(module.TRACE_SAMPLE_ENV_VAR, raising=False)
    with module.start_span("client.predict", path="fleet", n_machines=2) as root:
        with module.start_span("client.request", machine="m-1") as child:
            child.set_attribute("attempts", 2)
            try:
                with module.start_span("inner"):
                    raise ValueError("boom")
            except ValueError:
                pass
            module.record_span("predict", 0.25, plane="server")
        remote = module.SpanContext(root.trace_id, root.span_id, False)
        with module.start_span("unsampled", parent=remote) as quiet:
            assert not quiet.recording
        with module.start_span("new-root", parent=None):
            pass
    return module.read_spans(str(tmp_path / log))


def _shape(records):
    by_id = {r["span_id"]: r for r in records}
    return [
        (r["name"], by_id.get(r["parent_span_id"], {}).get("name"), r["status"],
         r["attributes"], sorted(r), len(r["trace_id"]), len(r["span_id"]))
        for r in records
    ]


def test_span_records_match_jax_but_for_ids_and_times(tmp_path, monkeypatch):
    got = _nest(tracing, "port.jsonl", tmp_path, monkeypatch)
    want = _nest(jax_tracing, "jax.jsonl", tmp_path, monkeypatch)
    assert _shape(got) == _shape(want)
    assert [r["name"] for r in got] == ["inner", "predict", "client.request", "new-root",
                                       "client.predict"]
    assert len({r["trace_id"] for r in got}) == 2
    assert got[0]["attributes"]["error"] == "ValueError('boom')"


def test_export_and_summary_of_a_jax_span_file_match(tmp_path, monkeypatch):
    _nest(jax_tracing, "spans.jsonl", tmp_path, monkeypatch)
    path = str(tmp_path / "spans.jsonl")
    # an event line and a torn last line in the same file are skipped
    with open(path, "a") as fh:
        fh.write(json.dumps({"event": "x", "unix_ms": 1}) + "\n" + '{"trace_id": "ab')
    got, want = tracing.read_spans(path), jax_tracing.read_spans(path)
    assert got == want and len(got) == 5
    assert tracing.spans_to_chrome_trace(got) == jax_tracing.spans_to_chrome_trace(want)
    for top in (1, 5):
        assert tracing.summarize_spans(got, top=top) == jax_tracing.summarize_spans(want, top=top)
    assert tracing.summarize_spans([]) == jax_tracing.summarize_spans([]) == "no spans"


def test_chrome_trace_puts_ledger_phases_on_their_tracks(tmp_path, monkeypatch):
    monkeypatch.setenv(tracing.TRACE_LOG_ENV_VAR, str(tmp_path / "s.jsonl"))
    with tracing.start_span("server.request") as span:
        for phase in ("parse", "device", "serialize"):
            tracing.record_span(phase, 0.001)
    records = tracing.read_spans(str(tmp_path / "s.jsonl"))
    assert tracing.spans_to_chrome_trace(records) == jax_tracing.spans_to_chrome_trace(records)
    tids = {e["name"]: e["tid"] for e in tracing.spans_to_chrome_trace(records)["traceEvents"]
            if e["ph"] == "X"}
    assert tids["device"] == 1_000_001 and tids["parse"] == tids["serialize"] == 1_000_000
    assert span.trace_id


def test_disabled_tracing_is_a_strict_noop(monkeypatch):
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)

    def explode(*args, **kwargs):
        raise AssertionError("span machinery ran with tracing off")

    monkeypatch.setattr(tracing, "_begin_span", explode)
    monkeypatch.setattr(tracing, "_write_span", explode)
    with tracing.start_span("anything", machine="m") as span:
        assert span is tracing.NOOP_SPAN
        span.set_attribute("k", "v")
        with tracing.start_span("nested") as inner:
            assert inner is tracing.NOOP_SPAN
    assert tracing.record_span("phase", 0.1) is None
    assert tracing.current_span() is None
    assert tracing.current_context() is None
    assert tracing.current_traceparent() is None
    assert tracing.propagation_headers() == {}
    assert tracing.trace_fields() == {}


def test_measure_overhead_reports_the_jax_keys(monkeypatch):
    monkeypatch.delenv(tracing.TRACE_LOG_ENV_VAR, raising=False)
    got = tracing.measure_overhead(samples=50)
    assert set(got) == set(jax_tracing.measure_overhead(samples=50))
    assert tracing.TRACE_LOG_ENV_VAR not in __import__("os").environ
    ledger = attribution.measure_overhead(samples=50)
    assert set(ledger) == set(jax_attribution.measure_overhead(samples=50))


def test_ledger_off_is_a_strict_noop(monkeypatch):
    monkeypatch.setenv(attribution.LEDGER_ENV_VAR, "0")
    ledger = attribution.ledger_for("server")
    assert ledger is attribution.NOOP_LEDGER
    with ledger.phase("parse"), ledger.activate():
        assert attribution.record_current("device", 1.0) is False
    assert ledger.finish(span=None, wall_s=1.0) == {}
    assert ledger.phases == {}


def test_ledger_summary_and_span_attributes_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv(attribution.LEDGER_ENV_VAR, raising=False)
    results = []
    for module, ledger_module in ((tracing, attribution), (jax_tracing, jax_attribution)):
        monkeypatch.setenv(module.TRACE_LOG_ENV_VAR, str(tmp_path / f"{module.__name__}.jsonl"))
        with module.start_span("server.request") as span:
            ledger = ledger_module.ledger_for("server")
            with ledger.activate():
                ledger.add("parse", 0.002)
                assert ledger_module.record_current("transfer", 0.001)
                assert ledger_module.record_current("device", 0.004)
                ledger.add("serialize", 0.003)
            summary = ledger.finish(span=span, wall_s=0.02)
        assert ledger_module.record_current("device", 1.0) is False  # no active ledger
        results.append((summary, dict(span.attributes)))
    (got, got_attrs), (want, want_attrs) = results
    assert got == want
    assert got_attrs == want_attrs
    assert got["host_fraction"] == pytest.approx(0.5)
    assert attribution.PHASES == jax_attribution.PHASES
    assert attribution.DEVICE_PHASES == jax_attribution.DEVICE_PHASES


def test_an_event_inside_a_span_carries_its_trace_fields(tmp_path, monkeypatch):
    """The Step 0 repair: the port's event records, like the JAX ones,
    carry the active span's ids; explicit fields win; none outside."""
    monkeypatch.setenv(events.EVENT_LOG_ENV_VAR, str(tmp_path / "events.jsonl"))
    monkeypatch.setenv(tracing.TRACE_LOG_ENV_VAR, str(tmp_path / "spans.jsonl"))
    with tracing.start_span("lifecycle.tick") as span:
        got = events.emit_event("drift_detected", machine="m")
        explicit = events.emit_event("x", trace_id="given")
        # the JAX emitter on the same span, its context handed over
        want = jax_events.emit_event("drift_detected", machine="m",
                                     **tracing.trace_fields(span))
    outside = events.emit_event("outside")
    assert {k: got[k] for k in ("trace_id", "span_id")} == {
        "trace_id": span.trace_id, "span_id": span.span_id}
    assert {k: want[k] for k in ("trace_id", "span_id")} == {
        k: got[k] for k in ("trace_id", "span_id")}
    assert set(got) == set(want)
    assert explicit["trace_id"] == "given" and explicit["span_id"] == span.span_id
    assert "trace_id" not in outside
    lines = events.read_events(str(tmp_path / "events.jsonl"))
    assert [line["event"] for line in lines] == ["drift_detected", "x", "drift_detected",
                                                "outside"]
