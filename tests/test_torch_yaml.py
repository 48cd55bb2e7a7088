"""
The port's YAML reader against PyYAML's ``yaml.safe_load``: every YAML
file under ``examples/``, the conftest ``CONFIG_STR``, and a table of
the YAML 1.1 scalar resolutions a quick reader gets wrong; then
``get_dict_from_yaml`` against the JAX package's, and the constructs
outside the reader's subset, each of which must raise ``ValueError``.

Values are compared exactly, types included (``True`` is not ``1``,
``1.0`` is not ``1``); NaN equals NaN.
"""

import io
import math
from datetime import date, datetime, timezone
from pathlib import Path

import pytest
import yaml

from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml as jax_get_dict_from_yaml
from gordo_tpu_torch.workflow.workflow_generator import get_dict_from_yaml
from gordo_tpu_torch.workflow.yaml_reader import safe_load
from tests.conftest import CONFIG_STR

REPO_ROOT = Path(__file__).resolve().parent.parent
EXAMPLE_FILES = sorted((REPO_ROOT / "examples").rglob("*.yaml"))


def same(got, want) -> bool:
    """Equal values of equal types, all the way down."""
    if isinstance(got, float) and isinstance(want, float) and math.isnan(got):
        return math.isnan(want)
    if type(got) is not type(want):
        return False
    if isinstance(want, dict):
        return list(got) == list(want) and all(same(got[k], want[k]) for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))
    if isinstance(want, datetime):
        return got == want and got.utcoffset() == want.utcoffset()
    return got == want


def test_the_examples_are_all_here():
    assert len(EXAMPLE_FILES) == 9


@pytest.mark.parametrize("path", EXAMPLE_FILES, ids=lambda p: p.name)
def test_reader_equals_pyyaml_on_the_examples(path):
    text = path.read_text()
    assert same(safe_load(text), yaml.safe_load(text))


def test_reader_equals_pyyaml_on_the_conftest_config():
    got = safe_load(CONFIG_STR)
    assert same(got, yaml.safe_load(CONFIG_STR))
    assert got["machines"][0]["dataset"]["tags"] == ["tag-0", "tag-1", "tag-2", "tag-3"]


# (plain scalar, the value PyYAML's SafeLoader gives it)
RESOLUTIONS = [
    ("yes", True), ("Yes", True), ("YES", True), ("no", False), ("On", True), ("OFF", False),
    ("true", True), ("FALSE", False), ("yEs", "yEs"), ("y", "y"), ("n", "n"), ("tRue", "tRue"),
    ("~", None), ("null", None), ("Null", None), ("NULL", None), ("nULL", "nULL"),
    ("0x1F", 31), ("-0x1f", -31), ("0b101", 5), ("+0b1_0", 2), ("012", 10), ("0o17", "0o17"),
    ("0", 0), ("-0", 0), ("+12", 12), ("1_000", 1000), ("1:20", 80), ("-1:20", -80),
    ("190:20:30", 685230), ("0:20", "0:20"), ("09", "09"),
    ("1.0", 1.0), ("1.", 1.0), (".5", 0.5), ("-.5", "-.5"), ("1e3", "1e3"), ("1.0e+3", 1000.0),
    ("1.0e3", "1.0e3"), ("685_230.15", 685230.15), ("1:20.5", 80.5),
    (".inf", math.inf), ("-.inf", -math.inf), ("+.Inf", math.inf), (".NaN", math.nan),
    ("-.nan", "-.nan"), ("inf", "inf"),
    ("2T", "2T"), ("10T", "10T"), ("8H", "8H"), ("10min", "10min"),
    ("2019-01-01", date(2019, 1, 1)), ("2019-1-1", "2019-1-1"),
    ("2019-01-01T00:00:00+00:00", datetime(2019, 1, 1, tzinfo=timezone.utc)),
    ("2019-01-01 00:00:00+00:00", datetime(2019, 1, 1, tzinfo=timezone.utc)),
    ("2019-01-01t00:00:00Z", datetime(2019, 1, 1, tzinfo=timezone.utc)),
    ("2019-01-01T10:00:00", datetime(2019, 1, 1, 10)),
    ("2001-12-14 21:59:43.10 -5", None),  # -05:00, checked against PyYAML below
    ("2019-01-01T00:00:00.123456789Z", None),
    ("http://x.y/z", "http://x.y/z"), ("a#b", "a#b"), ("-1", -1), ("-x", "-x"),
    ("1.2.3", "1.2.3"), ("1,000", "1,000"), ("it's", "it's"),
]


@pytest.mark.parametrize("text,value", RESOLUTIONS, ids=[r[0] for r in RESOLUTIONS])
def test_scalar_resolution_equals_pyyaml(text, value):
    for document in (f"key: {text}\n", f"- [{text}]\n" if "," not in text else f"- {text}\n"):
        want = yaml.safe_load(document)
        got = safe_load(document)
        assert same(got, want), document
    if value is not None:
        assert same(safe_load(f"key: {text}")["key"], value)


# structures beyond the examples: (name, document)
STRUCTURES = [
    ("sequence-at-key-indent", "a:\n- 1\n- 2\nb: 3\n"),
    ("nested-sequences", "- - a\n  - b\n- - c\n"),
    ("maps-in-a-sequence", "- name: x\n  v: 1\n- name: y\n  w: [1, 2]\n"),
    ("multi-line-flow", "a: [1,\n  2, # c\n  3]\nb: {x: 1,\n    y: 'z'}\n"),
    ("flow-pairs", "a: [x: 1, y]\nb: {p, q: , r: [1]}\n"),
    ("anchors", "a: &x\n  k: 1\nb: *x\nc: &y [1, 2]\nd: *y\ne: &s str\nf: *s\n"),
    ("folded-plain", "d: A replica drops off (x,\n  the y) and z;\n  done.\ne: 1\n"),
    ("folded-quoted", "a: 'x\n\n   y'\nb: \"p \\\n  q\"\nc: ['m\n  n', o]\n"),
    ("document-start", "# hi\n--- # c\na: 1\n"),
    ("comments", "# top\na: 1 # x\n# mid\n   # indented\nb:\n  # inner\n  c: 2\n"),
    ("empty", ""),
    ("quoted-keys-and-escapes", "'a b': 1\n\"c\\t\": \"\\u00e9\\x41\\\\\"\n'it''s': ''\n"),
    ("resolved-keys", "1: a\n2.5: b\nyes: c\n~: d\n"),
    ("empty-values", "a:\nb:\n  c:\nd: 1\n"),
    ("empty-entries", "-\n  a: 1\n-\n- x\n"),
    ("json", '{\n "a": [1, 2.5, true, null, "x"],\n "b": {"c": "d"}\n}\n'),
    ("colons-in-values", "a: b:c\nb: http://h:1/p\n"),
    ("trailing-commas", "a: [1, 2, ]\nb: {x: 1, }\n"),
    ("crlf", "a: 1\r\nb: 2\r\n"),
    ("top-level-scalar", "hello\n  world\n"),
]


@pytest.mark.parametrize("name,document", STRUCTURES, ids=[s[0] for s in STRUCTURES])
def test_structures_equal_pyyaml(name, document):
    assert same(safe_load(document), yaml.safe_load(document))


def test_aliases_share_the_anchored_node():
    got = safe_load("a: &x {k: [1]}\nb: *x\n")
    assert got["b"] is got["a"]


# constructs outside the reader's subset, each a ValueError naming the line
UNSUPPORTED = [
    ("tag", "a: 1\nb: !!str 1\n", 2),
    ("block-literal", "a: |\n  x\n", 1),
    ("block-folded", "a: >\n  x\n", 1),
    ("merge-key", "a: &x {b: 1}\nc:\n  <<: *x\n", 3),
    ("complex-key", "? a\n: b\n", 1),
    ("two-documents", "a: 1\n---\nb: 2\n", 2),
    ("directive", "%YAML 1.1\n---\na: 1\n", 1),
    ("document-end", "a: 1\n...\n", 2),
    ("unknown-alias", "a: 1\nb: *x\n", 2),
    ("tab-indent", "a:\n\tb: 1\n", 2),
    ("bad-indent", "a:\n    b: 1\n  c: 2\n", 3),
    ("mapping-in-a-value", "a: b: c\n", 1),
    ("sequence-in-a-value", "a: - b\n", 1),
    ("empty-flow-entry", "a: [1, , 2]\n", 1),
    ("unterminated-flow", "a: [1, 2\nb: 3\n", 2),
    ("value-key", "a: =\n", 1),
]


@pytest.mark.parametrize("name,document,line", UNSUPPORTED, ids=[u[0] for u in UNSUPPORTED])
def test_unsupported_constructs_raise_naming_the_line(name, document, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        safe_load(document)


def test_get_dict_from_yaml_equals_jax_on_the_example_config():
    path = REPO_ROOT / "examples" / "config.yaml"
    got, want = get_dict_from_yaml(str(path)), jax_get_dict_from_yaml(str(path))
    assert got == want
    assert [m["name"] for m in got["machines"]] == [
        "pump-4130", "compressor-2201", "turbine-9900-transformer"
    ]
    start = got["machines"][0]["dataset"]["train_start_date"]
    assert start == datetime(2019, 1, 1, tzinfo=timezone.utc)
    assert get_dict_from_yaml(io.StringIO(CONFIG_STR)) == jax_get_dict_from_yaml(
        io.StringIO(CONFIG_STR)
    )


@pytest.mark.parametrize("stamp", ["2019-01-01T00:00:00", "2019-01-01 10:00:00", "2019-01-01"])
def test_get_dict_from_yaml_refuses_a_naive_timestamp_as_jax_does(stamp):
    document = f"machines:\n  - name: a\n    dataset:\n      train_start_date: {stamp}\n"
    with pytest.raises(ValueError) as want:
        jax_get_dict_from_yaml(io.StringIO(document))
    with pytest.raises(ValueError) as got:
        get_dict_from_yaml(io.StringIO(document))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"Provide timezone to timestamp {stamp}.")


def test_get_dict_from_yaml_names_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="Unable to find config file"):
        get_dict_from_yaml(str(tmp_path / "nope.yaml"))
