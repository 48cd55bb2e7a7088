"""
The port's data layer (``gordo_tpu_torch.data``, numpy only) against the
JAX package's (pandas): the random provider's samples bit for bit, the
resample and join engine on hypothesis-drawn series, and ``get_data`` for
the two default machines of ``examples/config.yaml`` and conftest's
RandomDataset.

Tolerance: values to 1e-12 (relative; 1e-10 absolute for values up to
100). Bucket means are float64 sums in another order than pandas' Kahan
sums; everything else (bucket labels, row counts, provider samples,
metadata keys, histograms) must be equal.
"""

import json
import logging
import math
import types
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gordo_tpu.data import _get_dataset as jax_get_dataset
from gordo_tpu.data.base import GordoBaseDataset as JaxBaseDataset
from gordo_tpu.data.providers import RandomDataProvider as JaxRandomDataProvider
from gordo_tpu.data.sensor_tag import SensorTag as JaxSensorTag
from gordo_tpu.data.sensor_tag import normalize_sensor_tags as jax_normalize_sensor_tags
from gordo_tpu.utils.compat import normalize_frequency as jax_normalize_frequency
from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig
from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml
from gordo_tpu_torch.data import (
    InsufficientDataError,
    SensorTag,
    SensorTagNormalizationError,
    TagSeries,
    _get_dataset,
    normalize_sensor_tags,
)
from gordo_tpu_torch.data.base import GordoBaseDataset, _fill_gaps
from gordo_tpu_torch.data.providers import RandomDataProvider
from gordo_tpu_torch.data.providers.compound import LAKE_DIR_ENV_VAR
from gordo_tpu_torch.utils.compat import frequency_to_ns, normalize_frequency
from tests.conftest import SENSORS

RTOL, ATOL = 1e-12, 1e-10
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
UTC = timezone.utc


def example_datasets():
    """{machine name: normalized dataset dict} of examples/config.yaml."""
    config = get_dict_from_yaml(str(EXAMPLES / "config.yaml"))
    machines = NormalizedConfig(config, project_name="plant-a-anomaly").machines
    return {m.name: json.loads(json.dumps(m.dataset.to_dict(), default=str)) for m in machines}


# conftest's RandomDataset machine
CONFTEST_DATASET = {
    "type": "RandomDataset",
    "tags": SENSORS,
    "target_tag_list": SENSORS,
    "train_start_date": "2019-01-01T00:00:00+00:00",
    "train_end_date": "2019-01-03T00:00:00+00:00",
    "asset": "gra",
}


def _ns(index) -> np.ndarray:
    return pd.DatetimeIndex(index).as_unit("ns").asi8


# -- frequency aliases and tags ---------------------------------------------


@pytest.mark.parametrize("alias", ["10T", "2T", "8H", "10min", "1h", "30S", "1D", "500L", "15min"])
def test_frequency_aliases_match_jax_and_pandas(alias):
    assert normalize_frequency(alias) == jax_normalize_frequency(alias)
    assert frequency_to_ns(alias) == pd.Timedelta(jax_normalize_frequency(alias)).value


def test_frequency_parser_refuses_what_it_cannot_read():
    for bad in ("", "T10", "10 parsecs", None):
        with pytest.raises(ValueError):
            frequency_to_ns(bad)


@pytest.mark.parametrize(
    "tags,asset",
    [
        (["GRA-PUMP-TEMP 1", "gfa.x", "per-pa.1", "TRB-1"], None),
        ([{"name": "a", "asset": "b"}, ["c", "d"]], None),
        (["tag-1", "tag-2"], "gra"),
    ],
)
def test_sensor_tags_normalize_like_jax(tags, asset):
    got = normalize_sensor_tags(tags, asset)
    want = jax_normalize_sensor_tags(tags, asset)
    assert [tuple(t) for t in got] == [tuple(t) for t in want]


def test_unknown_tag_raises_like_jax():
    with pytest.raises(SensorTagNormalizationError, match="Unable to find asset"):
        normalize_sensor_tags(["XYZ-NO-ASSET"])


# -- the random provider -----------------------------------------------------


@pytest.mark.parametrize(
    "kwargs,start,end,tags",
    [
        ({}, "2019-01-01T00:00:00+00:00", "2019-06-01T00:00:00+00:00", ["GRA-A 1", "GRA-B 2"]),
        ({"seed": 3}, "2016-11-07T09:11:30+01:00", "2018-09-15T03:01:00+01:00", ["tag-0"]),
        ({"min_size": 5, "max_size": 9}, "2020-02-29T12:00:00+00:00", "2020-03-01T00:00:00+00:00",
         ["x", "y", "z"]),
    ],
)
def test_random_provider_samples_equal_jax(kwargs, start, end, tags):
    start, end = datetime.fromisoformat(start), datetime.fromisoformat(end)
    got = list(RandomDataProvider(**kwargs).load_series(start, end, [SensorTag(t) for t in tags]))
    want = list(
        JaxRandomDataProvider(**kwargs).load_series(start, end, [JaxSensorTag(t) for t in tags])
    )
    assert [s.name for s in got] == [s.name for s in want] == tags
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.index, _ns(w.index))
        np.testing.assert_array_equal(g.values, w.to_numpy())


# -- the resample and join engine --------------------------------------------

_SPAN_START = datetime(2020, 3, 1, tzinfo=UTC)


@st.composite
def raw_series(draw, name="tag"):
    """(series for the port, series for pandas, span start, span end): a
    span that starts off midnight, and up to 40 timestamps in it (repeats
    allowed), some values NaN."""
    start = _SPAN_START + timedelta(seconds=draw(st.integers(0, 86399)))
    span_s = draw(st.integers(600, 3 * 86400))
    offsets = sorted(draw(st.lists(st.integers(0, span_s), min_size=1, max_size=40)))
    values = draw(
        st.lists(
            st.one_of(st.floats(-100, 100), st.just(math.nan)),
            min_size=len(offsets),
            max_size=len(offsets),
        )
    )
    stamps = [start + timedelta(seconds=s) for s in offsets]
    index = _ns(pd.DatetimeIndex(stamps))
    port = TagSeries(name, index, np.asarray(values, dtype=np.float64))
    frame = pd.Series(values, index=pd.DatetimeIndex(stamps), name=name, dtype=np.float64)
    return port, frame, start, start + timedelta(seconds=span_s)


RESAMPLE_OPTIONS = dict(
    resolution=st.sampled_from(["10T", "2T", "1H", "15min", "30S"]),
    method=st.sampled_from(["linear_interpolation", "ffill"]),
    limit=st.sampled_from(["8H", "1H", "30min", "2T", None]),
)


def _resample_both(port, frame, start, end, resolution, method, limit):
    kwargs = dict(
        resampling_startpoint=start,
        resampling_endpoint=end,
        resolution=resolution,
        interpolation_method=method,
        interpolation_limit=limit,
    )
    try:
        want = JaxBaseDataset._resample(frame, **kwargs)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)):
            GordoBaseDataset._resample(port, **kwargs)
        return None
    return GordoBaseDataset._resample(port, **kwargs), want


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(drawn=raw_series(), **RESAMPLE_OPTIONS)
def test_resample_matches_jax(drawn, resolution, method, limit):
    """Gaps longer and shorter than the limit, leading and trailing NaN
    buckets (NaN values among the samples too), span starts off midnight,
    limits under the resolution (both raise), both fill methods."""
    pair = _resample_both(*drawn, resolution, method, limit)
    if pair is None:
        return
    got, want = pair
    np.testing.assert_array_equal(got.index, _ns(want.index))
    np.testing.assert_allclose(got.values, want.to_numpy(dtype=np.float64), rtol=RTOL, atol=ATOL)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    tags=st.lists(raw_series(), min_size=1, max_size=3),
    resolution=RESAMPLE_OPTIONS["resolution"],
    method=RESAMPLE_OPTIONS["method"],
)
def test_join_timeseries_matches_jax(tags, resolution, method):
    """Every tag on one span (the first's), inner-joined; the joined
    frame and ``tag_loading_metadata`` as the JAX dataset's."""
    _, _, start, end = tags[0]
    ports, frames = [], []
    for i, (port, frame, _, _) in enumerate(tags):
        inside = (frame.index >= start) & (frame.index <= end)
        name = f"tag-{i}"
        ports.append(TagSeries(name, port.index[inside], port.values[inside]))
        frames.append(frame[inside].rename(name))
    if any(len(f) == 0 for f in frames):
        with pytest.raises(InsufficientDataError, match="missing data"):
            _join(GordoBaseDataset, ports, start, end, resolution, method)
        return
    got, got_meta = _join(GordoBaseDataset, ports, start, end, resolution, method)
    want, want_meta = _join(JaxBaseDataset, frames, start, end, resolution, method)
    assert got.columns == list(want.columns)
    np.testing.assert_array_equal(got.index, _ns(want.index))
    np.testing.assert_allclose(got.values, want.to_numpy(), rtol=RTOL, atol=ATOL)
    assert got_meta == want_meta


def _join(cls, series, start, end, resolution, method):
    holder = types.SimpleNamespace(_metadata={}, _resample=cls._resample)
    frame = cls.join_timeseries(
        holder, series, start, end, resolution, interpolation_method=method
    )
    return frame, holder._metadata["tag_loading_metadata"]


@pytest.mark.parametrize(
    "method,want",
    [
        ("linear_interpolation", [np.nan, 1, 1.8, 2.6, np.nan, np.nan, 5, 5, 5, np.nan]),
        ("ffill", [np.nan, 1, 1, 1, np.nan, np.nan, 5, 5, 5, np.nan]),
    ],
)
def test_gap_fill_follows_pandas_forward_limit(method, want):
    """pandas 3's ``interpolate(limit=2)`` / ``ffill(limit=2)`` on one
    series: the first two NaNs of the interior gap on the line across the
    whole gap, the first two trailing ones the last value, the leading
    one NaN."""
    values = np.array([np.nan, 1, np.nan, np.nan, np.nan, np.nan, 5, np.nan, np.nan, np.nan])
    frame = pd.Series(values)
    pandas = frame.interpolate(limit=2) if method != "ffill" else frame.ffill(limit=2)
    np.testing.assert_allclose(pandas.to_numpy(), want)
    np.testing.assert_allclose(_fill_gaps(values, method, 2), want)


@pytest.mark.parametrize("aggregation", [np.mean, ["mean", "var"]])
def test_other_aggregations_are_queued(aggregation):
    """A callable, and a method outside the ported ones, name the queue
    item they wait in (max, sum, lists of methods, ... are ported:
    tests/test_torch_data_options.py)."""
    series = TagSeries("a", np.array([0, 60_000_000_000]), np.array([1.0, 2.0]))
    start = datetime(1970, 1, 1, tzinfo=UTC)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 7"):
        GordoBaseDataset._resample(
            series, start, start + timedelta(hours=1), "10T", aggregation_methods=aggregation
        )


# -- datasets ---------------------------------------------------------------


def _dataset_configs():
    datasets = example_datasets()
    return {
        "pump-4130": datasets["pump-4130"],
        "compressor-2201": datasets["compressor-2201"],
        "conftest-random": CONFTEST_DATASET,
    }


@pytest.mark.parametrize(
    "name,rows", [("pump-4130", 766), ("compressor-2201", 10975), ("conftest-random", 288)]
)
def test_get_data_matches_jax(name, rows, caplog):
    config = _dataset_configs()[name]
    with caplog.at_level(logging.WARNING):
        port = _get_dataset(config)
    if config.get("data_provider", "") is None:
        assert "falling back to RandomDataProvider" in caplog.text
    X, y, index = port.get_data()
    jax = jax_get_dataset(config)
    want_X, want_y = jax.get_data()
    assert X.shape == want_X.shape == (rows, len(config.get("tags") or config["tag_list"]))
    np.testing.assert_allclose(X, want_X.to_numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, want_y.to_numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(index.astype(np.int64), _ns(want_X.index))

    got_meta, want_meta = port.get_metadata(), jax.get_metadata()
    assert list(got_meta) == list(want_meta)
    assert got_meta["tag_loading_metadata"] == want_meta["tag_loading_metadata"]
    assert got_meta["x_hist"] == want_meta["x_hist"]
    for key in ("train_start_date_actual", "train_end_date_actual"):
        assert str(got_meta[key]) == str(want_meta[key])
    got_stats, want_stats = got_meta["summary_statistics"], want_meta["summary_statistics"]
    assert list(got_stats) == list(want_stats)
    for tag, stats in want_stats.items():
        assert list(got_stats[tag]) == list(stats)
        np.testing.assert_allclose(
            list(got_stats[tag].values()), list(stats.values()), rtol=RTOL, atol=ATOL
        )


def test_global_bounds_are_strict_like_jax():
    """Rows with any value at or outside the bounds go, as in JAX."""
    config = dict(CONFTEST_DATASET, low_threshold=0.1, high_threshold=0.9)
    X, _, _ = _get_dataset(config).get_data()
    want, _ = jax_get_dataset(config).get_data()
    assert 0 < len(X) == len(want) < 288
    np.testing.assert_allclose(X, want.to_numpy(), rtol=RTOL, atol=ATOL)
    assert ((X > 0.1) & (X < 0.9)).all()


def test_insufficient_data_raises_like_jax():
    config = dict(CONFTEST_DATASET, n_samples_threshold=500)
    with pytest.raises(InsufficientDataError, match="500"):
        _get_dataset(config).get_data()


@pytest.mark.parametrize(
    "change,match",
    [
        ({"aggregation_methods": "var"}, "ROADMAP.md queue 1 item 7"),
        ({"data_provider": {"type": "ObjectStoreProvider"}}, "fsspec"),
        ({"data_provider": {"type": "InfluxDataProvider"}}, "influxdb"),
    ],
)
def test_unported_dataset_options_raise(change, match):
    config = dict(CONFTEST_DATASET, type="TimeSeriesDataset", **change)
    with pytest.raises(NotImplementedError, match=match):
        _get_dataset(config)


def test_lake_directory_is_not_read_yet(monkeypatch, tmp_path):
    """A lake of parquet files is not read (no pyarrow on the card's
    machine): the error says so; CSV lakes are read
    (tests/test_torch_data_options.py)."""
    monkeypatch.setenv(LAKE_DIR_ENV_VAR, str(tmp_path))
    config = dict(CONFTEST_DATASET, type="TimeSeriesDataset", data_provider=None)
    dataset = _get_dataset(config)
    for tag in dataset.tag_list:
        (tmp_path / f"{tag.name}.parquet").write_bytes(b"PAR1")
    with pytest.raises(NotImplementedError, match="pyarrow"):
        dataset.get_data()


def test_naive_dates_and_empty_windows_raise():
    with pytest.raises(ValueError, match="timezone-naive"):
        _get_dataset(dict(CONFTEST_DATASET, train_start_date="2019-01-01T00:00:00"))
    with pytest.raises(ValueError, match="empty training window"):
        _get_dataset(dict(CONFTEST_DATASET, train_end_date="2019-01-01T00:00:00+00:00"))


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31), n=st.integers(1, 3000), span_s=st.integers(60, 86400),
       resolution=st.sampled_from(["10T", "2T", "1H"]), scale=st.sampled_from([1.0, 1e6]))
def test_bucket_sums_and_means_are_pandas_bits(seed, n, span_s, resolution, scale):
    """The repair of the client slice: a bucket's sum and mean add its
    samples in time order with Kahan's compensation, as pandas' grouped
    sum and mean do, so a resampled frame is bitwise the JAX dataset's (a
    plain running sum differed in the last bit of about a third of the
    buckets, and the client's request bodies with it)."""
    from gordo_tpu_torch.data.base import _bucketize

    rng = np.random.default_rng(seed)
    start = np.int64(1546300800 * 10**9)
    index = np.sort(start + rng.integers(0, span_s * 10**9, n))
    values = scale * rng.normal(size=n)
    labels, aggregates = _bucketize(TagSeries("t", index, values), frequency_to_ns(resolution),
                                    ("mean", "sum"))
    series = pd.Series(values, index=pd.to_datetime(index, utc=True))
    rule = jax_normalize_frequency(resolution)
    for column, method in enumerate(("mean", "sum")):
        want = getattr(series.resample(rule), method)()
        want = want[series.resample(rule).count() > 0]
        got = aggregates[:, column]
        got = got[~np.isnan(aggregates[:, 0])]
        np.testing.assert_array_equal(got, want.to_numpy())


def test_random_dataset_is_the_jax_datasets_bits():
    config = {"type": "RandomDataset", "tag_list": ["tag-3", "tag-4", "tag-5", "tag-6"],
              "asset": "gra", "resolution": "10T",
              "train_start_date": "2019-01-31T23:10:00+00:00",
              "train_end_date": "2019-02-01T08:00:00+00:00"}
    X, y, index = _get_dataset(dict(config)).get_data()
    want_X, want_y = jax_get_dataset(dict(config)).get_data()
    np.testing.assert_array_equal(X, want_X.to_numpy())
    np.testing.assert_array_equal(y, want_y.to_numpy())
    np.testing.assert_array_equal(index.astype(np.int64), _ns(want_X.index))
