"""
The port's ``LongFormatProvider`` and ``CompoundProvider``
(``gordo_tpu_torch.data.providers``) against the JAX package's on the same
seeded lakes: every series index for index (int64 ns) and value for value
(exactly), over a partitioned lake, an unpartitioned one, an asset level,
the one-day slop on each side, duplicated timestamps (the last row wins,
later files too), a missing tag, no files, a lake whose files fall outside
the window, unreadable times and parquet; the compound provider's tag
dispatch and its refusal; and a dataset built from a compound config
(the long-format lake beside a file-system directory) against JAX's.
"""

import logging
from datetime import datetime, timezone

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.data import _get_dataset as jax_get_dataset
from gordo_tpu.data.providers.compound import CompoundProvider as JaxCompoundProvider
from gordo_tpu.data.providers import LongFormatProvider as JaxLongFormatProvider
from gordo_tpu.data.providers.compound import NoSuitableDataProviderError as JaxNoSuitable
from gordo_tpu.data.sensor_tag import SensorTag as JaxSensorTag
from gordo_tpu_torch.data import _get_dataset
from gordo_tpu_torch.data.providers import (
    CompoundProvider,
    DataLakeProvider,
    GordoBaseDataProvider,
    LongFormatProvider,
    NoSuitableDataProviderError,
)
from gordo_tpu_torch.data.providers.longformat import parse_time
from gordo_tpu_torch.data.sensor_tag import SensorTag
from tests.test_torch_data import _ns

START = datetime(2019, 1, 1, tzinfo=timezone.utc)
END = datetime(2019, 1, 3, tzinfo=timezone.utc)
TAGS = [("GRA-A", "gra"), ("GRA-B", "gra"), ("GRA-C", "gra")]


def _long_frame(tags, periods, start, seed, freq="1h"):
    rng = np.random.default_rng(seed)
    index = pd.date_range(start, periods=periods, freq=freq, tz="UTC")
    return pd.DataFrame([{"tag": tag, "time": ts, "value": value}
                         for tag in tags for ts, value in zip(index, rng.random(periods))])


def _write(frame, path, **kwargs):
    path.parent.mkdir(parents=True, exist_ok=True)
    frame.to_csv(path, index=False, **kwargs)


def _pair(base_dir, tags=TAGS, start=START, end=END):
    """(port series, JAX series) of ``tags`` from the same lake."""
    port = list(LongFormatProvider(base_dir=str(base_dir)).load_series(
        start, end, [SensorTag(*t) for t in tags]))
    jax = list(JaxLongFormatProvider(base_dir=str(base_dir)).load_series(
        start, end, [JaxSensorTag(*t) for t in tags]))
    return port, jax


def _assert_same(port, jax):
    assert [s.name for s in port] == [s.name for s in jax]
    for got, want in zip(port, jax):
        np.testing.assert_array_equal(got.index, _ns(want.index) if len(want) else [],
                                      err_msg=got.name)
        np.testing.assert_array_equal(got.values, want.to_numpy(dtype=np.float64),
                                      err_msg=got.name)


def _partitioned(root, days=(1, 2), tags=("GRA-A", "GRA-B")):
    for day in days:
        _write(_long_frame(list(tags), 24, f"2019-01-{day:02d}", day),
               root / "2019" / "01" / f"{day:02d}" / "readings.csv")
    return root


def test_partitioned_lake(tmp_path):
    _partitioned(tmp_path)
    port, jax = _pair(tmp_path, TAGS[:2])
    _assert_same(port, jax)
    assert [len(s) for s in port] == [48, 48]


def test_unpartitioned_lake_with_extra_columns_and_any_case(tmp_path):
    frame = _long_frame(["GRA-A", "GRA-B"], 60, "2018-12-31T12:00", 5, freq="37min")
    frame = frame.rename(columns={"tag": "TAG", "time": "Time", "value": "VaLuE"})
    frame["quality"] = "good"
    _write(frame, tmp_path / "flat.csv")
    port, jax = _pair(tmp_path, TAGS[:2])
    _assert_same(port, jax)
    assert 0 < len(port[0]) < 60  # the window cut both ends


def test_asset_level_and_base_fallback(tmp_path):
    _partitioned(tmp_path / "gra", tags=("GRA-A",))
    _write(_long_frame(["OTHER-1"], 30, "2019-01-01", 7), tmp_path / "top.csv")
    tags = [("GRA-A", "gra"), ("OTHER-1", "nowhere")]
    port, jax = _pair(tmp_path, tags)
    _assert_same(port, jax)
    assert [len(s) for s in port] == [48, 30]
    provider = LongFormatProvider(base_dir=str(tmp_path))
    jax_provider = JaxLongFormatProvider(base_dir=str(tmp_path))
    for name, asset in [("GRA-A", "gra"), ("X", None), ("X", "missing")]:
        assert provider.can_handle_tag(SensorTag(name, asset)) == jax_provider.can_handle_tag(
            JaxSensorTag(name, asset))


def test_one_day_of_slop_on_each_side(tmp_path):
    """A partition of the day before the window and one of the day after
    it hold rows inside it; a partition two days out is not read."""
    _write(_long_frame(["GRA-Z"], 6, "2019-01-01", 3), tmp_path / "2018" / "12" / "31" / "a.csv")
    _write(_long_frame(["GRA-Z"], 4, "2019-01-02T20:00:00", 4),
           tmp_path / "2019" / "01" / "03" / "a.csv")
    _write(_long_frame(["GRA-Z"], 5, "2019-01-01T03:00:00", 9),
           tmp_path / "2018" / "12" / "30" / "a.csv")
    port, jax = _pair(tmp_path, [("GRA-Z", "gra")])
    _assert_same(port, jax)
    assert len(port[0]) == 10


def test_duplicates_keep_the_last_row_and_later_files_win(tmp_path):
    first = _long_frame(["GRA-A"], 10, "2019-01-01", 1)
    dup = first.iloc[[2, 2, 5]].copy()
    dup["value"] = [7.0, 8.0, 9.0]
    _write(pd.concat([first, dup]), tmp_path / "2019" / "01" / "01" / "a.csv")
    later = first.iloc[[5, 6]].copy()
    later["value"] = [-1.0, -2.0]
    _write(later, tmp_path / "2019" / "01" / "01" / "b.csv")
    port, jax = _pair(tmp_path, [("GRA-A", "gra")])
    _assert_same(port, jax)
    assert len(port[0]) == 10 and list(port[0].values[[2, 5, 6]]) == [8.0, -1.0, -2.0]


def test_values_that_are_not_numbers_drop_their_rows(tmp_path):
    frame = _long_frame(["GRA-A"], 8, "2019-01-01", 2).astype({"value": object})
    frame.loc[[1, 4], "value"] = ["n/a", ""]
    _write(frame, tmp_path / "x.csv")
    port, jax = _pair(tmp_path, [("GRA-A", "gra")])
    _assert_same(port, jax)
    assert len(port[0]) == 6


def test_missing_tag_yields_an_empty_series_and_a_warning(tmp_path, caplog):
    _partitioned(tmp_path)
    with caplog.at_level(logging.WARNING):
        port, jax = _pair(tmp_path, [("GRA-A", "gra"), ("GRA-NONE", "gra")])
    _assert_same(port, jax)
    assert len(port[1]) == 0
    assert "No data found for tag GRA-NONE" in caplog.text


def test_no_files_raises_and_files_outside_the_window_only_warn(tmp_path, caplog):
    for provider in (LongFormatProvider(base_dir=str(tmp_path)),
                     JaxLongFormatProvider(base_dir=str(tmp_path))):
        with pytest.raises(FileNotFoundError, match="No long-format files"):
            list(provider.load_series(START, END, [SensorTag("GRA-A", "gra")]))
    _partitioned(tmp_path, days=(1,))
    later = (datetime(2019, 3, 1, tzinfo=timezone.utc), datetime(2019, 3, 2, tzinfo=timezone.utc))
    with caplog.at_level(logging.WARNING):
        port, jax = _pair(tmp_path, TAGS[:1], *later)
    _assert_same(port, jax)
    assert len(port[0]) == 0 and "No long-format files under" in caplog.text


@pytest.mark.parametrize("text", ["2019-01-01 06:00:00+00:00", "2019-01-01T06:00:00Z",
                                  "2019-01-01T07:30:00+01:30", "2019-01-01 06:00:00",
                                  "2019-01-01T06:00:00.250000+00:00"])
def test_iso_times_read_as_pandas_reads_them(text):
    assert parse_time(text) == pd.to_datetime(pd.Series([text]), utc=True).iloc[0].value


@pytest.mark.parametrize("text", ["01/02/2019 06:00", "yesterday", "2019-13-01"])
def test_other_times_raise_naming_the_value(tmp_path, text):
    pd.DataFrame({"tag": ["GRA-A"], "time": [text], "value": [1.0]}).to_csv(
        tmp_path / "x.csv", index=False)
    with pytest.raises(ValueError, match=repr(text).replace("/", ".")):
        list(LongFormatProvider(base_dir=str(tmp_path)).load_series(
            START, END, [SensorTag("GRA-A", "gra")]))


def test_bad_schema_raises_as_jax(tmp_path):
    pd.DataFrame({"a": [1]}).to_csv(tmp_path / "bad.csv", index=False)
    for provider in (LongFormatProvider(base_dir=str(tmp_path)),
                     JaxLongFormatProvider(base_dir=str(tmp_path))):
        with pytest.raises(ValueError, match=r"lacks long-format columns \['tag', 'time', 'value'\]"):
            list(provider.load_series(START, END, [SensorTag("GRA-A", "gra")]))


def test_parquet_raises_naming_pyarrow(tmp_path):
    _long_frame(["GRA-A"], 5, "2019-01-01", 0).to_parquet(tmp_path / "r.parquet")
    provider = LongFormatProvider(base_dir=str(tmp_path))
    assert provider.can_handle_tag(SensorTag("GRA-A", "gra"))
    with pytest.raises(NotImplementedError, match="pyarrow"):
        list(provider.load_series(START, END, [SensorTag("GRA-A", "gra")]))


def test_csv_values_read_as_pandas_reads_them(tmp_path):
    """Both CSV providers read a value as pandas' C parser does, which is
    not always the float nearest the text (``float`` is): 17-digit reprs
    of seeded values, the JAX providers' series equal bit for bit."""
    from gordo_tpu.data.providers import FileSystemProvider as JaxFileSystemProvider
    from gordo_tpu_torch.data.providers import FileSystemProvider

    frame = _long_frame(["GRA-A"], 400, "2019-01-01", 8, freq="5min")
    frame["value"] = frame["value"] * 1e3 - 400
    _write(frame, tmp_path / "long" / "x.csv")
    _assert_same(*_pair(tmp_path / "long", [("GRA-A", "gra")]))
    _write(frame[["time", "value"]].rename(columns={"time": "Time", "value": "Value"}),
           tmp_path / "fs" / "GRA-A.csv")
    got = list(FileSystemProvider(base_dir=str(tmp_path / "fs")).load_series(
        START, END, [SensorTag("GRA-A", "gra")]))
    want = list(JaxFileSystemProvider(base_dir=str(tmp_path / "fs")).load_series(
        START, END, [JaxSensorTag("GRA-A", "gra")]))
    _assert_same(got, want)
    assert len(got[0]) == 400


# -- the compound provider ------------------------------------------------------


def _fs_dir(root, tag, seed):
    """The file-system provider's layout: <root>/<tag>.csv."""
    index = pd.date_range("2019-01-01", periods=40, freq="1h", tz="UTC")
    values = np.random.default_rng(seed).random(40)
    root.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({"Time": index, "Value": values}).to_csv(root / f"{tag}.csv", index=False)
    return root


def _compound_lakes(tmp_path):
    long_dir = _partitioned(tmp_path / "long", tags=("GRA-A", "GRA-C"))
    fs_dir = _fs_dir(tmp_path / "fs", "GRA-B", 11)
    return [{"type": "FileSystemProvider", "base_dir": str(fs_dir)},
            {"type": "LongFormatProvider", "base_dir": str(long_dir)}]


def test_compound_dispatches_each_tag_to_the_first_provider_that_claims_it(tmp_path):
    configs = _compound_lakes(tmp_path)
    port = CompoundProvider(providers=configs)
    jax = JaxCompoundProvider(providers=configs)
    tags = [("GRA-A", "gra"), ("GRA-B", "gra"), ("GRA-C", "gra")]
    got = list(port.load_series(START, END, [SensorTag(*t) for t in tags]))
    want = list(jax.load_series(START, END, [JaxSensorTag(*t) for t in tags]))
    _assert_same(got, want)
    assert [s.name for s in got] == ["GRA-A", "GRA-C", "GRA-B"]  # grouped by provider
    assert [type(p).__name__ for p in port.providers] == ["FileSystemProvider",
                                                          "LongFormatProvider"]
    # the long-format provider claims every tag of a directory holding data:
    # listed first it would take GRA-B too, and find no rows for it
    swapped = list(CompoundProvider(providers=configs[::-1]).load_series(
        START, END, [SensorTag("GRA-B", "gra")]))
    assert len(swapped[0]) == 0
    assert port.to_dict() == {"providers": configs,
                              "type": "gordo_tpu.data.providers.compound.CompoundProvider"}
    assert GordoBaseDataProvider.from_dict(port.to_dict()).to_dict() == port.to_dict()


def test_compound_refuses_a_tag_no_provider_claims(tmp_path):
    configs = [{"type": "FileSystemProvider", "base_dir": str(_fs_dir(tmp_path, "GRA-B", 1))}]
    for provider, tag, error in ((CompoundProvider(providers=configs), SensorTag,
                                  NoSuitableDataProviderError),
                                 (JaxCompoundProvider(providers=configs), JaxSensorTag,
                                  JaxNoSuitable)):
        with pytest.raises(error, match="No provider can handle tag"):
            list(provider.load_series(START, END, [tag("GRA-Q", "gra")]))


def test_data_lake_provider_is_a_compound_provider(tmp_path):
    lake = DataLakeProvider(base_dir=str(_fs_dir(tmp_path, "GRA-B", 2)), storename="x")
    assert isinstance(lake, CompoundProvider)
    assert lake.to_dict() == {"base_dir": str(tmp_path), "threads": 10, "storename": "x",
                              "type": "gordo_tpu.data.providers.compound.DataLakeProvider"}
    with pytest.raises(NoSuitableDataProviderError):
        list(lake.load_series(START, END, [SensorTag("GRA-Q", "gra")]))


def test_dataset_over_a_compound_lake_matches_jax(tmp_path):
    config = {
        "type": "TimeSeriesDataset",
        "tags": ["GRA-A", "GRA-B", "GRA-C"],
        "target_tag_list": ["GRA-B"],
        "train_start_date": "2019-01-01T00:00:00+00:00",
        "train_end_date": "2019-01-02T12:00:00+00:00",
        "asset": "gra",
        "resolution": "2h",
        "data_provider": {"type": "gordo_tpu.data.providers.compound.CompoundProvider",
                          "providers": _compound_lakes(tmp_path)},
    }
    port = _get_dataset(config)
    X, y, index = port.get_data()
    jax = jax_get_dataset(config)
    want_X, want_y = jax.get_data()
    np.testing.assert_array_equal(index.astype(np.int64), _ns(want_X.index))
    np.testing.assert_allclose(X, want_X.to_numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, want_y.to_numpy(), rtol=1e-12, atol=1e-12)
    assert port.to_dict()["data_provider"] == jax.to_dict()["data_provider"]
