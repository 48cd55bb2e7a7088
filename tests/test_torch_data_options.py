"""
The data-layer options of a machine config, the port's against the JAX
package's: ``row_filter`` (with ``row_filter_buffer_size``) against
``pandas_filter_rows``, ``filter_periods`` with the median filter and
its drop periods, the resample aggregations and multi-method lists, a
dataset with no ``resolution``, and the CSV file-system provider on the
same temporary files.

Tolerances: masks, timestamps, column names and drop periods exactly;
data 1e-12 (the same float64 arithmetic in another order).
"""

import numpy as np
import pandas as pd
import pytest

from gordo_tpu.data import _get_dataset as jax_get_dataset
from gordo_tpu.data.datasets import (
    InsufficientDataAfterRowFilteringError as JaxRowFilteringError,
)
from gordo_tpu.data.filter_periods import FilterPeriods as JaxFilterPeriods
from gordo_tpu.data.filter_rows import pandas_filter_rows
from gordo_tpu.data.providers import FileSystemProvider as JaxFileSystemProvider
from gordo_tpu.data.sensor_tag import SensorTag as JaxSensorTag
from gordo_tpu_torch.data import InsufficientDataAfterRowFilteringError, _get_dataset
from gordo_tpu_torch.data.filter_periods import FilterPeriods
from gordo_tpu_torch.data.filter_rows import filter_rows_mask
from gordo_tpu_torch.data.providers import FileSystemProvider, GordoBaseDataProvider
from gordo_tpu_torch.data.sensor_tag import SensorTag
from tests.test_torch_data import CONFTEST_DATASET, _ns

RTOL = ATOL = 1e-12

# -- row filters --------------------------------------------------------------


def _table():
    rng = np.random.default_rng(0)
    frame = pd.DataFrame({
        "Tag A": rng.normal(size=80),
        "b": rng.normal(size=80),
        "c": rng.random(80),
        "GRA-TEMP 1": rng.normal(loc=50, scale=10, size=80),
    })
    frame.iloc[[3, 40], 1] = np.nan
    return frame


EXPRESSIONS = [
    "`Tag A` > 0",
    "b < 0.5 & c > 0.2",
    "b < 0.5 and c > 0.2",
    "-1 < b < 1",
    "~(c > 0.5) | `Tag A` ** 2 > 1",
    "not c < 0.1 or b >= 1",
    "abs(b) > 0.3 & `GRA-TEMP 1` <= 55",
    "b * 2 + c % 0.3 >= 0.1",
    "(`Tag A` - b) / c != 2",
    "-`Tag A` > +0.5",
    "b + c",
    ["`Tag A` > -1", "c != 0.5", "`GRA-TEMP 1` > 40"],
]


@pytest.mark.parametrize("buffer_size", [0, 1, 3])
@pytest.mark.parametrize("expression", EXPRESSIONS, ids=[str(e) for e in EXPRESSIONS])
def test_row_filter_mask_equals_pandas(expression, buffer_size):
    frame = _table()
    want = pandas_filter_rows(frame, expression, buffer_size=buffer_size).index.to_numpy()
    got = filter_rows_mask(frame.to_numpy(), list(frame.columns), expression, buffer_size)
    np.testing.assert_array_equal(np.flatnonzero(got), want)


@pytest.mark.parametrize(
    "expression,part",
    [
        ("b.mean() > 0", "Call"),
        ("__import__('os').system('true')", "Call"),
        ("b if c else 1", "IfExp"),
        ("b > 'x'", "the constant 'x'"),
        ("b in c", "Compare"),
        ("(lambda: 1)()", "Call"),
        ("b[0] > 1", "Subscript"),
    ],
)
def test_row_filter_refuses_what_it_does_not_evaluate(expression, part):
    frame = _table()
    with pytest.raises(ValueError, match="row_filter") as err:
        filter_rows_mask(frame.to_numpy(), list(frame.columns), expression)
    assert expression in str(err.value) and part in str(err.value)


def test_row_filter_names_a_missing_column():
    frame = _table()
    with pytest.raises(ValueError, match="no column 'd'"):
        filter_rows_mask(frame.to_numpy(), list(frame.columns), "d > 1")


def test_row_filter_that_leaves_too_few_rows_raises_as_jax():
    config = dict(CONFTEST_DATASET, row_filter="`tag-0` > 2", row_filter_buffer_size=1)
    with pytest.raises(JaxRowFilteringError):
        jax_get_dataset(config).get_data()
    with pytest.raises(InsufficientDataAfterRowFilteringError, match="row filtering"):
        _get_dataset(config).get_data()


def _data_pair(config):
    """(port (X, y, index), port metadata, JAX (X, y), JAX metadata)."""
    port = _get_dataset(config)
    got = port.get_data()
    jax = jax_get_dataset(config)
    want = jax.get_data()
    return got, port.get_metadata(), want, jax.get_metadata()


def _assert_data_equal(got, want, got_meta, want_meta):
    (X, y, index), (want_X, want_y) = got, want
    assert X.shape == want_X.shape and y.shape == want_y.shape
    np.testing.assert_allclose(X, want_X.to_numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, want_y.to_numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(index.astype(np.int64), _ns(want_X.index))
    assert list(got_meta) == list(want_meta)
    # JAX keys the statistics of a multi-method frame by (tag, method)
    # tuples; the port by their flattened names, as JAX's x_hist is
    want_stats = {str(k) if isinstance(k, tuple) else k: v
                  for k, v in want_meta["summary_statistics"].items()}
    assert list(got_meta["summary_statistics"]) == list(want_stats)
    for tag, stats in want_stats.items():
        np.testing.assert_allclose(list(got_meta["summary_statistics"][tag].values()),
                                   list(stats.values()), rtol=RTOL, atol=ATOL, err_msg=tag)
    assert got_meta["x_hist"] == want_meta["x_hist"]


@pytest.mark.parametrize("buffer_size", [0, 2])
def test_dataset_row_filter_matches_jax(buffer_size):
    config = dict(CONFTEST_DATASET, row_filter=["`tag-0` > 0.2", "`tag-1` < 0.9"],
                  row_filter_buffer_size=buffer_size)
    got, got_meta, want, want_meta = _data_pair(config)
    assert len(got[0]) < len(_get_dataset(CONFTEST_DATASET).get_data()[0])
    _assert_data_equal(got, want, got_meta, want_meta)


# -- noisy periods ------------------------------------------------------------


def _noisy_frame():
    rng = np.random.default_rng(4)
    index = pd.date_range("2020-03-01", periods=600, freq="10min", tz="UTC")
    values = np.sin(np.arange(600)[:, None] / 30 + np.arange(3)) + 0.05 * rng.normal(
        size=(600, 3))
    values[[100, 101, 102, 350, 351, 500], 1] += 8.0  # two runs and a spike
    values[420, 2] -= 6.0
    return pd.DataFrame(values, index=index, columns=["a", "b", "c"])


@pytest.mark.parametrize("window,n_iqr", [(144, 5), (37, 3), (10, 1)])
def test_median_period_filter_matches_jax(window, n_iqr):
    frame = _noisy_frame()
    want_data, want_periods, want_pred = JaxFilterPeriods(
        granularity="10T", filter_method="median", window=window, n_iqr=n_iqr
    ).filter_data(frame)
    keep, periods, flags = FilterPeriods(
        granularity="10T", filter_method="median", window=window, n_iqr=n_iqr
    ).filter_data(frame.to_numpy(), _ns(frame.index))
    np.testing.assert_array_equal(flags["median"], want_pred["median"]["pred"].to_numpy() == -1)
    assert periods == want_periods and periods["median"]
    np.testing.assert_array_equal(_ns(frame.index[keep]), _ns(want_data.index))


@pytest.mark.parametrize("method", ["iforest", "all"])
def test_isolation_forest_filter_names_its_roadmap_item(method):
    """The forest methods are ported (they once raised naming their
    roadmap item): flags, drop periods and kept rows equal to JAX's, the
    scaled scores within 1e-12."""
    frame = _noisy_frame()
    jax_filter = JaxFilterPeriods(granularity="10T", filter_method=method)
    want_data, want_periods, want_pred = jax_filter.filter_data(frame)
    port_filter = FilterPeriods(granularity="10T", filter_method=method)
    keep, periods, flags = port_filter.filter_data(frame.to_numpy(), _ns(frame.index))
    assert set(flags) == set(want_pred)
    for name, flag in flags.items():
        np.testing.assert_array_equal(flag, want_pred[name]["pred"].to_numpy() == -1)
    np.testing.assert_allclose(port_filter.iforest_scores_, want_pred["iforest"]["score"],
                               rtol=0, atol=1e-12)
    assert periods == want_periods and periods["iforest"]
    np.testing.assert_array_equal(_ns(frame.index[keep]), _ns(want_data.index))


def test_dataset_period_filter_matches_jax():
    config = dict(CONFTEST_DATASET, filter_periods={"filter_method": "median", "window": 12,
                                                    "n_iqr": 1})
    got, got_meta, want, want_meta = _data_pair(config)
    assert got_meta["filtered_periods"] == want_meta["filtered_periods"]
    assert got_meta["filtered_periods"]["median"]
    _assert_data_equal(got, want, got_meta, want_meta)


# -- aggregations -------------------------------------------------------------

AGGREGATIONS = ["mean", "max", "min", "median", "sum", "count", "std", "first", "last",
                ["mean", "max"], ["median", "std", "count", "last"], ["max"]]


@pytest.mark.parametrize("methods", AGGREGATIONS, ids=[str(m) for m in AGGREGATIONS])
def test_aggregation_matches_jax(methods):
    config = dict(CONFTEST_DATASET, aggregation_methods=methods, resolution="30T",
                  target_tag_list=["tag-1", "tag-3"])
    port = _get_dataset(config)
    got = port.get_data()
    jax = jax_get_dataset(config)
    want = jax.get_data()
    assert [str(c) for c in want[0].columns] == [
        name for name in port.get_metadata()["x_hist"]]
    assert port.target_columns == [str(c) for c in want[1].columns]
    _assert_data_equal(got, want, port.get_metadata(), jax.get_metadata())


def test_callable_aggregation_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="callable.*ROADMAP.md queue 1 item 7"):
        _get_dataset(dict(CONFTEST_DATASET, aggregation_methods=np.mean))


# -- no resolution, the file-system provider ----------------------------------


def test_dataset_without_resolution_matches_jax():
    config = dict(CONFTEST_DATASET, tags=["tag-0"], target_tag_list=["tag-0"], resolution=None)
    got, got_meta, want, want_meta = _data_pair(config)
    assert len(got[0]) > 100
    _assert_data_equal(got, want, got_meta, want_meta)


def _write_lake(root):
    """CSV files for three tags in both layouts: per-year files (with a
    status column, bad statuses, a value that is not a number, a repeated
    timestamp whose later year file wins) and one file a tag."""
    rng = np.random.default_rng(8)
    stamps = pd.date_range("2019-12-30", "2020-01-03", freq="7min", tz="UTC")
    (root / "gra" / "tag-a").mkdir(parents=True)
    for year in (2019, 2020):
        part = stamps[stamps.year == year]
        if year == 2020:  # repeat the last 2019 stamp: the 2020 file's row wins
            part = stamps[stamps.year == 2019][-1:].append(part)
        status = rng.choice([0, 192, 1, 0], size=len(part))
        values = [repr(float(v)) for v in rng.normal(size=len(part))]
        values[3] = "n/a"
        lines = ["Time,Value,Status"] + [
            f"{t.isoformat()},{v},{s}" for t, v, s in zip(part, values, status)]
        (root / "gra" / "tag-a" / f"tag-a_{year}.csv").write_text("\n".join(lines) + "\n")
    for tag, fmt in (("tag-b", "%Y-%m-%d %H:%M:%S"), ("tag-c", "%Y-%m-%dT%H:%M:%S+00:00")):
        keep = stamps[rng.random(len(stamps)) < 0.9]
        lines = ["timestamp,reading"] + [
            f"{t.strftime(fmt)},{float(v)!r}" for t, v in zip(keep, rng.normal(size=len(keep)))]
        (root / "gra" / f"{tag}.csv").write_text("\n".join(lines) + "\n")


def test_file_system_provider_reads_what_jax_reads(tmp_path):
    _write_lake(tmp_path)
    start, end = pd.Timestamp("2019-12-31T06:00:00+00:00"), pd.Timestamp(
        "2020-01-02T18:00:00+00:00")
    names = ["tag-a", "tag-b", "tag-c"]
    want = list(JaxFileSystemProvider(base_dir=str(tmp_path)).load_series(
        start.to_pydatetime(), end.to_pydatetime(), [JaxSensorTag(n, "gra") for n in names]))
    got = list(FileSystemProvider(base_dir=str(tmp_path), threads=2).load_series(
        start.to_pydatetime(), end.to_pydatetime(), [SensorTag(n, "gra") for n in names]))
    for series, frame in zip(got, want):
        assert series.name == frame.name
        assert len(series) == len(frame) > 100
        np.testing.assert_array_equal(series.index, _ns(frame.index))
        np.testing.assert_allclose(series.values, frame.to_numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("provider", ["file-system", "lake"])
def test_file_system_dataset_matches_jax(provider, tmp_path, monkeypatch):
    """Through the provider named in the config, and through the lake
    directory of the environment (``data_provider: null``)."""
    _write_lake(tmp_path)
    if provider == "lake":
        monkeypatch.setenv("GORDO_TPU_LAKE_DIR", str(tmp_path))
    config = dict(CONFTEST_DATASET, type="TimeSeriesDataset", tags=["tag-a", "tag-b"],
                  target_tag_list=["tag-c"], train_start_date="2019-12-31T00:00:00+00:00",
                  train_end_date="2020-01-02T12:00:00+00:00",
                  data_provider=None if provider == "lake" else {
                      "type": "FileSystemProvider", "base_dir": str(tmp_path)})
    got, got_meta, want, want_meta = _data_pair(config)
    assert got_meta["tag_loading_metadata"] == want_meta["tag_loading_metadata"]
    _assert_data_equal(got, want, got_meta, want_meta)


def test_file_system_provider_round_trips_the_jax_type(tmp_path):
    provider = FileSystemProvider(base_dir=str(tmp_path), threads=3)
    want = JaxFileSystemProvider(base_dir=str(tmp_path), threads=3).to_dict()
    assert provider.to_dict() == want
    again = GordoBaseDataProvider.from_dict(want)
    assert isinstance(again, FileSystemProvider) and again.threads == 3


def test_parquet_files_are_refused_not_skipped(tmp_path):
    """The JAX provider reads a parquet file before a CSV one; the port
    says it cannot (no pyarrow) rather than read the CSV beside it."""
    _write_lake(tmp_path)
    (tmp_path / "gra" / "tag-b.parquet").write_bytes(b"PAR1")
    provider = FileSystemProvider(base_dir=str(tmp_path))
    start = pd.Timestamp("2020-01-01T00:00:00+00:00").to_pydatetime()
    with pytest.raises(NotImplementedError, match="pyarrow"):
        list(provider.load_series(start, start + pd.Timedelta(days=1),
                                  [SensorTag("tag-b", "gra")]))


def test_raw_join_of_csv_tags_matches_jax(tmp_path):
    """No resolution over CSV tags that share timestamps: the inner join
    on raw timestamps, as JAX's ``pd.concat(join="inner")``."""
    _write_lake(tmp_path)
    config = dict(CONFTEST_DATASET, type="TimeSeriesDataset", tags=["tag-b", "tag-c"],
                  target_tag_list=["tag-b"], resolution=None,
                  train_start_date="2019-12-31T00:00:00+00:00",
                  train_end_date="2020-01-02T00:00:00+00:00",
                  data_provider={"type": "FileSystemProvider", "base_dir": str(tmp_path)})
    got, got_meta, want, want_meta = _data_pair(config)
    assert len(got[0]) > 100
    _assert_data_equal(got, want, got_meta, want_meta)


def test_chip_smoke_options_machine_reads_and_fetches_as_jax(tmp_path):
    """``chip_smoke.py`` phase 12's machine: its YAML project read by the
    port's config layer as the JAX package's ``NormalizedConfig`` reads
    it, and its CSV lake (the row filter, the median period filter and
    the max aggregation over the config's span) fetched as the JAX data
    layer fetches it."""
    import json

    import chip_smoke
    from gordo_tpu.workflow.config_elements.normalized_config import NormalizedConfig
    from gordo_tpu.workflow.workflow_generator import get_dict_from_yaml

    lake = str(tmp_path / "lake")
    chip_smoke.write_options_lake(lake)
    machine, feedforward = chip_smoke.options_machines(lake)
    text = chip_smoke.OPTIONS_PROJECT.format(
        name=machine["name"], lake=lake, tags=", ".join(chip_smoke.TAGS),
        epochs=chip_smoke.OPTIONS_EPOCHS, metrics=", ".join(chip_smoke.OPTIONS_METRICS))
    path = tmp_path / "project.yaml"
    path.write_text(text)
    (want,) = NormalizedConfig(get_dict_from_yaml(str(path)),
                               project_name=chip_smoke.PROJECT).machines
    assert machine == json.loads(json.dumps(want.to_dict(), default=str))
    got, got_meta, want_data, want_meta = _data_pair(machine["dataset"])
    assert len(got[0]) < got_meta["tag_loading_metadata"]["aggregate_metadata"]["joined_length"]
    assert got_meta["filtered_periods"] == want_meta["filtered_periods"]
    assert got_meta["filtered_periods"]["median"]
    _assert_data_equal(got, want_data, got_meta, want_meta)
    assert feedforward["dataset"]["aggregation_methods"] == ["mean", "max"]


#: dataset options built end to end by both builders (CV scores and
#: thresholds rtol 1e-4)
BUILD_DATASETS = {
    "filters-and-max": dict(row_filter="`tag-0` > 0.1", row_filter_buffer_size=1,
                            filter_periods={"filter_method": "median", "window": 12,
                                            "n_iqr": 1},
                            aggregation_methods="max"),
    "mean-and-max": dict(aggregation_methods=["mean", "max"]),
    "no-resolution": dict(tags=["tag-2"], target_tag_list=["tag-2"], resolution=None),
    "csv-lake": dict(type="TimeSeriesDataset", tags=["tag-a", "tag-b", "tag-c"],
                     target_tag_list=["tag-a", "tag-b", "tag-c"],
                     train_start_date="2019-12-31T00:00:00+00:00",
                     train_end_date="2020-01-02T12:00:00+00:00"),
}


@pytest.mark.parametrize("case", sorted(BUILD_DATASETS))
def test_dataset_options_build_as_jax(case, tmp_path):
    """The conftest detector machine (shuffle off, the JAX init) built
    over each dataset option by the port's and the JAX package's
    ``ModelBuilder``: the same rows, CV scores and thresholds within rtol
    1e-4 (JAX's own ``build`` of a multi-method machine then fails writing
    tuple keys into its metadata file; the model and metadata are built)."""
    from gordo_tpu.builder.build_model import ModelBuilder as JaxModelBuilder
    from gordo_tpu.machine import Machine as JaxMachine
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.models import AutoEncoder
    from tests.test_torch_evaluation import _conftest_machine
    from tests.test_torch_pipeline import _jax_initial_state

    machine = _conftest_machine({"cv_mode": "full_build"}, None)
    machine["dataset"].update(BUILD_DATASETS[case])
    if case == "csv-lake":
        _write_lake(tmp_path)
        machine["dataset"]["data_provider"] = {"type": "FileSystemProvider",
                                               "base_dir": str(tmp_path)}
    jax_model, jax_machine = JaxModelBuilder(
        JaxMachine.from_config(dict(machine), project_name=machine["project_name"])).build()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AutoEncoder, "_initial_state", _jax_initial_state)
        model, port_machine = ModelBuilder(machine).build(device="cpu")
    got, want = (m.to_dict()["metadata"]["build_metadata"]
                 for m in (port_machine, jax_machine))
    assert got["model"]["model_offset"] == want["model"]["model_offset"]
    scores, want_scores = (meta["model"]["cross_validation"]["scores"] for meta in (got, want))
    assert set(scores) == set(want_scores)
    for name, stats in want_scores.items():
        for stat, value in stats.items():
            np.testing.assert_allclose(scores[name][stat], value, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name} {stat}")
    np.testing.assert_allclose(model.aggregate_threshold_, jax_model.aggregate_threshold_,
                               rtol=1e-4)
    np.testing.assert_allclose(model.feature_thresholds_,
                               jax_model.feature_thresholds_.to_numpy(), rtol=1e-4)
