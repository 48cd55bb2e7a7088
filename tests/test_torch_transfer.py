"""
Host-to-device transfer pipelining (``gordo_tpu_torch.parallel.transfer``)
against the JAX package's: ``prefetch_iter``'s order of puts and uses,
its values and its (plane, mode) counts with a numpy ``put``;
``device_put_sliced``; a ``FleetTrainer`` fit at depth 2 against depth 0
(the same bits); and ``build-fleet --prefetch-depth 2``, which the port
no longer refuses, against a depth-0 build (the same artifacts' arrays).
On the CPU a staged put is the plain copy; the card's pinned, side-stream
copies are checked by ``chip_smoke.py`` phase 12.
"""

import collections
import json

import numpy as np
import pytest
import torch

from gordo_tpu.parallel import transfer as jax_transfer
from gordo_tpu_torch.cli import cli
from gordo_tpu_torch.models import AutoEncoder
from gordo_tpu_torch.parallel import transfer
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData
from tests.test_torch_fleet import FEEDFORWARD, SEEDS, _rows
from tests.test_torch_fleet_env import fleet_env  # noqa: F401

torch.set_num_threads(1)


def _logged_run(module, depth, monkeypatch):
    """(events, yielded values, (plane, mode) counts) of one prefetch_iter
    walk over five arrays with a numpy put that logs each put, the consumer
    logging each use."""
    events, counts = [], collections.Counter()
    monkeypatch.setattr(module, "count_transfer",
                        lambda plane, mode, n=1: counts.update({(plane, mode): n}))

    def put(item):
        events.append(("put", int(item[0])))
        return np.asarray(item) * 2

    values = []
    for value in module.prefetch_iter([np.arange(3) + 10 * i for i in range(5)], depth=depth,
                                      plane="train", put=put):
        events.append(("use", int(value[0]) // 2))
        values.append(value)
    return events, values, dict(counts)


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 8, 12])
def test_prefetch_iter_matches_jax(depth, monkeypatch):
    got = _logged_run(transfer, depth, monkeypatch)
    want = _logged_run(jax_transfer, depth, monkeypatch)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


def test_env_prefetch_depth_matches_jax(monkeypatch):
    for raw in (None, "", "3", " 5 ", "-2", "40", "x"):
        if raw is None:
            monkeypatch.delenv("GORDO_PREFETCH_DEPTH", raising=False)
        else:
            monkeypatch.setenv("GORDO_PREFETCH_DEPTH", raw)
        assert transfer.env_prefetch_depth(1) == jax_transfer.env_prefetch_depth(1), raw
    assert transfer.MAX_PREFETCH_DEPTH == jax_transfer.MAX_PREFETCH_DEPTH


@pytest.mark.parametrize("depth,mode,n", [(0, "direct", 1), (2, "prefetched", 3),
                                          (9, "prefetched", 9)])
def test_device_put_sliced_moves_bytes_not_math(depth, mode, n):
    array = np.random.default_rng(0).normal(size=(11, 7, 3)).astype(np.float32)
    transfer.reset_transfer_counts()
    got = transfer.device_put_sliced(array, depth, plane="build", device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), array)
    assert transfer.transfer_counts == {("build", mode): n}


def _fleet_fit(depth):
    """A ragged three-machine fleet (the last steps of an epoch gate the
    shorter machines) with early stopping read in chunks of two epochs
    (a patience no machine runs out of, so all seven epochs run)."""
    Xs = _rows([61, 29, 47])
    est = AutoEncoder(**FEEDFORWARD, n_features=4, n_features_out=4)
    trainer = FleetTrainer(est._build_spec(), device="cpu", epoch_chunk=2, prefetch_depth=depth)
    transfer.reset_transfer_counts()
    data = StackedData.from_ragged(Xs, Xs, device="cpu", prefetch_depth=depth)
    params, losses = trainer.fit(data, seeds=SEEDS, epochs=7, batch_size=8,
                                 early_stopping_patience=10, restore_best_weights=True)
    return params, losses, dict(transfer.transfer_counts), trainer.fit_telemetry_["epochs_run"]


def test_fleet_fit_at_depth_2_equals_depth_0_bitwise():
    params0, losses0, counts0, epochs0 = _fleet_fit(0)
    params2, losses2, counts2, epochs2 = _fleet_fit(2)
    np.testing.assert_array_equal(losses2, losses0)
    assert all(torch.equal(params2[name], params0[name]) for name in params0)
    assert counts0 == {}  # depth 0 copies as the trainer always did, uncounted
    assert epochs2 == epochs0 == 7
    # X, y and the weights in three slices each; the first chunk's vector
    # on the critical path, each of the three later ones staged under the
    # chunk before it
    assert counts2 == {("build", "prefetched"): 9, ("train", "direct"): 1,
                       ("train", "prefetched"): 3}


FLEET = """
- name: transfer-pump-0
  project_name: transfer-fleet
  dataset:
    type: RandomDataset
    tags: [tag-0, tag-1, tag-2]
    train_start_date: '2019-01-01T00:00:00+00:00'
    train_end_date: '2019-01-02T00:00:00+00:00'
    asset: gra
  model:
    gordo_tpu.models.AutoEncoder: {kind: feedforward_hourglass, epochs: 2, batch_size: 16}
- name: transfer-pump-1
  project_name: transfer-fleet
  dataset:
    type: RandomDataset
    tags: [tag-3, tag-4, tag-5]
    train_start_date: '2019-01-01T00:00:00+00:00'
    train_end_date: '2019-01-02T00:00:00+00:00'
    asset: gra
  model:
    gordo_tpu.models.AutoEncoder: {kind: feedforward_hourglass, epochs: 2, batch_size: 16}
- name: transfer-pump-2
  project_name: transfer-fleet
  dataset:
    type: RandomDataset
    tags: [tag-6, tag-7, tag-8]
    train_start_date: '2019-01-01T00:00:00+00:00'
    train_end_date: '2019-01-02T00:00:00+00:00'
    asset: gra
  model:
    gordo_tpu.models.AutoEncoder: {kind: feedforward_hourglass, epochs: 2, batch_size: 16}
"""


def test_build_fleet_prefetch_depth_2_is_taken_and_changes_no_bits(tmp_path, fleet_env):
    """Three machines of ragged lengths in one bucket: the stacked data
    moves in three slices of the machine axis (as in JAX, an axis no
    longer than the depth moves in one copy), and each of the four fleet
    fits (three CV folds, the final fit) stages its one chunk's vector."""
    for depth in ("0", "2"):
        code = cli.main(["build-fleet", FLEET, str(tmp_path / depth), "--device", "cpu",
                         "--prefetch-depth", depth])
        assert code == 0
    report = json.loads((tmp_path / "2" / "telemetry_report.json").read_text())
    assert report["prefetch_depth"] == 2
    assert report["transfers"] == {"build/prefetched": 9, "train/direct": 4}
    assert json.loads((tmp_path / "0" / "telemetry_report.json").read_text())["transfers"] == {}
    for name in ("transfer-pump-0", "transfer-pump-1", "transfer-pump-2"):
        with np.load(tmp_path / "0" / name / "params.npz") as a, \
                np.load(tmp_path / "2" / name / "params.npz") as b:
            assert a.files == b.files
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_build_fleet_refuses_a_depth_above_the_ceiling(capsys, fleet_env):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["build-fleet", "[]", "/nonexistent", "--device", "cpu",
                  "--prefetch-depth", "9"])
    assert exit_info.value.code == 2
    assert "--prefetch-depth must be in 0..8" in capsys.readouterr().err
