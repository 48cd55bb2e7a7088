"""
The port's data-parallel trainer (``parallel/data_parallel.py``) against
the JAX package's on 2 gloo ranks (JAX on 2 virtual CPU devices): a
feedforward hourglass and a small causal Transformer (flash attention in
the port, whose plain version runs on the CPU; dense in JAX, the same
arithmetic), from the same Flax weights (``convert.state_dict_from_flax``)
on the same seeded global batch. ZeRO-1 against replicated training, and
both against JAX's trainer over 3 steps: losses and parameters, rtol
1e-4 (atol 1e-6). The Transformer's key biases are held apart, as in
``tests/test_torch_long_context.py``: their gradient is 0 in exact
arithmetic, so Adam moves them by rounding only, within its learning
rate a step.
"""

import jax
import numpy as np
import pytest

from gordo_tpu.models.factories.feedforward import feedforward_hourglass as jax_hourglass
from gordo_tpu.models.factories.transformer import transformer_model as jax_transformer
from gordo_tpu.parallel.data_parallel import DataParallelTrainer as JaxDataParallelTrainer
from gordo_tpu.parallel.mesh import DATA_AXIS
from gordo_tpu.parallel.mesh import get_device_mesh as jax_mesh
from gordo_tpu_torch.convert import feedforward_state_dict, transformer_state_dict
from tests.torch_distributed_helpers import run_cluster

RTOL = 1e-4
WORLD, STEPS, N_FEATURES, LOOKBACK = 2, 3, 3, 8
TRANSFORMER = dict(n_features=N_FEATURES, lookback_window=LOOKBACK, d_model=16, n_heads=2,
                   n_layers=1)


def _batches():
    rng = np.random.default_rng(11)
    ff = rng.standard_normal((16, N_FEATURES)).astype(np.float32)
    windows = rng.standard_normal((8, LOOKBACK, N_FEATURES)).astype(np.float32)
    targets = rng.standard_normal((8, N_FEATURES)).astype(np.float32)
    return {"feedforward": (ff, ff), "transformer": (windows, targets)}


def _jax_run(model, zero1):
    spec = (jax_hourglass(n_features=N_FEATURES) if model == "feedforward"
            else jax_transformer(attention_impl="dense", **TRANSFORMER))
    convert = feedforward_state_dict if model == "feedforward" else transformer_state_dict
    x, y = _batches()[model]
    trainer = JaxDataParallelTrainer(spec, jax_mesh(shape=(WORLD,), axis_names=(DATA_AXIS,)),
                                     axis=DATA_AXIS, zero1=zero1)
    params, opt_state = trainer.init(jax.random.PRNGKey(5), x)
    start = convert(jax.device_get(params))
    xb, yb = trainer.shard_batch(x), trainer.shard_batch(y)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = trainer.train_step(params, opt_state, xb, yb)
        losses.append(float(loss))
    return start, np.array(losses), convert(jax.device_get(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {(model, zero1): _jax_run(model, zero1)
                for model in ("feedforward", "transformer") for zero1 in (False, True)}
    inputs = {}
    for model, (x, y) in _batches().items():
        inputs[f"{model}.x"], inputs[f"{model}.y"] = x, y
        inputs.update({f"{model}.param.{k}": v for k, v in jax_runs[(model, False)][0].items()})
    outs = run_cluster(
        "data_parallel", WORLD, tmp_path_factory.mktemp("dp"),
        {"n_features": N_FEATURES, "steps": STEPS,
         "transformer": dict(TRANSFORMER, attention_impl="flash", dropout=0.0)},
        inputs)
    return jax_runs, outs


@pytest.mark.parametrize("model", ("feedforward", "transformer"))
@pytest.mark.parametrize("zero1", (False, True))
def test_steps_match_jax(runs, model, zero1):
    jax_runs, outs = runs
    start, losses, params = jax_runs[(model, zero1)]
    tag = f"{model}-{int(zero1)}"
    bound = STEPS * 1e-3 * (1 + 1e-3)
    for rank, got in enumerate(outs):
        np.testing.assert_allclose(got[f"{tag}-losses"], losses, rtol=RTOL,
                                   err_msg=f"rank {rank}")
        for name, want in params.items():
            value = got[f"{tag}-param.{name}"]
            if name.endswith("attn.key.bias"):
                assert np.abs(value - start[name]).max() <= bound
                continue
            np.testing.assert_allclose(value, want, rtol=RTOL, atol=1e-6,
                                       err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("model", ("feedforward", "transformer"))
def test_zero1_trains_as_replicated(runs, model):
    _, outs = runs
    for got in outs:
        np.testing.assert_allclose(got[f"{model}-1-losses"], got[f"{model}-0-losses"],
                                   rtol=1e-6)
        for key in got:
            if key.startswith(f"{model}-0-param."):
                np.testing.assert_allclose(got[key.replace("-0-", "-1-")], got[key],
                                           rtol=1e-6, atol=1e-7)


def test_zero1_refuses_a_leafwise_optimizer():
    from gordo_tpu_torch.models.factories.feedforward import feedforward_hourglass

    class _Mesh:
        mesh_dim_names = (DATA_AXIS,)
        shape = (1,)

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    from gordo_tpu_torch.parallel.data_parallel import DataParallelTrainer

    spec = feedforward_hourglass(n_features=N_FEATURES, optimizer="lamb")
    with pytest.raises(ValueError, match="zero1 shards element-wise optimizer state"):
        DataParallelTrainer(spec, _Mesh(), zero1=True, device="cpu")
    DataParallelTrainer(spec, _Mesh(), zero1=False, device="cpu")
