"""
The port's long-context trainer (``parallel/long_context.py``) against the
JAX package's on 2 gloo ranks (JAX on 2 virtual CPU devices): the same
Flax weights (carried across by ``convert.transformer_state_dict``) and
the same seeded windows; the loss of each of 3 steps and the parameters
after them, rtol 1e-4 (atol 1e-6), with ring and with Ulysses attention.
The keys' biases are held apart: attention's softmax does not change when
a row's scores all shift by one number, so their gradient is 0 in exact
arithmetic, and Adam turns the rounding left in it (1e-9) into steps of
up to the learning rate in either package; both must stay within the
learning rate times the steps of the start. The
rematerialised sharded twin trains to the same numbers as the plain one
(and a rematerialised net under ``functional_call`` takes the gradients
of the parameters it was given),
the local twin predicts with the trained parameters, and the twins share
their parameter names (so one tree loads either).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.parallel.long_context import LongContextTrainer as JaxLongContextTrainer
from gordo_tpu.parallel.mesh import get_device_mesh as jax_mesh
from gordo_tpu.parallel.sequence import SEQ_AXIS
from gordo_tpu_torch.convert import transformer_state_dict
from gordo_tpu_torch.parallel.long_context import (
    LongContextTrainer,
    build_long_context_transformer,
)
from tests.torch_distributed_helpers import run_cluster

RTOL = 1e-4
WORLD, STEPS, N_FEATURES, SEQ = 2, 3, 3, 32
NET = dict(d_model=16, n_heads=4, n_layers=2)


def _data():
    rng = np.random.default_rng(7)
    windows = rng.standard_normal((4, SEQ, N_FEATURES)).astype(np.float32)
    targets = rng.standard_normal((4, N_FEATURES)).astype(np.float32)
    return windows, targets


def _jax_run(impl):
    windows, targets = _data()
    trainer = JaxLongContextTrainer(N_FEATURES, jax_mesh(shape=(WORLD,), axis_names=(SEQ_AXIS,)),
                                    attention_impl=impl, **NET)
    params, opt_state = trainer.init(jax.random.PRNGKey(3))
    start = transformer_state_dict(jax.device_get(params))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = trainer.train_step(params, opt_state, windows, targets)
        losses.append(float(loss))
    return start, np.array(losses), transformer_state_dict(jax.device_get(params)), \
        np.asarray(trainer.predict(params, windows))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {impl: _jax_run(impl) for impl in ("ring", "ulysses")}
    windows, targets = _data()
    # both impls start from the same init (the key does not depend on the impl)
    inputs = {"windows": windows, "targets": targets,
              **{f"param.{k}": v for k, v in jax_runs["ring"][0].items()}}
    outs = run_cluster("long_context", WORLD, tmp_path_factory.mktemp("lc"),
                       {"n_features": N_FEATURES, "net": NET, "steps": STEPS}, inputs)
    return jax_runs, outs


@pytest.mark.parametrize("impl", ("ring", "ulysses"))
def test_losses_and_params_match_jax(runs, impl):
    jax_runs, outs = runs
    start, losses, params, predict = jax_runs[impl]
    bound = STEPS * 1e-3 * (1 + 1e-3)  # Adam's default learning rate, each step
    for rank, got in enumerate(outs):
        np.testing.assert_allclose(got[f"{impl}-0-losses"], losses, rtol=RTOL,
                                   err_msg=f"rank {rank}")
        for name, want in params.items():
            value = got[f"{impl}-0-param.{name}"]
            if name.endswith("attn.key.bias"):
                assert np.abs(value - start[name]).max() <= bound
                assert np.abs(want - start[name]).max() <= bound
                continue
            np.testing.assert_allclose(value, want, rtol=RTOL, atol=1e-6,
                                       err_msg=f"rank {rank} {name}")
        np.testing.assert_allclose(got[f"{impl}-0-predict"], predict, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("impl", ("ring", "ulysses"))
def test_remat_trains_as_plain(runs, impl):
    _, outs = runs
    for got in outs:
        np.testing.assert_allclose(got[f"{impl}-1-losses"], got[f"{impl}-0-losses"],
                                   rtol=1e-6)
        for key in got:
            if key.startswith(f"{impl}-0-param."):
                np.testing.assert_allclose(got[key.replace("-0-", "-1-")], got[key],
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dropout", (0.0, 0.2))
def test_remat_under_functional_call_uses_the_given_parameters(dropout):
    """A rematerialised net run through ``functional_call`` with parameters
    that are not the module's own: its gradients are those of the plain
    net at the given parameters (the recompute must not fall back on the
    module's own), with the dropout draws replayed."""
    from torch.func import functional_call

    from gordo_tpu_torch.models.specs_seq import TransformerNet

    def net(remat):
        torch.manual_seed(0)
        return TransformerNet(N_FEATURES, out_dim=N_FEATURES, ff_dim=32, dropout=dropout,
                              remat=remat, **NET).train()

    plain, remat = net(False), net(True)
    rng = np.random.default_rng(1)
    given = {name: (value + torch.from_numpy(
        rng.standard_normal(value.shape).astype(np.float32)) * 0.1).requires_grad_(True)
        for name, value in plain.named_parameters()}
    x = torch.from_numpy(_data()[0][:, :8])

    def grads(module):
        generator = torch.Generator().manual_seed(5)
        out = functional_call(module, given, (x, generator))
        return torch.autograd.grad((out ** 2).sum(), list(given.values()))

    for name, want, got in zip(given, grads(plain), grads(remat)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7, msg=name)


def test_twins_share_parameter_names_and_values():
    sharded, local = build_long_context_transformer(N_FEATURES, remat=True, **NET)
    assert sharded.remat and not local.remat
    assert sharded.seq_axis == SEQ_AXIS and local.seq_axis is None
    a, b = sharded.state_dict(), local.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # a JAX tree of the sharded twin loads into the local one
    jax_tree = JaxLongContextTrainer(
        N_FEATURES, jax_mesh(shape=(1,), axis_names=(SEQ_AXIS,)), **NET
    ).init(jax.random.PRNGKey(0))[0]
    local.load_state_dict({k: torch.tensor(v) for k, v in
                           transformer_state_dict(jax.device_get(jax_tree)).items()})


def test_uneven_sequence_is_refused_as_in_jax():
    class _Mesh:
        mesh_dim_names = (SEQ_AXIS,)
        shape = (3,)

    trainer = LongContextTrainer(N_FEATURES, _Mesh(), device="cpu", **NET)
    params, opt_state = trainer.init(seed=0)
    windows, targets = _data()
    with pytest.raises(ValueError, match="Sequence length 32 not divisible by mesh axis 'seq'"):
        trainer.train_step(params, opt_state, windows, targets)
    with pytest.raises(ValueError, match="invalid with seq_axis"):
        build_long_context_transformer(N_FEATURES, attention_impl="flash", **NET)
    with pytest.raises(ValueError, match="invalid with seq_axis"):
        JaxLongContextTrainer(N_FEATURES, jax_mesh(shape=(1,), axis_names=(SEQ_AXIS,)),
                              attention_impl="flash", **NET).train_step(
            *JaxLongContextTrainer(N_FEATURES, jax_mesh(shape=(1,), axis_names=(SEQ_AXIS,)),
                                   attention_impl="flash", **NET).init(jax.random.PRNGKey(0)),
            jnp.asarray(windows), jnp.asarray(targets))
