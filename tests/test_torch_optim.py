"""
The port's optimizers (``gordo_tpu_torch.models.optim``) against optax,
the JAX package's optimizers, on the same gradients.

Every one of the ten names the JAX package maps (``gordo_tpu/models/
specs.py``) is held to optax over 5 steps within rtol 1e-6 in float32,
without a machine axis and with one (each machine against its own optax
run, bias corrections counting that machine's steps); the options the
earlier port refused (``eps_root``, ``mu_dtype``, ``nesterov``, adamw's
``mask``, sgd's ``accumulator_dtype``) are held the same way, a bfloat16
state included (optax run op by op, as the JAX fleet's eager reference
runs it). ``active`` False leaves a machine's parameters and state,
step count included, as they were. The solo fit steps with the same
functions, and no module of the port uses ``torch.optim``.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gordo_tpu.models.specs import make_optimizer as jax_make_optimizer
from gordo_tpu_torch.models.optim import OPTIMIZERS, where_machines
from gordo_tpu_torch.models.specs import make_optimizer

torch.set_num_threads(1)
REPO_ROOT = Path(__file__).resolve().parent.parent
STEPS = 5


def _params(rng, machines=None):
    lead = () if machines is None else (machines,)
    return {
        "w": rng.normal(size=lead + (4, 3)).astype(np.float32),
        "b": rng.normal(size=lead + (3,)).astype(np.float32),
    }


def _optax_run(name, kwargs, params, grads):
    """optax's params after each step, from numpy params and gradients."""
    tx = jax_make_optimizer(name, kwargs)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    out = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
        out.append({k: np.asarray(v) for k, v in p.items()})
    return out


def _torch(values):
    return {k: torch.from_numpy(np.array(v)) for k, v in values.items()}


ALL_TEN = sorted(OPTIMIZERS)
CASES = [(name, {}) for name in ALL_TEN] + [
    ("adam", {"lr": 0.01, "eps_root": 1e-8}),
    ("adam", {"nesterov": True}),
    ("adamw", {"weight_decay": 0.1, "mask": {"w": True, "b": False}}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"centered": True, "momentum": 0.5, "bias_correction": True}),
    ("rmsprop", {"eps_in_sqrt": False, "initial_scale": 0.1}),
    ("adadelta", {"weight_decay": 0.01}),
    ("lamb", {"weight_decay": 0.01}),
    ("lion", {"weight_decay": 0.0}),
]


def _jax_kwargs(kwargs):
    """The JAX map's spelling of a case: a mask over the pytree, dtypes as
    jax's."""
    out = dict(kwargs)
    if isinstance(out.get("mask"), dict):
        out["mask"] = dict(out["mask"])
    for key in ("mu_dtype", "accumulator_dtype"):
        if key in out:
            out[key] = getattr(jnp, out[key])
    return out


@pytest.mark.parametrize("name,kwargs", CASES)
def test_optimizer_matches_optax_without_a_machine_axis(name, kwargs):
    rng = np.random.default_rng(0)
    params = _params(rng)
    grads = [_params(rng) for _ in range(STEPS)]
    want = _optax_run(name, _jax_kwargs(kwargs), params, grads)
    opt = make_optimizer(name, kwargs)
    p = _torch(params)
    state = opt.init(p)
    for g, w in zip(grads, want):
        p, state = opt.update(_torch(g), state, p)
        for key in p:
            np.testing.assert_allclose(p[key].numpy(), w[key], rtol=1e-6, atol=1e-7, err_msg=key)
    assert int(state["count"]) == STEPS


@pytest.mark.parametrize("name,kwargs", CASES)
def test_optimizer_matches_optax_with_a_machine_axis(name, kwargs):
    """Three machines stacked: each against its own optax run; the second
    machine skips step 2 (``active`` False) and its optax run skips it."""
    rng = np.random.default_rng(1)
    machines = 3
    params = _params(rng, machines)
    grads = [_params(rng, machines) for _ in range(STEPS)]
    opt = make_optimizer(name, kwargs)
    p = _torch(params)
    state = opt.init(p, n_machines=machines)
    for step, g in enumerate(grads):
        active = torch.tensor([True, step != 2, True])
        p, state = opt.update(_torch(g), state, p, active=active)
    for i in range(machines):
        steps = [s for s in range(STEPS) if i != 1 or s != 2]
        want = _optax_run(
            name, _jax_kwargs(kwargs),
            {k: v[i] for k, v in params.items()},
            [{k: v[i] for k, v in grads[s].items()} for s in steps],
        )[-1]
        for key in p:
            np.testing.assert_allclose(p[key][i].numpy(), want[key], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{key} machine {i}")
    assert state["count"].tolist() == [STEPS, STEPS - 1, STEPS]


@pytest.mark.parametrize(
    "name,kwargs",
    [("adam", {"mu_dtype": "bfloat16"}), ("sgd", {"momentum": 0.9, "accumulator_dtype": "bfloat16"}),
     ("lion", {"mu_dtype": "bfloat16"})],
)
def test_low_precision_state_matches_optax(name, kwargs):
    """A bfloat16 moment rounds as optax rounds it run op by op: the
    Python scalar is taken in the state's type first."""
    rng = np.random.default_rng(2)
    params = _params(rng)
    grads = [_params(rng) for _ in range(STEPS)]
    want = _optax_run(name, _jax_kwargs(kwargs), params, grads)[-1]
    opt = make_optimizer(name, kwargs)
    p = _torch(params)
    state = opt.init(p)
    slot = "trace" if name == "sgd" else "mu"
    assert all(v.dtype == torch.bfloat16 for v in state[slot].values())
    for g in grads:
        p, state = opt.update(_torch(g), state, p)
    for key in p:
        np.testing.assert_allclose(p[key].numpy(), want[key], rtol=1e-6, atol=1e-7, err_msg=key)


def test_sgd_nesterov_without_momentum_trains_as_optax():
    """optax applies the momentum trace, and with it nesterov, only when a
    momentum is set: ``sgd`` with ``nesterov: true`` and no momentum is
    plain SGD. The port used to refuse it (torch.optim's rule)."""
    rng = np.random.default_rng(3)
    params = _params(rng)
    grads = [_params(rng) for _ in range(3)]
    want = _optax_run("sgd", {"learning_rate": 0.1, "nesterov": True}, params, grads)
    tensors = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    opt = make_optimizer("sgd", {"learning_rate": 0.1, "nesterov": True}, list(tensors.values()))
    for g, w in zip(grads, want):
        for key, tensor in tensors.items():
            tensor.grad = torch.from_numpy(g[key])
        opt.step()
        for key, tensor in tensors.items():
            np.testing.assert_allclose(tensor.detach().numpy(), w[key], rtol=1e-6, err_msg=key)


def test_inactive_machine_keeps_params_and_state():
    rng = np.random.default_rng(4)
    opt = make_optimizer("adam", {})
    p = _torch(_params(rng, 2))
    state = opt.init(p, n_machines=2)
    p, state = opt.update(_torch(_params(rng, 2)), state, p)
    before_p = {k: v.clone() for k, v in p.items()}
    before_s = {"count": state["count"].clone(),
                **{s: {k: v.clone() for k, v in state[s].items()} for s in ("mu", "nu")}}
    p2, state2 = opt.update(_torch(_params(rng, 2)), state, p, active=torch.tensor([False, True]))
    for key in p:
        assert torch.equal(p2[key][0], before_p[key][0])
        assert not torch.equal(p2[key][1], before_p[key][1])
        for slot in ("mu", "nu"):
            assert torch.equal(state2[slot][key][0], before_s[slot][key][0])
    assert state2["count"].tolist() == [1, 2]


def test_lamb_trust_ratio_is_per_machine():
    """Two machines with parameters of very different size: the trust
    ratio is each machine's own norm ratio, so each matches its own optax
    run (a norm over the whole stack would not)."""
    rng = np.random.default_rng(5)
    params = _params(rng, 2)
    params["w"][1] *= 100.0
    grads = [_params(rng, 2) for _ in range(2)]
    opt = make_optimizer("lamb", {"learning_rate": 0.1})
    p = _torch(params)
    state = opt.init(p, n_machines=2)
    for g in grads:
        p, state = opt.update(_torch(g), state, p)
    for i in range(2):
        want = _optax_run("lamb", {"learning_rate": 0.1}, {k: v[i] for k, v in params.items()},
                          [{k: v[i] for k, v in g.items()} for g in grads])[-1]
        np.testing.assert_allclose(p["w"][i].numpy(), want["w"], rtol=1e-6)


def test_where_machines_selects_nested_dicts():
    new = {"a": torch.ones(2, 3), "s": {"b": torch.ones(2)}}
    old = {"a": torch.zeros(2, 3), "s": {"b": torch.zeros(2)}}
    out = where_machines(torch.tensor([True, False]), new, old)
    assert out["a"].tolist() == [[1.0] * 3, [0.0] * 3]
    assert out["s"]["b"].tolist() == [1.0, 0.0]


def test_a_learning_rate_schedule_is_refused():
    with pytest.raises(TypeError, match="schedule"):
        make_optimizer("adam", {"learning_rate": lambda count: 1e-3})


def test_port_uses_no_torch_optim():
    """No module of the port reaches ``torch.optim``, and a fit imports no
    ``torch._dynamo`` (which the first ``torch.optim`` optimizer did, at
    6-8 s of a build process on the card's host)."""
    pattern = re.compile(r"torch\.optim\b|from torch import optim")
    offenders = []
    for path in (REPO_ROOT / "gordo_tpu_torch").rglob("*.py"):
        for number, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if pattern.search(code) and not code.strip().startswith(("``", '"', "'")):
                if "``torch.optim``" not in code and "`torch.optim`" not in code:
                    offenders.append(f"{path.relative_to(REPO_ROOT)}:{number}: {line.strip()}")
    assert offenders == []
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "from gordo_tpu_torch.models import AutoEncoder\n"
        "X = np.random.default_rng(0).normal(size=(40, 3)).astype('float32')\n"
        "AutoEncoder(kind='feedforward_hourglass').fit(X, X, device='cpu')\n"
        "print(json.dumps('torch._dynamo' in sys.modules))\n"
    )
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT, capture_output=True,
                            text=True, timeout=120, check=True)
    assert json.loads(result.stdout.strip().splitlines()[-1]) is False
