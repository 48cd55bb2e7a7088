"""
The optimizers the JAX package names (``gordo_tpu.models.specs``'s map
onto optax), as functions on tensors with optax's formulas and defaults.

An :class:`Optimizer` works on a dict of tensors, by name:

- ``init(params, n_machines=None) -> state``: the state dict, with a step
  count and the optimizer's slots (one tensor per parameter each);
- ``update(grads, state, params, active=None) -> (new_params, new_state)``:
  one step, ``params + updates`` as ``optax.apply_updates`` adds them.

With ``n_machines`` the parameters carry a leading machine axis (a fleet's
stacked weights, ``gordo_tpu_torch.parallel.fleet``): the step count is
one per machine, the bias corrections count each machine's own steps,
and ``lamb``'s trust ratio is a norm per parameter per machine. ``active``
(a bool per machine; a scalar without the machine axis) gates a step:
where it is False, the machine's parameters and state, its step count
included, keep their entering values, as the JAX fleet's ``jnp.where``
keeps them.

The ten names are optax's chains, each transformation in optax's order:

- ``adam``: ``scale_by_adam`` (``eps_root``, ``mu_dtype``, ``nesterov``);
- ``adamw``: adam, then weight decay (1e-4; ``mask``);
- ``nadam``: adam with ``nesterov=True``;
- ``sgd``: a momentum trace when ``momentum`` is set (``nesterov``,
  ``accumulator_dtype``), plain SGD otherwise, with or without
  ``nesterov``;
- ``rmsprop``: decay 0.9, ``eps`` inside the square root by default
  (``eps_in_sqrt``), ``initial_scale``, ``centered``, ``bias_correction``,
  then the learning rate, then a momentum trace when ``momentum`` is set;
- ``adagrad``: accumulators from 0.1, eps 1e-7;
- ``adadelta``: weight decay (``weight_decay_mask``) first, rho 0.9, eps 1e-6;
- ``adamax``: the infinity moment, eps 1e-8;
- ``lamb``: adam with eps 1e-6, weight decay, the trust ratio;
- ``lion``: b2 0.99, weight decay 1e-3 (``mask``).

A weight-decay ``mask`` is a dict of bools by parameter name (a missing
name decays), one bool for all, or a callable that takes the parameters
and returns either. The learning rate is a number.

The solo fit uses the same functions through :meth:`Optimizer.bind`, with
no machine axis, so one implementation serves both paths and
``torch.optim`` is not used.
"""

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

Tensors = Dict[str, torch.Tensor]
_INT32_MAX = 2**31 - 1


def where_machines(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """``torch.where(mask, new, old)`` leaf by leaf over two dicts (nested
    dicts too) of tensors with a leading machine axis; ``mask`` is a bool
    per machine, or one bool."""
    if isinstance(new, dict):
        return {key: where_machines(mask, new[key], old[key]) for key in new}
    return torch.where(_per_machine(mask, new), new, old)


def _per_machine(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-machine (M,) tensor shaped to broadcast over ``like``'s
    trailing axes; a scalar as it is."""
    if values.ndim == 0:
        return values
    return values.reshape(values.shape + (1,) * (like.ndim - values.ndim))


def _dtype(name) -> Optional[torch.dtype]:
    """A state dtype option (``mu_dtype``, ``accumulator_dtype``): None
    keeps the parameter's type."""
    from gordo_tpu_torch.models.specs import resolve_dtype

    return None if name is None else resolve_dtype(name)


def _times(scalar: float, t: torch.Tensor) -> torch.Tensor:
    """``scalar * t`` as JAX multiplies a weakly typed Python number into
    an array: the number is first rounded to t's type (which matters for
    a bfloat16 or float16 state, ``mu_dtype``/``accumulator_dtype``)."""
    if t.dtype in (torch.float32, torch.float64):
        return scalar * t
    return t * torch.tensor(scalar, dtype=t.dtype, device=t.device)


def _norm(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    """The 2-norm of a parameter, per machine when ``stacked``."""
    if not stacked:
        return torch.linalg.vector_norm(x)
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)


def flatten(tensors: Tensors, lead: int = 0) -> torch.Tensor:
    """The tensors of a dict, in its order, flattened into one: (P,), or
    (M, P) keeping ``lead=1`` leading machine axis."""
    return torch.cat([t.reshape(*t.shape[:lead], -1) for t in tensors.values()], dim=lead)


def unflatten(flat: torch.Tensor, like: Dict[str, torch.Size], lead: int = 0) -> Tensors:
    """Views into ``flat`` shaped as ``like``'s shapes (each without the
    leading axes), the inverse of :func:`flatten`."""
    sizes = [int(torch.Size(shape).numel()) for shape in like.values()]
    parts = flat.split(sizes, dim=lead)
    return {name: part.view(*flat.shape[:lead], *shape)
            for (name, shape), part in zip(like.items(), parts)}


class BoundOptimizer:
    """An :class:`Optimizer` over an ``nn.Module``'s parameters, stepped
    as ``torch.optim`` optimizers are: ``step()`` reads each ``.grad``
    (none counts as zeros, as a JAX gradient of an unused parameter is)
    and writes the new values in place. Unless the optimizer works leaf by
    leaf (:attr:`Optimizer.leafwise`), the parameters become views into
    one flat buffer and a step is one update of it: the same arithmetic
    element by element, in a few launches where there were a few a
    parameter."""

    def __init__(self, optimizer: "Optimizer", params):
        self.optimizer = optimizer
        self.params = list(params)
        kinds = {(p.dtype, p.device) for p in self.params}
        self.flat = None
        if self.params and not optimizer.leafwise and len(kinds) == 1:
            with torch.no_grad():
                self.flat = flatten({str(i): p.detach() for i, p in enumerate(self.params)})
                offset = 0
                for p in self.params:
                    p.data = self.flat[offset : offset + p.numel()].view(p.shape)
                    offset += p.numel()
        self.state = optimizer.init(self._values())

    def _values(self) -> Tensors:
        if self.flat is not None:
            return {"flat": self.flat}
        return {str(i): p.detach() for i, p in enumerate(self.params)}

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = {
            str(i): torch.zeros_like(p) if p.grad is None else p.grad
            for i, p in enumerate(self.params)
        }
        if self.flat is not None:
            new, self.state = self.optimizer.update(
                {"flat": flatten(grads)}, self.state, self._values()
            )
            self.flat.copy_(new["flat"])
            return
        new, self.state = self.optimizer.update(grads, self.state, self._values())
        for i, p in enumerate(self.params):
            p.copy_(new[str(i)])


class Optimizer:
    """One of optax's optimizers: ``init`` and ``update`` on dicts of
    tensors (see the module note)."""

    #: the per-parameter state tensors, in optax's order
    slots: Tuple[str, ...] = ()

    def __init__(self, learning_rate: float = 1e-3):
        if callable(learning_rate):
            raise TypeError(
                "a learning-rate schedule is not ported; give the learning rate as a number"
            )
        self.learning_rate = float(learning_rate)

    @property
    def leafwise(self) -> bool:
        """Whether a step depends on how the parameters are cut into
        tensors (a weight-decay mask, ``lamb``'s per-parameter trust
        ratio): otherwise every formula is element by element, and the
        parameters may be updated as one flat tensor."""
        return self.mask is not None

    def bind(self, params) -> BoundOptimizer:
        return BoundOptimizer(self, params)

    # -- state ---------------------------------------------------------
    def _slot_init(self, slot: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def init(self, params: Tensors, n_machines: Optional[int] = None) -> dict:
        """The state of a first step: the slots, and a step count (int32,
        one per machine with ``n_machines``)."""
        device = next(iter(params.values())).device if params else None
        shape = () if n_machines is None else (int(n_machines),)
        state: dict = {"count": torch.zeros(shape, dtype=torch.int32, device=device)}
        for slot in self.slots:
            state[slot] = {name: self._slot_init(slot, p) for name, p in params.items()}
        return state

    # -- one step --------------------------------------------------------
    #: the weight-decay mask (None: every parameter decays)
    mask = None

    def _direction(self, g, p, slots, count, stacked, decay) -> Tuple[torch.Tensor, dict]:
        """The update of one parameter before the learning rate, and its
        new slots. ``count`` is the step count after this step; ``decay``
        whether the weight-decay mask takes this parameter."""
        raise NotImplementedError

    def _after_lr(self, u, slots) -> Tuple[torch.Tensor, dict]:
        """A transformation optax chains after the learning rate (rmsprop's
        momentum trace); the identity by default."""
        return u, {}

    def update(
        self,
        grads: Tensors,
        state: dict,
        params: Tensors,
        active: Optional[torch.Tensor] = None,
    ) -> Tuple[Tensors, dict]:
        """(new params, new state) after one step on ``grads``; where
        ``active`` is False the machine keeps its entering params and
        state."""
        count = state["count"]
        stacked = count.ndim == 1
        count_inc = torch.where(count < _INT32_MAX, count + 1, count)
        self._corrections: dict = {}
        new_params: Tensors = {}
        new_state: dict = {"count": count_inc}
        for slot in self.slots:
            new_state[slot] = {}
        mask = self.mask(params) if callable(self.mask) else self.mask
        for name, p in params.items():
            slots = {slot: state[slot][name] for slot in self.slots}
            decay = bool(mask.get(name, True) if isinstance(mask, dict) else
                         (True if mask is None else mask))
            u, new_slots = self._direction(grads[name], p, slots, count_inc, stacked, decay)
            u = u * -self.learning_rate
            u, after = self._after_lr(u, slots)
            new_slots.update(after)
            new_params[name] = p + u
            for slot in self.slots:
                new_state[slot][name] = new_slots.get(slot, slots[slot])
        if active is not None:
            new_params = where_machines(active, new_params, params)
            new_state = where_machines(active, new_state, state)
        return new_params, new_state

    # -- helpers shared by the optimizers --------------------------------
    def _bias_correction(self, t: torch.Tensor, decay: float, count: torch.Tensor) -> torch.Tensor:
        """optax's ``t / (1 - decay**count)``, the correction computed in
        float32 (once a step for each decay and count) and divided in t's
        type, per machine."""
        key = (decay, id(count))
        if key not in self._corrections:
            # the count rides along, so its id is not reused within the step
            self._corrections[key] = (count, 1 - torch.pow(decay, count.to(torch.float32)))
        correction = self._corrections[key][1]
        return t / _per_machine(correction, t).to(t.dtype)


class _Adam(Optimizer):
    slots = ("mu", "nu")

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, *, nesterov=False):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype = _dtype(mu_dtype)
        self.nesterov = nesterov

    def _slot_init(self, slot, p):
        if slot == "mu" and self.mu_dtype is not None:
            return torch.zeros_like(p, dtype=self.mu_dtype)
        return torch.zeros_like(p)

    def _adam(self, g, slots, count):
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + _times(b1, slots["mu"])
        nu = (1 - b2) * (g * g) + b2 * slots["nu"]
        if self.nesterov:
            count_next = torch.where(count < _INT32_MAX, count + 1, count)
            mu_hat = (b1 * self._bias_correction(mu, b1, count_next)
                      + (1 - b1) * self._bias_correction(g, b1, count))
        else:
            mu_hat = self._bias_correction(mu, b1, count)
        nu_hat = self._bias_correction(nu, b2, count)
        # sqrt(v + 0.0) is sqrt(v): the default eps_root costs no operation
        root = torch.sqrt(nu_hat + self.eps_root) if self.eps_root else torch.sqrt(nu_hat)
        u = mu_hat / (root + self.eps)
        if self.mu_dtype is not None:
            mu = mu.to(self.mu_dtype)
        return u, {"mu": mu, "nu": nu}

    def _direction(self, g, p, slots, count, stacked, decay):
        return self._adam(g, slots, count)


class _AdamW(_Adam):
    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, weight_decay=1e-4, mask=None, *, nesterov=False):
        super().__init__(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)
        self.weight_decay, self.mask = weight_decay, mask

    def _direction(self, g, p, slots, count, stacked, decay):
        u, new = self._adam(g, slots, count)
        if decay:
            u = u + self.weight_decay * p
        return u, new


class _Nadam(_Adam):
    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, *, nesterov=True):
        super().__init__(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)


class _Lamb(_Adam):
    leafwise = True

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0, mask=None):
        super().__init__(learning_rate, b1, b2, eps, eps_root)
        self.weight_decay, self.mask = weight_decay, mask

    def _direction(self, g, p, slots, count, stacked, decay):
        u, new = self._adam(g, slots, count)
        if decay:
            u = u + self.weight_decay * p
        # the trust ratio: a norm per parameter (per machine), 1 where
        # either norm is 0
        p_norm, u_norm = _norm(p, stacked), _norm(u, stacked)
        ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0),
                            torch.ones((), dtype=p.dtype, device=p.device), p_norm / u_norm)
        return u * _per_machine(ratio, u), new


class _Sgd(Optimizer):
    def __init__(self, learning_rate=1e-3, momentum=None, nesterov=False,
                 accumulator_dtype=None):
        super().__init__(learning_rate)
        # optax applies the trace (and with it nesterov) only with a momentum
        self.momentum, self.nesterov = momentum, nesterov
        self.accumulator_dtype = _dtype(accumulator_dtype)
        self.slots = ("trace",) if momentum is not None else ()

    def _slot_init(self, slot, p):
        return torch.zeros_like(p, dtype=self.accumulator_dtype or p.dtype)

    def _direction(self, g, p, slots, count, stacked, decay):
        if self.momentum is None:
            return g, {}
        trace = g + _times(self.momentum, slots["trace"])
        u = g + self.momentum * trace if self.nesterov else trace
        if self.accumulator_dtype is not None:
            trace = trace.to(self.accumulator_dtype)
        return u, {"trace": trace}


class _RMSProp(Optimizer):
    def __init__(self, learning_rate=1e-3, decay=0.9, eps=1e-8, initial_scale=0.0,
                 eps_in_sqrt=True, centered=False, momentum=None, nesterov=False,
                 bias_correction=False):
        super().__init__(learning_rate)
        self.decay, self.eps, self.initial_scale = decay, eps, initial_scale
        self.eps_in_sqrt, self.centered = eps_in_sqrt, centered
        self.momentum, self.nesterov, self.bias_correction = momentum, nesterov, bias_correction
        self.slots = (("mu",) if centered else ()) + ("nu",) + (
            ("trace",) if momentum is not None else ())

    def _slot_init(self, slot, p):
        if slot == "nu":
            return torch.full_like(p, self.initial_scale)
        return torch.zeros_like(p)

    def _direction(self, g, p, slots, count, stacked, decay):
        d = self.decay
        new = {"nu": (1 - d) * (g * g) + d * slots["nu"]}
        nu_hat = new["nu"]
        if self.centered:
            new["mu"] = (1 - d) * g + d * slots["mu"]
            mu_hat = new["mu"]
        if self.bias_correction:
            nu_hat = self._bias_correction(nu_hat, d, count)
            if self.centered:
                mu_hat = self._bias_correction(mu_hat, d, count)
        second = nu_hat - mu_hat * mu_hat if self.centered else nu_hat
        if self.eps_in_sqrt:
            scaling = torch.rsqrt(second + self.eps)
        else:
            scaling = 1 / (torch.sqrt(second) + self.eps)
        return scaling * g, new

    def _after_lr(self, u, slots):
        if self.momentum is None:
            return u, {}
        trace = u + self.momentum * slots["trace"]
        return (u + self.momentum * trace if self.nesterov else trace), {"trace": trace}


class _Adagrad(Optimizer):
    slots = ("sum_of_squares",)

    def __init__(self, learning_rate=1e-3, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(learning_rate)
        self.initial_accumulator_value, self.eps = initial_accumulator_value, eps

    def _slot_init(self, slot, p):
        return torch.full_like(p, self.initial_accumulator_value)

    def _direction(self, g, p, slots, count, stacked, decay):
        total = g * g + slots["sum_of_squares"]
        scale = torch.where(total > 0, torch.rsqrt(total + self.eps),
                            torch.zeros((), dtype=total.dtype, device=total.device))
        return scale * g, {"sum_of_squares": total}


class _Adadelta(Optimizer):
    slots = ("e_g", "e_x")

    def __init__(self, learning_rate=1e-3, rho=0.9, eps=1e-6, weight_decay=0.0,
                 weight_decay_mask=None):
        super().__init__(learning_rate)
        self.rho, self.eps = rho, eps
        self.weight_decay, self.mask = weight_decay, weight_decay_mask

    def _direction(self, g, p, slots, count, stacked, decay):
        if decay:
            g = g + self.weight_decay * p
        rho = self.rho
        e_g = (1 - rho) * (g * g) + rho * slots["e_g"]
        u = (torch.sqrt(slots["e_x"] + self.eps) / torch.sqrt(e_g + self.eps)) * g
        e_x = (1 - rho) * (u * u) + rho * slots["e_x"]
        return u, {"e_g": e_g, "e_x": e_x}


class _Adamax(Optimizer):
    slots = ("mu", "nu")

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _direction(self, g, p, slots, count, stacked, decay):
        mu = (1 - self.b1) * g + self.b1 * slots["mu"]
        nu = torch.maximum(g.abs() + self.eps, self.b2 * slots["nu"])
        return self._bias_correction(mu, self.b1, count) / nu, {"mu": mu, "nu": nu}


class _Lion(Optimizer):
    slots = ("mu",)

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.99, mu_dtype=None,
                 weight_decay=1e-3, mask=None):
        super().__init__(learning_rate)
        self.b1, self.b2 = b1, b2
        self.mu_dtype = _dtype(mu_dtype)
        self.weight_decay, self.mask = weight_decay, mask

    def _slot_init(self, slot, p):
        return torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)

    def _direction(self, g, p, slots, count, stacked, decay):
        u = torch.sign((1.0 - self.b1) * g + _times(self.b1, slots["mu"]))
        mu = (1 - self.b2) * g + _times(self.b2, slots["mu"])
        if self.mu_dtype is not None:
            mu = mu.to(self.mu_dtype)
        if decay:
            u = u + self.weight_decay * p
        return u, {"mu": mu}


#: the JAX package's optimizer names (``gordo_tpu/models/specs.py``)
OPTIMIZERS: Dict[str, Callable[..., Optimizer]] = {
    "adam": _Adam,
    "adamw": _AdamW,
    "sgd": _Sgd,
    "rmsprop": _RMSProp,
    "adagrad": _Adagrad,
    "adadelta": _Adadelta,
    "adamax": _Adamax,
    "nadam": _Nadam,
    "lamb": _Lamb,
    "lion": _Lion,
}


def is_finite_tree(tree: Tensors, stacked: bool) -> torch.Tensor:
    """Whether every element of every tensor in ``tree`` is finite: one
    bool per machine when ``stacked``, else one bool."""
    out = None
    for value in tree.values():
        if stacked:
            ok = torch.isfinite(value.reshape(value.shape[0], -1)).all(dim=1)
        else:
            ok = torch.isfinite(value).all()
        out = ok if out is None else out & ok
    return out
