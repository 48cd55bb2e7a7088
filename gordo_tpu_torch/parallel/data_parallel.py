"""
Within-model data parallelism (the port of
``gordo_tpu.parallel.data_parallel``): one model, its batch split over the
``data`` axis of a mesh of ``torch.distributed`` ranks.

The parameters are replicated (broadcast from rank 0 at :meth:`init`),
each rank steps on its slice of the global batch (:meth:`shard_batch`),
and the gradients are averaged over the axis (one all-reduce of the
flattened gradients), so that a step is JAX's step on the global batch's
mean loss. The model's forward runs as the solo fit runs it: a
Transformer with ``attention_impl: flash`` launches the three flash
kernels on the card (their plain versions on the CPU).

``zero1=True`` shards the optimizer state (ZeRO stage 1) by JAX's rule: a
parameter whose leading dimension divides by the axis size keeps 1/N of
its state slots (Adam's moments) on each rank; the step count and the
other parameters' state stay replicated. Each rank updates its slice of
those parameters from the averaged gradient, and the slices are then
all-gathered into the replicated parameters, so the parameters and the
losses are those of replicated training. An optimizer that needs a whole
parameter for its step (``lamb``'s trust ratio, ``Optimizer.leafwise``)
is refused with ``zero1``.
"""

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.specs import ModelSpec, flax_default_init_, per_sample_loss
from gordo_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, axis_size

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]


class DataParallelTrainer:
    """
    One model's trainer with the batch split over ``axis`` of ``mesh``,
    on ``device`` (the card unless ``"cpu"``; the process group's).

    ``zero1`` shards the optimizer state over the axis (module docstring).
    """

    def __init__(self, spec: ModelSpec, mesh, axis: str = DATA_AXIS, zero1: bool = False,
                 device: DeviceLike = None):
        self.spec = spec
        self.mesh = mesh
        self.axis = axis
        self.zero1 = bool(zero1)
        self.device = resolve_device(device)
        self.module = spec.module.to(self.device)
        self._optimizer = spec.make_optimizer()
        if self.zero1 and self._optimizer.leafwise:
            raise ValueError(
                f"zero1 shards element-wise optimizer state; {spec.optimizer!r} steps each "
                "parameter as a whole"
            )
        self._group = mesh.get_group(axis)
        self._n = axis_size(mesh, axis)
        self._index = axis_index(mesh, axis)

    def _sharded(self, param: torch.Tensor) -> bool:
        """JAX's ``zero1`` rule: the leaf's leading dimension divides over
        the axis."""
        return self.zero1 and param.ndim >= 1 and param.shape[0] % self._n == 0

    def _slice(self, param: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a sharded parameter (or its gradient); the
        whole of any other."""
        if not self._sharded(param):
            return param
        rows = param.shape[0] // self._n
        return param[self._index * rows:(self._index + 1) * rows]

    def init(self, seed: int = 0,
             params: Optional[Dict[str, Any]] = None) -> Tuple[Tensors, dict]:
        """(params, optimizer state): Flax's default initialisation from
        ``seed``, or ``params`` (a state dict of tensors or arrays by the
        module's names, e.g. ``convert.state_dict_from_flax`` of a JAX
        tree), broadcast from rank 0. JAX's takes an example batch for its
        shapes; the module's parameters have theirs."""
        if params is None:
            flax_default_init_(self.module, torch.Generator().manual_seed(int(seed)))
            params = dict(self.module.named_parameters())
        state = {}
        for name, _ in self.module.named_parameters():
            value = params[name]
            value = value.detach() if isinstance(value, torch.Tensor) else np.asarray(value)
            state[name] = torch.as_tensor(value, dtype=torch.float32, device=self.device).clone()
        for tensor in state.values():
            dist.broadcast(tensor, src=dist.get_global_rank(self._group, 0), group=self._group)
        opt_state = self._optimizer.init({name: self._slice(p) for name, p in state.items()})
        return state, opt_state

    def shard_batch(self, x) -> torch.Tensor:
        """This rank's slice of the global batch (its leading axis, which
        must divide over the mesh axis), on the trainer's device."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        if x.shape[0] % self._n:
            raise ValueError(
                f"Batch of {x.shape[0]} not divisible by mesh axis {self.axis!r} size {self._n}"
            )
        rows = x.shape[0] // self._n
        return x[self._index * rows:(self._index + 1) * rows].to(self.device)

    def _loss(self, params: Tensors, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        out = functional_call(self.module, params, (xb,))
        out, penalty = out if isinstance(out, tuple) else (out, 0.0)
        return per_sample_loss(self.spec.loss, out, yb).mean() + penalty

    def train_step(self, params: Tensors, opt_state: dict, xb: torch.Tensor, yb: torch.Tensor):
        """One optimizer step on this rank's batch slices ``xb``, ``yb``
        (:meth:`shard_batch`): (params, opt_state, loss), the loss the
        global batch's mean, the same on every rank."""
        names = list(params)
        # JAX's step applies the module deterministically: no dropout
        self.module.eval()
        inputs = {name: params[name].detach().requires_grad_(True) for name in names}
        loss = self._loss(inputs, xb, yb)
        grads = torch.autograd.grad(loss, [inputs[name] for name in names])
        loss = loss.detach()
        # the gradients and the loss in one all-reduce, then their mean
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, group=self._group)
        flat /= self._n
        loss = flat[-1]
        grads = flat[:-1].split([g.numel() for g in grads])
        grads = {name: g.view_as(params[name]) for name, g in zip(names, grads)}
        current = {name: params[name].detach() for name in names}
        new, opt_state = self._optimizer.update(
            {name: self._slice(g) for name, g in grads.items()}, opt_state,
            {name: self._slice(p) for name, p in current.items()})
        if self.zero1:
            for name in names:
                if self._sharded(current[name]):
                    parts = [torch.empty_like(new[name]) for _ in range(self._n)]
                    dist.all_gather(parts, new[name].contiguous(), group=self._group)
                    new[name] = torch.cat(parts)
        return new, opt_state, loss
