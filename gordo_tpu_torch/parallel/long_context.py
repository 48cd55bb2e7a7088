"""
Long-context training (the port of ``gordo_tpu.parallel.long_context``): a
Transformer whose activations are split over a mesh axis of
``torch.distributed`` ranks by timestep, for windows too long for one
device.

- :func:`build_long_context_transformer` returns (sharded, local) twin
  ``TransformerNet`` s with the same parameters: the sharded twin has
  ``seq_axis`` set (global positions from the rank's offset, ring or
  Ulysses attention as the core, the final timestep by psum-select) and,
  with ``remat``, checkpoints each block; the local twin (dense
  attention, no remat) serves single-device inference.
- :class:`LongContextTrainer` trains the sharded twin: the parameters are
  replicated, every rank takes the whole (batch, seq, features) window
  and runs its seq/N timesteps through every layer, and every rank gets
  the same loss.

Gradients: each rank's backward gives the gradient of its own share of
the computation. The psum-select's backward sums the incoming gradients
over the axis (JAX's transpose of ``psum``), the ring's and the
exchange's backward return each gradient to the rank that sent the
block, so the sum over ranks of every parameter's gradient is N times
the gradient of the (replicated) loss: the trainer averages the
gradients over the axis and takes one replicated optimizer step, which
is JAX's step on the same window.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.specs import flax_default_init_, make_optimizer, per_sample_loss
from gordo_tpu_torch.models.specs_seq import TransformerNet
from gordo_tpu_torch.parallel.mesh import axis_size
from gordo_tpu_torch.parallel.sequence import SEQ_AXIS, bound_axis, mesh_context

Tensors = Dict[str, torch.Tensor]


def _tensor(value, device: torch.device) -> torch.Tensor:
    """An array or tensor as a float32 tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
    else:
        value = np.asarray(value)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def build_long_context_transformer(
    n_features: int,
    n_features_out: Optional[int] = None,
    d_model: int = 64,
    n_heads: int = 4,
    n_layers: int = 2,
    ff_dim: Optional[int] = None,
    causal: bool = True,
    attention_impl: str = "ring",
    axis_name: str = SEQ_AXIS,
    remat: bool = False,
    dtype=torch.float32,
) -> Tuple[TransformerNet, TransformerNet]:
    """(sharded, local) twins with the same parameters: the sharded twin
    (``seq_axis``, ``remat``) trains, the local twin (dense attention, no
    remat: inference keeps no backward state) predicts."""
    common = dict(
        n_features=n_features,
        d_model=d_model,
        n_heads=n_heads,
        n_layers=n_layers,
        ff_dim=ff_dim or 4 * d_model,
        out_dim=n_features_out or n_features,
        dropout=0.0,  # the long-context path trains deterministic
        causal=causal,
        dtype=dtype,
    )
    sharded = TransformerNet(attention_impl=attention_impl, seq_axis=axis_name, remat=remat,
                             **common)
    local = TransformerNet(attention_impl="dense", seq_axis=None, **common)
    local.load_state_dict(sharded.state_dict())
    return sharded, local


class LongContextTrainer:
    """
    Train a many-to-one Transformer on sequence-sharded windows::

        trainer = LongContextTrainer(n_features=8, mesh=mesh)
        params, opt_state = trainer.init(seed=0)
        for step in range(n_steps):
            params, opt_state, loss = trainer.train_step(params, opt_state, windows, targets)

    ``windows`` is (batch, seq, features) with seq divisible by the mesh's
    sequence axis, the same on every rank; ``targets`` (batch,
    n_features_out). Runs on ``device`` (the card unless ``"cpu"``), which
    must be the process group's (nccl for the card, gloo for the CPU).
    """

    def __init__(
        self,
        n_features: int,
        mesh,
        n_features_out: Optional[int] = None,
        axis_name: str = SEQ_AXIS,
        optimizer: str = "Adam",
        optimizer_kwargs: Optional[dict] = None,
        loss: str = "mse",
        device: DeviceLike = None,
        **transformer_kwargs,
    ):
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_features = n_features
        self.loss = loss
        self.device = resolve_device(device)
        sharded, local = build_long_context_transformer(
            n_features, n_features_out=n_features_out, axis_name=axis_name,
            **transformer_kwargs,
        )
        self.module, self.local_module = sharded.to(self.device), local.to(self.device)
        self._optimizer = make_optimizer(optimizer, optimizer_kwargs or {})

    def init(self, seed: int = 0, params: Optional[Dict[str, object]] = None) -> Tuple[Tensors, dict]:
        """(params, optimizer state): Flax's default initialisation of the
        local twin from ``seed``, or ``params`` (a state dict of tensors or
        arrays by the twins' names, e.g. ``convert.transformer_state_dict``
        of a JAX tree). The shapes do not depend on the sequence length."""
        if params is None:
            flax_default_init_(self.local_module, torch.Generator().manual_seed(int(seed)))
            params = dict(self.local_module.named_parameters())
        names = [name for name, _ in self.local_module.named_parameters()]
        state = {name: _tensor(params[name], self.device).clone() for name in names}
        return state, self._optimizer.init(state)

    def train_step(self, params: Tensors, opt_state: dict, windows, targets):
        """One optimizer step on the whole windows: (params, opt_state,
        loss), the loss the same on every rank."""
        n = axis_size(self.mesh, self.axis_name)
        if windows.shape[1] % n:
            raise ValueError(
                f"Sequence length {windows.shape[1]} not divisible by mesh axis "
                f"{self.axis_name!r} size {n}"
            )
        x, y = _tensor(windows, self.device), _tensor(targets, self.device)
        group, index, _ = bound_axis(self.axis_name, self.mesh)
        local = x.shape[1] // n
        x_local = x[:, index * local:(index + 1) * local]
        names = list(params)
        inputs = {name: params[name].detach().requires_grad_(True) for name in names}
        with mesh_context(self.mesh):
            out = functional_call(self.module, inputs, (x_local,))
            loss = per_sample_loss(self.loss, out, y).mean()
            grads = torch.autograd.grad(loss, [inputs[name] for name in names])
        # one flat all-reduce of the gradients, then their mean
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        grads = flat.split([g.numel() for g in grads])
        grads = {name: g.view_as(params[name]) for name, g in zip(names, grads)}
        new_params, opt_state = self._optimizer.update(
            grads, opt_state, {name: params[name].detach() for name in names})
        return new_params, opt_state, loss.detach()

    @torch.no_grad()
    def predict(self, params: Tensors, windows) -> np.ndarray:
        """Single-device inference with the local twin (the same params)."""
        out = functional_call(self.local_module, params, (_tensor(windows, self.device),))
        return out.cpu().numpy()
