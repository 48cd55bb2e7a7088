"""
Fleet training (the port of ``gordo_tpu.parallel.fleet``): a bucket of
same-architecture machines trains as one computation over a leading
machine axis (one machine's windowed forward pass, ``windowed_predict``,
lives in ``gordo_tpu_torch.ops.windowing`` and is importable from here).

- :class:`StackedData` stacks ragged per-machine data onto one zero-padded
  grid with per-row weights (and per-column weights for padded-policy
  buckets).
- :class:`FleetTrainer` trains the stack: the parameters of every machine
  are stacked on a leading axis and one step runs the solo module under
  ``torch.func.vmap`` of ``torch.func.functional_call`` (the solo module
  is the reference; no second copy of a net exists), the gradient of the
  sum of the machines' losses giving each machine its own; the optimizer
  (``gordo_tpu_torch.models.optim``) steps all machines at once with a
  per-machine gate. The flash kernels run under the machine axis by
  folding it into their batch axis (``ops.flash_attention``).

The semantics are the JAX trainer's, step for step: real samples packed
into the leading batches of each machine (shuffled among themselves, or
in time order), ``ceil(max real samples / batch_size)`` steps an epoch,
each batch's loss normalised by its own real weight, a batch with no
real sample leaving a machine's parameters and optimizer state as they
were; fold masks (``extra_weight``), a per-machine ``validation_split``,
per-machine early stopping as gated epochs, the non-finite quarantine,
and ``epoch_chunk`` as scheduling only (the host reads the losses once
a chunk; the results are the same bits as with ``epoch_chunk=1``).

Shuffles and dropout draws come from a ``torch.Generator`` on the
training device that each epoch seeds afresh from (the trainer's
``seed``, the epoch), as the JAX trainer folds the epoch into its key:
epoch k draws the same numbers whether the fit started at epoch 0 or
resumed at k from a checkpoint, so a resumed fit is bitwise the unbroken
one. Dropout draws for every machine are made outside the vmapped
function and handed to the module through a
:class:`~gordo_tpu_torch.models.specs.DropoutFeed`. Neither gives JAX's
random numbers.

``checkpointer`` (:class:`~gordo_tpu_torch.parallel.checkpoint.FleetCheckpointer`)
saves (params, optimizer state, and the early-stopping and quarantine
state) every ``checkpoint_every`` epochs, each save ending an epoch
chunk; a fit whose checkpointer already holds a checkpoint resumes after
its epoch. ``broadcast_data`` trains every machine of the fit on one
shared dataset (a hyperparameter sweep, ``parallel/sweep.py``): one
device copy of X and y, expanded over the machine axis, and one row of
shuffle and dropout draws that every machine shares, so each machine
draws what a one-machine fit with the same seed draws.

``prefetch_depth`` above 0 pipelines the host-to-device transfers
(``gordo_tpu_torch.parallel.transfer``), as the JAX trainer does:
:class:`StackedData` moves X, y and the row weights as sliced, staged
copies, and the trainer stages the next epoch chunk's vector (the
chunk's per-step machine gates, which the optimizer takes when some
machine's batch holds no real sample) while the current chunk's steps
run. The values are the same bits at every depth.

``fault_sites`` names the ``GORDO_FAULT_INJECT`` sites whose ``nan``
specs poison this trainer's fits (``gordo_tpu_torch.robustness.faults``):
a targeted machine's epoch loss goes NaN at the spec's epoch, which the
quarantine guard then treats as a real divergence. Ordinary fits listen
to ``train``; lifecycle refits to ``("train", "refit")``.

Left out, because they are XLA or TPU machinery the eager port has no
use for: the program cache and its compile telemetry, buffer donation,
the device mesh and fleet padding to it, and scan unrolling.
"""

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.optim import (
    Optimizer,
    flatten,
    is_finite_tree,
    unflatten,
    where_machines,
)
from gordo_tpu_torch.models.specs import (
    DropoutFeed,
    ModelSpec,
    cast,
    flax_default_init_,
    masked_per_sample_loss,
    per_sample_loss,
)
from gordo_tpu_torch.ops.windowing import DEFAULT_BATCH_SIZE, num_windows, windowed_predict
from gordo_tpu_torch.parallel import transfer
from gordo_tpu_torch.parallel.precision import cast_params
from gordo_tpu_torch.robustness import faults

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class StackedData:
    """
    A bucket's training data stacked on one grid: X (M, n, f) float32, y
    (M, n, f_out), ``sample_weight`` (M, n) in {0, 1} marking real rows,
    and ``feature_out_weight`` (M, f_out) marking real output columns, set
    only when the machines' output widths differ (padded-policy buckets;
    None means every column is real).
    """

    X: torch.Tensor
    y: torch.Tensor
    sample_weight: torch.Tensor
    feature_out_weight: Optional[torch.Tensor] = None

    @classmethod
    def from_ragged(
        cls,
        Xs: Sequence[np.ndarray],
        ys: Sequence[np.ndarray],
        n_machines_padded: Optional[int] = None,
        n_timesteps: Optional[int] = None,
        n_features: Optional[int] = None,
        n_features_out: Optional[int] = None,
        device: DeviceLike = None,
        prefetch_depth: int = 0,
    ) -> "StackedData":
        """
        Stack per-machine (n_i, f_i) arrays on ``device`` (the card unless
        ``"cpu"``), zero-padding rows to the longest machine (or the
        ``n_timesteps`` grid), features and output features to the widest
        machine (or ``n_features``/``n_features_out``), and the machine
        axis to ``n_machines_padded`` with all-zero-weight machines.
        ``prefetch_depth`` above 0 moves X, y and the weights as
        ``transfer.device_put_sliced`` slices; 0 is one plain copy each.
        """
        if len(Xs) != len(ys) or not Xs:
            raise ValueError("from_ragged takes one y for each X, and at least one machine")
        device = resolve_device(device)
        f = max(n_features or 0, max(x.shape[1] for x in Xs))
        f_out = max(n_features_out or 0, max(y_.shape[1] for y_ in ys))
        n_max = max(max(len(x) for x in Xs), n_timesteps or 0)
        m_total = n_machines_padded or len(Xs)
        X = np.zeros((m_total, n_max, f), dtype=np.float32)
        y = np.zeros((m_total, n_max, f_out), dtype=np.float32)
        w = np.zeros((m_total, n_max), dtype=np.float32)
        fw = np.zeros((m_total, f_out), dtype=np.float32)
        ragged_out = False
        for i, (xi, yi) in enumerate(zip(Xs, ys)):
            X[i, : len(xi), : xi.shape[1]] = xi
            y[i, : len(yi), : yi.shape[1]] = yi
            w[i, : len(xi)] = 1.0
            fw[i, : yi.shape[1]] = 1.0
            ragged_out = ragged_out or yi.shape[1] != f_out
        # pad machines carry an all-real column mask: their row weights are
        # zero already
        fw[len(Xs):] = 1.0

        def put(a):
            return torch.from_numpy(a).to(device)

        fw = put(fw) if ragged_out else None
        if prefetch_depth > 0:
            X, y, w = (transfer.device_put_sliced(a, prefetch_depth, plane="build", device=device)
                       for a in (X, y, w))
            return cls(X, y, w, fw)
        return cls(put(X), put(y), put(w), fw)

    @property
    def n_machines(self) -> int:
        return self.X.shape[0]

    @property
    def n_timesteps(self) -> int:
        return self.X.shape[1]


def _tensor(value) -> torch.Tensor:
    """A tensor (as it is) or an array (copied) as a tensor on the CPU."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def _stack(states: Sequence[Dict[str, object]], device: torch.device) -> Tensors:
    """Per-machine dicts of tensors or arrays -> one dict of (M, ...)
    tensors on ``device``."""
    return {
        name: torch.stack([_tensor(state[name]) for state in states]).to(device)
        for name in states[0]
    }


class FleetTrainer:
    """
    Train and predict a bucket of same-architecture models at once.

    Parameters
    ----------
    spec
        The shared architecture (a factory's ModelSpec); its module is the
        solo net every machine runs.
    lookahead
        Target offset of windowed models.
    optimizer
        An optimizer overriding ``spec.make_optimizer()``.
    epoch_chunk
        Epochs between the host's reads of the losses when early stopping
        is on (a plain fit reads them once, at its end). Scheduling only:
        the results are the same bits as with 1; a fleet that stops inside
        a chunk runs the rest of the chunk gated, changing nothing.
    quarantine_nonfinite
        A machine whose epoch loss or updated parameters go non-finite
        rolls back to its last finite epoch and stops updating while the
        rest train on; ``healthy_`` and ``quarantine_epoch_`` say which
        and when. For finite machines the guard changes nothing.
    device
        Where the fleet trains: the card unless ``"cpu"``.
    seed
        Seed of the generator of shuffles and dropout draws.
    prefetch_depth
        Above 0, the next epoch chunk's vector is staged while the current
        chunk runs (module docstring); 0 copies as the trainer always did.
    broadcast_data
        Every machine trains on the fit's one-machine data (module
        docstring); the fit's machines are its seeds or stacked params.
    fault_sites
        The fault-injection sites whose ``nan`` specs poison this
        trainer's fits (module docstring).
    """

    def __init__(
        self,
        spec: ModelSpec,
        lookahead: int = 0,
        optimizer: Optional[Optimizer] = None,
        epoch_chunk: int = 1,
        quarantine_nonfinite: bool = True,
        device: DeviceLike = None,
        seed: int = 0,
        prefetch_depth: int = 0,
        broadcast_data: bool = False,
        fault_sites: Tuple[str, ...] = ("train",),
    ):
        self.spec = spec
        self.fault_sites = tuple(fault_sites)
        self.broadcast_data = bool(broadcast_data)
        self.prefetch_depth = transfer.clip_depth(prefetch_depth)
        self.lookahead = int(lookahead) if spec.windowed else 0
        self.epoch_chunk = max(1, int(epoch_chunk))
        self.quarantine_nonfinite = bool(quarantine_nonfinite)
        self.device = resolve_device(device)
        self.optimizer = optimizer if optimizer is not None else spec.make_optimizer()
        self.module = spec.module.to(self.device)
        self.seed = int(seed)
        self._generator = torch.Generator(device=self.device)
        self._dropout_shapes: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
        self._flat, self._shapes = False, {}

    # -- setup -----------------------------------------------------------
    def init_params(self, seeds: Sequence[int]) -> Tensors:
        """Stacked initial weights, machine i's as a solo fit with seed
        ``seeds[i]`` draws them (Flax's default initialisation on the CPU)."""
        states = []
        for seed in seeds:
            flax_default_init_(self.module, torch.Generator().manual_seed(int(seed)))
            states.append({n: p.detach().cpu().clone() for n, p in self.module.named_parameters()})
        return _stack(states, self.device)

    def stack_params(self, states: Sequence[Dict[str, object]]) -> Tensors:
        """Stacked weights from per-machine state dicts (tensors or arrays,
        by the module's parameter names), e.g. each machine's solo
        ``_initial_state``."""
        names = [n for n, _ in self.module.named_parameters()]
        return _stack([{n: s[n] for n in names} for s in states], self.device)

    def _windows(self) -> Tuple[int, int]:
        return (self.spec.lookback_window if self.spec.windowed else 1), self.lookahead

    def _n_samples(self, n: int) -> int:
        lb, la = self._windows()
        n_samples = (n - lb + 1 - la) if self.spec.windowed else n
        if n_samples <= 0:
            raise ValueError(f"Not enough timesteps ({n}) for lookback={lb}, lookahead={la}")
        return n_samples

    def _real_samples(self, w_host: np.ndarray, n: int) -> np.ndarray:
        """Each machine's real samples, from the (M, n) host weights (a
        window counts when all its rows and its target row are real)."""
        lb, la = self._windows()
        n_samples = self._n_samples(n)
        r = (np.asarray(w_host) > 0).astype(np.int64)
        if not self.spec.windowed:
            return r.sum(axis=1)
        c = np.concatenate([np.zeros((r.shape[0], 1), dtype=np.int64), r.cumsum(axis=1)], axis=1)
        win_all = (c[:, lb:] - c[:, :-lb]) == lb
        valid = win_all[:, :n_samples] & (r[:, lb - 1 + la : lb - 1 + la + n_samples] > 0)
        return valid.sum(axis=1)

    def _n_batches(self, n: int, batch_size: int, sample_cap: Optional[int]) -> int:
        """Optimizer steps an epoch: ``ceil(cap / batch_size)``."""
        n_samples = self._n_samples(n)
        cap = n_samples if sample_cap is None else max(1, min(sample_cap, n_samples))
        return max(1, math.ceil(cap / batch_size))

    def _sample_weights(self, w: torch.Tensor) -> torch.Tensor:
        """(M, n) row weights -> (M, n_samples) sample weights: a window is
        as real as its least real row times its target row."""
        n_samples = self._n_samples(w.shape[1])
        if not self.spec.windowed:
            return w
        lb, la = self._windows()
        win_min = w.unfold(1, lb, 1).amin(dim=-1)[:, :n_samples]
        return win_min * w[:, lb - 1 + la : lb - 1 + la + n_samples]

    def _gather(self, X: torch.Tensor, y: torch.Tensor, sel: torch.Tensor):
        """Per-machine sample ids (M, B) -> (xb (M, B[, lb], f), yb (M, B, f_out))."""
        machines = torch.arange(X.shape[0], device=X.device)[:, None]
        if not self.spec.windowed:
            return X[machines, sel], y[machines, sel]
        lb, la = self._windows()
        rows = sel[..., None] + torch.arange(lb, device=X.device)
        return X[machines[..., None], rows], y[machines, sel + (lb - 1 + la)]

    def _validation_masks(self, w_host: np.ndarray, n: int, validation_split: float):
        """Keras's ``validation_split`` per machine as row masks: the last
        fraction of each machine's samples, counted over its real rows.
        Returns (train mask (M, n), validation weights (M, n), whether each
        machine has validation samples, the first validation sample of the
        fleet, the host train mask)."""
        lb, la = self._windows()
        w_host = np.asarray(w_host, dtype=np.float64)
        n_real = (w_host > 0).sum(axis=1).astype(np.int64)
        n_samples = np.maximum(n_real - lb + 1 - la, 0)
        n_val = (n_samples * validation_split).astype(np.int64)
        n_train = n_samples - n_val
        if np.any((n_samples > 0) & (n_train <= 0)):
            raise ValueError(
                f"validation_split={validation_split} leaves no training samples for at "
                "least one machine"
            )
        t = np.arange(n, dtype=np.int64)[None, :]
        train_mask = (t < (n_train + lb - 1 + la)[:, None]).astype(np.float32)
        val_mask = (t >= n_train[:, None]).astype(np.float32) * w_host.astype(np.float32)
        has_val = n_val > 0
        val_lo = int(n_train[has_val].min()) if has_val.any() else 0

        def put(a):
            return torch.from_numpy(a).to(self.device)

        return put(train_mask), put(val_mask), has_val, val_lo, train_mask

    # -- one step, one epoch ---------------------------------------------
    def _machine_loss(self, masked: bool):
        module, loss_name = self.module, self.spec.loss

        def loss(params, xb, yb, wb, fm, draws):
            feed = DropoutFeed(draws) if draws else None
            out = functional_call(module, params, (xb,), {"generator": feed})
            out, penalty = out if isinstance(out, tuple) else (out, 0.0)
            per = (masked_per_sample_loss(loss_name, out, yb, fm) if masked
                   else per_sample_loss(loss_name, out, yb))
            loss_sum = (per * wb).sum()
            return loss_sum / torch.clamp(wb.sum(), min=1.0) + penalty, loss_sum

        return loss

    def _draws(self, xb: torch.Tensor, params: Tensors) -> List[torch.Tensor]:
        """This step's dropout draws, (M, *site shape) each, from the
        trainer's generator; the sites' shapes come from one recording
        forward of machine 0 per batch shape."""
        key = tuple(xb.shape[1:])
        shapes = self._dropout_shapes.get(key)
        if shapes is None:
            feed = DropoutFeed()
            with torch.no_grad():
                one = {name: value[0] for name, value in params.items()}
                functional_call(self.module, one, (xb[0],), {"generator": feed})
            shapes = self._dropout_shapes[key] = feed.shapes
        m = xb.shape[0]
        rows = 1 if self.broadcast_data else m
        return [torch.rand((rows, *shape), generator=self._generator,
                           device=xb.device).expand(m, *shape)
                for shape in shapes]

    def _leaves(self, params: Tensors) -> Tensors:
        """The module's parameters, by name, from the optimizer's view of
        them: views into the flat (M, P) stack when the optimizer steps it
        whole (``_flat``), else the stacked parameters themselves."""
        if self._flat:
            return unflatten(params["flat"], self._shapes, lead=1)
        return params

    def _seed_epoch(self, epoch: int) -> None:
        """Seed the generator for epoch ``epoch`` from (seed, epoch): the
        epoch's draws do not depend on the epochs before it."""
        state = np.random.SeedSequence([self.seed % 2**63, int(epoch)]).generate_state(2)
        self._generator.manual_seed((int(state[0]) << 31) ^ int(state[1]))

    def _shuffle_noise(self, m: int, n_samples: int, epoch: int) -> torch.Tensor:
        """(M, n_samples) uniform draws in [0, 1) whose order shuffles each
        machine's real samples in epoch ``epoch``: from the epoch's
        generator (the JAX trainer draws them from each machine's key
        folded with the epoch); one row for all under ``broadcast_data``."""
        rows = 1 if self.broadcast_data else m
        return torch.rand((rows, n_samples), generator=self._generator, device=self.device)

    def _epoch(self, params, opt_state, X, y, wb_all, fm, n_batches, batch_size, shuffle, epoch,
               real_samples, gates=None):
        """One epoch for every machine: (params, opt state, epoch loss (M,)).
        ``real_samples`` (host, (M,)) says which machines' batches hold a
        real sample: real samples come first, so batch s of machine m does
        when ``s * batch_size < real_samples[m]``, and only the steps where
        some machine's does not pay for the optimizer's gate, copied to the
        device at the step, or taken from ``gates`` ((n_batches, M) on the
        device, staged ahead) when it is given."""
        m, n_samples = wb_all.shape
        device = wb_all.device
        real = wb_all > 0
        self._seed_epoch(epoch)
        if shuffle:
            noise = self._shuffle_noise(m, n_samples, epoch).to(device)
            sort_key = torch.where(real, noise, 2.0 + noise)
        else:
            ar = torch.arange(n_samples, device=device)
            sort_key = torch.where(real, ar, n_samples + ar)
        order = torch.argsort(sort_key, dim=1, stable=True)
        n_pad = n_batches * batch_size
        if n_pad > n_samples:
            order = torch.cat([order, order.new_zeros((m, n_pad - n_samples))], dim=1)
        sel_all = order[:, :n_pad].reshape(m, n_batches, batch_size)
        pad_mask = torch.zeros(n_pad, device=device)
        pad_mask[: min(n_pad, n_samples)] = 1.0
        pad_mask = pad_mask.reshape(n_batches, batch_size)

        masked = fm is not None
        grad_fn = vmap(self._machine_loss(masked), in_dims=(0, 0, 0, 0, 0 if masked else None, 0))
        names = list(params)
        self.module.train()
        loss_sums, w_sums = [], []
        for step in range(n_batches):
            sel = sel_all[:, step]
            xb, yb = self._gather(X, y, sel)
            wb = wb_all.gather(1, sel) * pad_mask[step]
            inputs = {name: params[name].detach().requires_grad_(True) for name in names}
            leaves = self._leaves(inputs)
            draws = self._draws(xb, leaves)
            losses, loss_sum = grad_fn(leaves, xb, yb, wb, fm, draws)
            grads = torch.autograd.grad(losses.sum(), [inputs[n] for n in names],
                                        allow_unused=True)
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(names, grads)}
            # a batch with no real sample must leave the machine as it was
            w_sum = wb.sum(dim=1)
            has_real = step * batch_size < real_samples
            active = None
            if not has_real.all():
                active = gates[step] if gates is not None else torch.from_numpy(has_real).to(device)
            params, opt_state = self.optimizer.update(
                grads, opt_state, {n: params[n].detach() for n in names}, active=active,
            )
            loss_sums.append(loss_sum.detach())
            w_sums.append(w_sum)
        epoch_loss = torch.stack(loss_sums).sum(0) / torch.clamp(torch.stack(w_sums).sum(0), min=1.0)
        return params, opt_state, epoch_loss

    @torch.no_grad()
    def _val_loss(self, params, X, y, val_w, fm, batch_size, lo) -> torch.Tensor:
        """Per-machine mean loss over the held-out samples (eval mode),
        ``batch_size`` samples at a time from the fleet's first one."""
        lb, la = self._windows()
        n_samples = self._n_samples(X.shape[1])
        m = X.shape[0]
        masked = fm is not None
        loss_name = self.spec.loss
        module = self.module

        def chunk_loss(p, xb, yb, wb, f):
            out = functional_call(module, p, (xb,))
            out = out[0] if isinstance(out, tuple) else out
            per = (masked_per_sample_loss(loss_name, out, yb, f) if masked
                   else per_sample_loss(loss_name, out, yb))
            return (per * wb).sum(), wb.sum()

        fn = vmap(chunk_loss, in_dims=(0, 0, 0, 0, 0 if masked else None))
        module.eval()
        total = torch.zeros(m, device=X.device)
        weight = torch.zeros(m, device=X.device)
        for start in range(lo, n_samples, batch_size):
            ids = torch.arange(start, min(start + batch_size, n_samples), device=X.device)
            sel = ids.expand(m, -1)
            xb, yb = self._gather(X, y, sel)
            if self.spec.windowed:
                rows = ids[:, None] + torch.arange(lb, device=X.device)
                wb = val_w[:, rows].amin(dim=-1) * val_w[:, ids + (lb - 1 + la)]
            else:
                wb = val_w[:, ids]
            s, w = fn(params, xb, yb, wb, fm)
            total += s
            weight += w
        return total / torch.clamp(weight, min=1.0)

    # -- public API ------------------------------------------------------
    def fit(
        self,
        data: StackedData,
        seeds: Optional[Sequence[int]] = None,
        epochs: int = 1,
        batch_size: int = 32,
        shuffle: Optional[bool] = None,
        params: Optional[Tensors] = None,
        extra_weight=None,
        opt_state: Optional[dict] = None,
        checkpointer=None,
        checkpoint_every: int = 1,
        early_stopping_patience: Optional[int] = None,
        early_stopping_min_delta: float = 0.0,
        early_stopping_start_from_epoch: int = 0,
        restore_best_weights: bool = False,
        validation_split: float = 0.0,
        early_stopping_on_val: Optional[bool] = None,
        machine_names: Optional[List[str]] = None,
    ) -> Tuple[Tensors, np.ndarray]:
        """
        Train the fleet; returns (stacked params, losses (epochs run, M)).

        ``params`` (stacked) or ``seeds`` (each machine's solo init seed)
        give the initial weights. ``extra_weight`` ((M, n), a CV fold's
        train mask) multiplies the row weights. ``early_stopping_patience``
        turns on per-machine early stopping: a machine whose monitored
        loss has not improved by ``early_stopping_min_delta`` for that
        many epochs (counted from ``early_stopping_start_from_epoch``)
        stops (its parameters and optimizer state freeze) while the rest
        train on; the fit ends once all have stopped, and a stopped
        machine reports its last active loss. ``restore_best_weights``
        hands each machine back its best epoch's parameters.
        ``validation_split`` holds out the last fraction of each machine's
        samples (``val_losses_``, (epochs, M), NaN for a machine with none)
        and, by default or with ``early_stopping_on_val``, early stopping
        monitors it. ``opt_state`` is a stacked optimizer state to start
        from (a sweep's, with its per-machine hyperparameters); None inits
        one. ``checkpointer`` saves every ``checkpoint_every`` epochs and,
        when it holds a checkpoint, the fit resumes after its epoch: the
        losses, ``history_`` and ``val_losses_`` then cover the epochs run
        here, and ``fit_telemetry_["resumed_from_epoch"]`` names the first.
        After the fit: ``healthy_``, ``quarantine_epoch_`` (-1 for a healthy
        machine), ``healthy_history_``, ``history_`` (one dict a machine)
        and ``fit_telemetry_``.
        """
        fit_start = time.perf_counter()
        if shuffle is None:
            shuffle = not self.spec.windowed
        if not 0.0 <= float(validation_split) < 1.0:
            raise ValueError(f"validation_split must be in [0, 1), got {validation_split}")
        X, y, w = data.X, data.y, data.sample_weight
        fm = data.feature_out_weight
        if extra_weight is not None:
            w = w * torch.as_tensor(np.asarray(extra_weight, dtype=np.float32)).to(w.device)
        # the one host read of the weights: the validation split and the
        # step count work from it
        w_host = w.cpu().numpy().astype(np.float64)
        m = data.n_machines
        if self.broadcast_data:
            if data.n_machines != 1 or w.shape[0] != 1:
                raise ValueError(
                    "broadcast_data takes one machine's data and weights (shared by every "
                    f"machine of the fit), got data of {data.n_machines} and weights of "
                    f"shape {tuple(w.shape)}"
                )
            if params is not None:
                m = next(iter(params.values())).shape[0]
            elif seeds is not None:
                m = len(seeds)
            else:
                raise ValueError("fit needs the initial params or each machine's seed")

        val_w, has_val, val_lo = None, None, 0
        self.val_losses_: Optional[np.ndarray] = None
        if validation_split > 0.0:
            train_mask, val_w, has_val, val_lo, train_mask_host = self._validation_masks(
                w_host, data.n_timesteps, float(validation_split)
            )
            w = w * train_mask
            w_host = w_host * train_mask_host
        monitor_val = (val_w is not None if early_stopping_on_val is None
                       else bool(early_stopping_on_val) and val_w is not None)

        if params is None:
            if seeds is None:
                raise ValueError("fit needs the initial params or each machine's seed")
            params = self.init_params(seeds)
        params = {n: t.to(self.device) for n, t in params.items()}
        # an optimizer that works element by element steps the whole stack
        # as one flat (M, P) tensor: the same arithmetic in a few launches
        self._shapes = {n: t.shape[1:] for n, t in params.items()}
        self._flat = not self.optimizer.leafwise
        if self._flat:
            params = {"flat": flatten(params, lead=1)}
        if opt_state is None:
            opt_state = self.optimizer.init(params, n_machines=m)

        real_samples = self._real_samples(w_host, data.n_timesteps)
        n_batches = self._n_batches(data.n_timesteps, batch_size, max(1, int(real_samples.max())))
        wb_all = self._sample_weights(w)
        if self.broadcast_data:
            # one device copy, viewed as m machines'
            X, y = X.expand(m, *X.shape[1:]), y.expand(m, *y.shape[1:])
            wb_all = wb_all.expand(m, -1)
            real_samples = np.repeat(real_samples, m)
            if val_w is not None:
                val_w = val_w.expand(m, -1)
                has_val = np.repeat(has_val, m)
        # the train:nan seam, resolved once a fit: None unless a spec
        # targets this fleet
        inj = faults.train_nan_injection(machine_names, m, sites=self.fault_sites)
        inj_mask = None if inj is None else torch.from_numpy(inj[0]).to(self.device)
        early_stopping = early_stopping_patience is not None
        track_best = early_stopping and restore_best_weights
        quarantine = self.quarantine_nonfinite
        device = self.device
        healthy = torch.ones(m, dtype=torch.bool, device=device)
        if early_stopping:
            stop_at = max(int(early_stopping_patience), 1)
            delta = abs(float(early_stopping_min_delta))
            es = {
                "active": torch.ones(m, dtype=torch.bool, device=device),
                "best": torch.full((m,), float("inf"), device=device),
                "wait": torch.zeros(m, dtype=torch.int32, device=device),
                "last": torch.zeros(m, device=device),
            }
            has_val_dev = (torch.from_numpy(np.asarray(has_val, dtype=bool)).to(device)
                           if monitor_val else None)
        best_params, ever = None, torch.zeros((), dtype=torch.bool, device=device)
        start_epoch = 0
        if checkpointer is not None and checkpointer.latest_epoch() is not None:
            params, opt_state, healthy, start_epoch = self._restore(
                checkpointer, params, opt_state, healthy, es if early_stopping else None)
        healthy_entry = healthy.cpu().numpy().copy()
        every = max(1, int(checkpoint_every))

        rows: Dict[str, list] = {"loss": [], "val": [], "healthy": [], "active": []}
        n_host_syncs = 1
        epochs_run = 0
        step_time = 0.0

        def chunk_len(e0: int) -> int:
            k = min(self.epoch_chunk, epochs - e0) if early_stopping else epochs - e0
            if checkpointer is not None:
                # a checkpoint ends a chunk: the save sees the epoch's state
                k = min(k, ((e0 + every) // every) * every - e0)
            return k

        # an epoch chunk's vector: its per-step machine gates, (k, steps, M)
        step_gates = (np.arange(n_batches)[:, None] * batch_size) < real_samples[None, :]

        def chunk_vector(k: int) -> np.ndarray:
            return np.repeat(step_gates[None], k, axis=0)

        # the next chunk's vector, staged while this chunk runs, by (epoch, length)
        staged: Dict[Tuple[int, int], transfer.Staged] = {}
        epoch = start_epoch
        while epoch < epochs:
            chunk = chunk_len(epoch)
            gates = None
            if self.prefetch_depth > 0:
                pending = staged.pop((epoch, chunk), None)
                if pending is None:
                    transfer.count_transfer("train", "direct")
                    pending = transfer.stage(chunk_vector(chunk), self.device)
                gates = pending.wait()
            chunk_rows: Dict[str, list] = {key: [] for key in rows}
            for e in range(epoch, epoch + chunk):
                t0 = time.perf_counter()
                new_params, new_opt, loss = self._epoch(
                    params, opt_state, X, y, wb_all, fm, n_batches, batch_size, shuffle, e,
                    real_samples, None if gates is None else gates[e - epoch],
                )
                step_time += time.perf_counter() - t0
                if inj_mask is not None and e == inj[1]:
                    # poison the epoch loss as a real divergence would
                    loss = torch.where(inj_mask, torch.full_like(loss, float("nan")), loss)
                keep = None
                if early_stopping:
                    keep = es["active"]
                if quarantine:
                    finite = torch.isfinite(loss) & is_finite_tree(new_params, stacked=True)
                    healthy = healthy & finite
                    keep = healthy if keep is None else keep & healthy
                    chunk_rows["healthy"].append(healthy)
                if keep is not None:
                    params = where_machines(keep, new_params, params)
                    opt_state = where_machines(keep, new_opt, opt_state)
                else:
                    params, opt_state = new_params, new_opt
                vloss = None
                if val_w is not None:
                    vloss = self._val_loss(self._leaves(params), X, y, val_w, fm, batch_size,
                                           val_lo)
                    chunk_rows["val"].append(vloss)
                if early_stopping:
                    report = torch.where(es["active"], loss, es["last"])
                    if e >= int(early_stopping_start_from_epoch):
                        monitored = torch.where(has_val_dev, vloss, loss) if monitor_val else loss
                        improved = es["active"] & (monitored < es["best"] - delta)
                        es["best"] = torch.where(improved, monitored, es["best"])
                        es["wait"] = torch.where(improved, 0, es["wait"] + 1)
                        es["active"] = es["active"] & (es["wait"] < stop_at)
                        if track_best:
                            base = params if best_params is None else where_machines(
                                ever, best_params, params)
                            best_params = where_machines(improved, params, base)
                            ever = ever | improved.any()
                    es["last"] = report
                    chunk_rows["loss"].append(report)
                    chunk_rows["active"].append(es["active"])
                else:
                    chunk_rows["loss"].append(loss)
            next_epoch = epoch + chunk
            if self.prefetch_depth > 0 and next_epoch < epochs:
                # the chunk's work is queued: stage the next chunk's vector
                # now, so its copy runs under this chunk's kernels
                key = (next_epoch, chunk_len(next_epoch))
                staged[key] = transfer.stage(chunk_vector(key[1]), self.device)
                transfer.count_transfer("train", "prefetched")
            # the host reads the chunk's rows at once: once a chunk with
            # early stopping, once a fit without
            fetched = {key: torch.stack(value).cpu().numpy() for key, value in chunk_rows.items()
                       if value}
            n_host_syncs += 1
            n_rep = chunk
            stopped = early_stopping and not fetched["active"][-1].any()
            if stopped:
                # the epochs after the stop ran gated and changed nothing
                n_rep = int(np.argmax(~fetched["active"].any(axis=1))) + 1
            for key, value in fetched.items():
                rows[key].append(value[:n_rep])
            epochs_run += n_rep
            last = epoch + chunk - 1
            if checkpointer is not None and (last + 1) % every == 0:
                checkpointer.save(last, params, opt_state,
                                  self._checkpoint_extra(healthy, es if early_stopping else None))
            if stopped:
                logger.info("Fleet early stop: all %d machines stopped at epoch %d/%d",
                            m, epoch + n_rep - 1, epochs)
                break
            epoch += chunk
        if track_best and best_params is not None and bool(ever):
            params = best_params
        params = {n: t.contiguous() for n, t in self._leaves(params).items()}

        losses = (np.concatenate(rows["loss"]).astype(np.float64) if rows["loss"]
                  else np.zeros((0, m)))
        if rows["val"]:
            val = np.concatenate(rows["val"]).astype(np.float64)
            if has_val is not None and not has_val.all():
                val[:, ~has_val] = np.nan
            self.val_losses_ = val
        self._finish_quarantine(
            np.concatenate(rows["healthy"]) if rows["healthy"] else np.ones((0, m), dtype=bool),
            machine_names, m, healthy_entry, start_epoch,
        )
        self.history_ = []
        for i in range(m):
            history = {"loss": [float(v) for v in losses[:, i]]}
            if self.val_losses_ is not None and not np.isnan(self.val_losses_[:, i]).any():
                history["val_loss"] = [float(v) for v in self.val_losses_[:, i]]
            self.history_.append(history)
        wall = time.perf_counter() - fit_start
        self.fit_telemetry_ = {
            "path": "fleet",
            "wall_time_s": wall,
            "epoch_loop_s": step_time,
            "epochs_configured": epochs,
            "epochs_run": epochs_run,
            "resumed_from_epoch": start_epoch if start_epoch else None,
            "n_machines": m,
            "steps_per_epoch": n_batches,
            "early_stopping": early_stopping,
            "epoch_chunk": self.epoch_chunk,
            "n_host_syncs": n_host_syncs,
            "n_machines_quarantined": int((~self.healthy_).sum()),
        }
        return params, losses

    def _finish_quarantine(self, hist: np.ndarray, machine_names, m: int,
                           entry: np.ndarray, start_epoch: int) -> None:
        """``healthy_``, ``quarantine_epoch_`` and ``healthy_history_`` from
        the per-epoch healthy rows of the epochs from ``start_epoch`` (the
        machines healthy then: ``entry``); a warning a casualty."""
        self.healthy_history_ = hist
        self.healthy_ = hist[-1].copy() if len(hist) else entry.copy()
        quarantine_epoch = np.full(m, -1, dtype=np.int64)
        prev = entry
        for j in range(len(hist)):
            for i in np.flatnonzero(prev & ~hist[j]):
                quarantine_epoch[i] = start_epoch + j
                name = machine_names[i] if machine_names and i < len(machine_names) else f"index {i}"
                logger.warning(
                    "Fleet quarantine: machine %s went non-finite at epoch %d; params rolled "
                    "back to last finite epoch and frozen", name, start_epoch + j,
                )
            prev = hist[j]
        self.quarantine_epoch_ = quarantine_epoch

    #: the early-stopping state a checkpoint carries, by the JAX trainer's
    #: names: (name in the checkpoint, key of the trainer's state)
    _ES_EXTRA = (("best", "best"), ("wait", "wait"), ("active", "active"), ("last_loss", "last"))

    def _checkpoint_extra(self, healthy: torch.Tensor, es: Optional[dict]) -> Optional[dict]:
        """The host arrays a checkpoint carries beside the weights: the
        quarantine mask and the early-stopping state."""
        extra = {}
        if self.quarantine_nonfinite:
            extra["healthy"] = healthy.cpu().numpy()
        if es is not None:
            extra.update({name: es[key].cpu().numpy() for name, key in self._ES_EXTRA})
        return extra or None

    def _restore(self, checkpointer, params, opt_state, healthy, es: Optional[dict]):
        """(params, opt_state, healthy, first epoch to run) from the
        checkpointer's newest restorable checkpoint; ``es`` is updated in
        place. A checkpoint without early-stopping state resumes an
        early-stopping fit with every machine active, with a warning."""
        template = self._checkpoint_extra(healthy, es)
        if template:
            params, opt_state, done, extra = checkpointer.restore_with_extra(
                params, opt_state, template, optional_extra_keys=("healthy",))
            extra = dict(extra or {})
            if self.quarantine_nonfinite and "healthy" in extra:
                healthy = torch.from_numpy(extra.pop("healthy").astype(bool)).to(self.device)
            if es is not None and "active" in extra:
                for name, key in self._ES_EXTRA:
                    es[key] = torch.from_numpy(extra[name]).to(self.device, es[key].dtype)
            elif es is not None:
                logger.warning(
                    "Resuming an early-stopping fleet fit without saved early-stop state "
                    "(older checkpoint?): stopped machines will briefly reactivate"
                )
        else:
            params, opt_state, done = checkpointer.restore(params, opt_state)
        logger.info("Resuming fleet fit at epoch %d", done + 1)
        return params, opt_state, healthy, done + 1

    @torch.no_grad()
    def predict(self, params: Tensors, X, batch_size: int = DEFAULT_BATCH_SIZE,
                precision: str = "float32") -> np.ndarray:
        """
        The fleet's forward pass: X (M, n, f) -> (M, n_out, f_out) float32,
        n_out = n - lookback + 1 - lookahead for windowed models, else n;
        ``batch_size`` windows (or rows) of every machine at a time. With
        ``precision="bf16"`` the weights and X are cast to bfloat16 first
        and the outputs come back float32 (the calibration's bf16 pass).
        """
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        X = torch.as_tensor(X).to(self.device)
        if precision == "bf16":
            params = cast_params(params, torch.bfloat16)
            X = X.to(torch.bfloat16)
        module = self.module.eval()

        def forward(p, xb):
            out = functional_call(module, p, (xb,))
            return cast(out[0] if isinstance(out, tuple) else out, torch.float32)

        fn = vmap(forward)
        lb, la = self._windows()
        n_out = num_windows(X.shape[1], lb, la) if self.spec.windowed else X.shape[1]
        outs = []
        for start in range(0, n_out, batch_size):
            ids = torch.arange(start, min(start + batch_size, n_out), device=X.device)
            if self.spec.windowed:
                xb = X[:, ids[:, None] + torch.arange(lb, device=X.device)]
            else:
                xb = X[:, ids]
            outs.append(fn(params, xb))
        return torch.cat(outs, dim=1).cpu().numpy()

    @staticmethod
    def unstack_params(params: Tensors, index: int) -> Dict[str, np.ndarray]:
        """Machine ``index``'s weights as host arrays."""
        return {name: value[index].detach().cpu().numpy().copy() for name, value in params.items()}

    @staticmethod
    def unstack_all(params: Tensors, n: int) -> List[Dict[str, np.ndarray]]:
        """The first ``n`` machines' weights as host arrays, with one copy
        of the stack to the host."""
        host = {name: value.detach().cpu().numpy() for name, value in params.items()}
        return [{name: value[i].copy() for name, value in host.items()} for i in range(n)]
