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

Telemetry, as the JAX trainer's: each epoch's steps run inside a
``train.dispatch`` span (``epoch``, ``n_epochs=1``) whose seconds go to
the phase ledger's ``train`` plane as ``device`` (the host's time to
queue the epoch on the card), and the next chunk's staged copy as
``transfer``; the events ``epoch`` (with the mean loss and the active
machines under early stopping), ``early_stop``, ``machine_quarantined``,
``fit_resume`` and ``fit_finished``; and the registry's
``gordo_train_*`` series (fit, steady epoch and dispatch seconds,
epochs, host syncs, early stops, quarantined machines, sensor
timesteps, epochs per sync), all labelled ``path="fleet"``.
``gordo_train_compile_seconds`` is not registered: an eager fit compiles
no program, so there is no compile time to split from its first epoch.

Each epoch's dispatch is also a ``train-dispatch`` range of a
``torch.profiler`` trace when one is active
(``observability/profiler.py``, ``GORDO_TPU_PROFILE_DIR``).

``mesh`` (a ``DeviceMesh`` with a ``fleet`` axis, ``parallel/mesh.py``)
shards the fleet over ``torch.distributed`` ranks, as the JAX trainer
shards it over devices: the machine count must divide over the ranks
(:meth:`FleetTrainer.pad_fleet_size` pads it, the pad machines carrying no
weight), each rank trains its slice of the stack, and the host's reads
(the losses, the early-stopping and quarantine rows) are all-gathered
(:func:`host_fetch`), so every rank takes the same decisions and returns
the whole fleet's losses and stacked parameters. Shuffles and dropout
draws are drawn for the whole fleet and sliced, so a machine trains to
the same weights on whichever rank it lands. A sharded fit takes no
checkpointer.

Left out, because they are XLA or TPU machinery the eager port has no
use for: the program cache and its compile telemetry, buffer donation,
and scan unrolling.
"""

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call, vmap

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.observability import attribution, emit_event, get_registry, tracing
from gordo_tpu_torch.observability.profiler import annotate
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
from gordo_tpu_torch.parallel.mesh import FLEET_AXIS, axis_index, axis_size, pad_to_multiple
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


def _mesh_gather(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of the mesh's fleet axis, concatenated along
    ``dim`` in rank order (on the device the process group takes)."""
    n = axis_size(mesh, FLEET_AXIS)
    group = mesh.get_group(FLEET_AXIS)
    if dist.get_backend(group) == "nccl" and t.device.type != "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def host_fetch(x, mesh=None, axis: int = 0) -> np.ndarray:
    """
    A per-machine read to the host: with a ``mesh``, every rank's slice of
    the fleet all-gathered along ``axis`` (the machine axis), so every rank
    receives the whole fleet's values, as the JAX function's
    ``process_allgather`` gives every host the global array.
    """
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if mesh is not None:
        is_bool = t.dtype == torch.bool
        t = _mesh_gather(t.to(torch.uint8) if is_bool else t, mesh, axis)
        t = t.bool() if is_bool else t
    return t.cpu().numpy()


def _map_tree(fn, tree):
    """``fn`` on every tensor of a (nested) dict."""
    if isinstance(tree, dict):
        return {key: _map_tree(fn, value) for key, value in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class _Shard:
    """This rank's slice [lo, hi) of a sharded fit's ``total`` machines."""

    lo: int
    hi: int
    total: int

    def own(self, draw: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-fleet tensor."""
        return draw[self.lo:self.hi]


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
    mesh
        A ``DeviceMesh`` with a ``fleet`` axis: each rank trains its slice
        of the fleet (module docstring); None trains it all here.
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
        mesh=None,
    ):
        self.spec = spec
        self.mesh = mesh
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
    @staticmethod
    def pad_fleet_size(n_machines: int, mesh) -> int:
        """The machine count a fleet is padded to for ``mesh``: a multiple
        of its ranks (unchanged without a mesh)."""
        if mesh is None:
            return n_machines
        return pad_to_multiple(n_machines, axis_size(mesh, FLEET_AXIS))

    def _mesh_range(self, total: int) -> Tuple[int, int]:
        """This rank's slice [lo, hi) of a fleet of ``total`` machines."""
        n = axis_size(self.mesh, FLEET_AXIS)
        if total % n:
            raise ValueError(
                f"{total} machines do not divide over the mesh's {n} ranks: pad the fleet to "
                "FleetTrainer.pad_fleet_size(n, mesh)"
            )
        per = total // n
        index = axis_index(self.mesh, FLEET_AXIS)
        return index * per, (index + 1) * per

    def _take_shard(self, data: StackedData, seeds, params, extra_weight, opt_state):
        """This rank's slice of a sharded fit's inputs, and the slice."""
        if not self.broadcast_data:
            total = data.n_machines
        elif params is not None:
            total = next(iter(params.values())).shape[0]
        elif seeds is not None:
            total = len(seeds)
        else:
            raise ValueError("fit needs the initial params or each machine's seed")
        shard = _Shard(*self._mesh_range(total), total)
        own = shard.own
        if not self.broadcast_data:
            data = StackedData(own(data.X), own(data.y), own(data.sample_weight),
                               None if data.feature_out_weight is None
                               else own(data.feature_out_weight))
        return (
            data,
            None if seeds is None else list(seeds)[shard.lo:shard.hi],
            None if params is None else _map_tree(own, params),
            None if extra_weight is None else np.asarray(extra_weight)[shard.lo:shard.hi],
            None if opt_state is None else _map_tree(own, opt_state),
            shard,
        )

    def _host_rows(self, rows: np.ndarray, shard: Optional[_Shard], axis: int = 0) -> np.ndarray:
        """A host read of per-machine rows: this rank's, or in a sharded
        fit the whole fleet's (:func:`host_fetch`)."""
        return rows if shard is None else host_fetch(rows, self.mesh, axis)

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

    def _draws(self, xb: torch.Tensor, params: Tensors,
               shard: Optional[_Shard] = None) -> List[torch.Tensor]:
        """This step's dropout draws, (M, *site shape) each, from the
        trainer's generator; the sites' shapes come from one recording
        forward of machine 0 per batch shape. A sharded fit draws the
        whole fleet's and keeps its own rows."""
        key = tuple(xb.shape[1:])
        shapes = self._dropout_shapes.get(key)
        if shapes is None:
            feed = DropoutFeed()
            with torch.no_grad():
                one = {name: value[0] for name, value in params.items()}
                functional_call(self.module, one, (xb[0],), {"generator": feed})
            shapes = self._dropout_shapes[key] = feed.shapes
        m = xb.shape[0]
        if self.broadcast_data:
            return [torch.rand((1, *shape), generator=self._generator,
                               device=xb.device).expand(m, *shape)
                    for shape in shapes]
        if shard is None:
            return [torch.rand((m, *shape), generator=self._generator, device=xb.device)
                    for shape in shapes]
        return [shard.own(torch.rand((shard.total, *shape), generator=self._generator,
                                     device=xb.device))
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
               real_samples, gates=None, shard: Optional[_Shard] = None):
        """One epoch for every machine: (params, opt state, epoch loss (M,)).
        ``real_samples`` (host, (M,)) says which machines' batches hold a
        real sample: real samples come first, so batch s of machine m does
        when ``s * batch_size < real_samples[m]``, and only the steps where
        some machine's does not pay for the optimizer's gate, copied to the
        device at the step, or taken from ``gates`` ((n_batches, M) on the
        device, staged ahead) when it is given. In a sharded fit the
        shuffles and dropout are the whole fleet's draws, sliced to
        ``shard``."""
        m, n_samples = wb_all.shape
        device = wb_all.device
        real = wb_all > 0
        self._seed_epoch(epoch)
        if shuffle:
            if shard is None or self.broadcast_data:
                noise = self._shuffle_noise(m, n_samples, epoch)
            else:
                noise = shard.own(self._shuffle_noise(shard.total, n_samples, epoch))
            noise = noise.to(device)
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
            draws = self._draws(xb, leaves, shard)
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
        and ``fit_telemetry_``. With a mesh each rank trains its slice of
        the machines and every rank returns the whole fleet's results
        (module docstring).
        """
        fit_start = time.perf_counter()
        # a mesh: this rank's slice of the machines, their names, and the slice
        own_names, shard = machine_names, None
        if self.mesh is not None:
            if checkpointer is not None:
                raise ValueError("A fleet fit sharded over a mesh takes no checkpointer")
            data, seeds, params, extra_weight, opt_state, shard = self._take_shard(
                data, seeds, params, extra_weight, opt_state)
            if machine_names is not None:
                own_names = list(machine_names)[shard.lo:shard.hi]
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
        inj = faults.train_nan_injection(own_names, m, sites=self.fault_sites)
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
            emit_event("fit_resume", path="fleet", start_epoch=start_epoch, epochs=epochs)
        healthy_entry = self._host_rows(healthy.cpu().numpy().copy(), shard)
        every = max(1, int(checkpoint_every))

        rows: Dict[str, list] = {"loss": [], "val": [], "healthy": [], "active": [],
                                 "active_in": []}
        n_host_syncs = 1
        epochs_run = 0
        step_time = 0.0
        # each epoch's host seconds to queue its steps: the dispatches
        dispatch_times: List[float] = []
        # real rows a machine: the sensor timesteps an active epoch trains on
        rows_per_machine = (w_host > 0).sum(axis=1).astype(np.int64)
        if self.broadcast_data:
            rows_per_machine = np.repeat(rows_per_machine, m)
        rows_per_machine = self._host_rows(rows_per_machine, shard)
        # the whole fleet's machines: every host read below is the fleet's
        m_all = m if shard is None else shard.total
        timesteps_trained = 0
        early_stop_epoch = None

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
                with tracing.start_span("train.dispatch", epoch=e, n_epochs=1), \
                        annotate("train-dispatch"):
                    t0 = time.perf_counter()
                    new_params, new_opt, loss = self._epoch(
                        params, opt_state, X, y, wb_all, fm, n_batches, batch_size, shuffle, e,
                        real_samples, None if gates is None else gates[e - epoch], shard,
                    )
                    seconds = time.perf_counter() - t0
                    attribution.record("train", "device", seconds)
                step_time += seconds
                dispatch_times.append(seconds)
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
                    chunk_rows["active_in"].append(es["active"])
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
                t_put = time.perf_counter()
                staged[key] = transfer.stage(chunk_vector(key[1]), self.device)
                attribution.record("train", "transfer", time.perf_counter() - t_put)
                transfer.count_transfer("train", "prefetched")
            # the host reads the chunk's rows at once: once a chunk with
            # early stopping, once a fit without
            fetched = {key: self._host_rows(torch.stack(value).cpu().numpy(), shard, axis=1)
                       for key, value in chunk_rows.items() if value}
            n_host_syncs += 1
            n_rep = chunk
            stopped = early_stopping and not fetched["active"][-1].any()
            if stopped:
                # the epochs after the stop ran gated and changed nothing
                n_rep = int(np.argmax(~fetched["active"].any(axis=1))) + 1
            for key, value in fetched.items():
                rows[key].append(value[:n_rep])
            epochs_run += n_rep
            for j in range(n_rep):
                fields = {}
                if early_stopping:
                    fields = {"mean_loss": float(np.mean(fetched["loss"][j])),
                              "n_active": int(fetched["active"][j].sum())}
                    timesteps_trained += int(rows_per_machine[fetched["active_in"][j]].sum())
                else:
                    timesteps_trained += int(rows_per_machine.sum())
                emit_event("epoch", path="fleet", epoch=epoch + j, **fields)
            last = epoch + chunk - 1
            if checkpointer is not None and (last + 1) % every == 0:
                checkpointer.save(last, params, opt_state,
                                  self._checkpoint_extra(healthy, es if early_stopping else None))
            if stopped:
                early_stop_epoch = epoch + n_rep - 1
                logger.info("Fleet early stop: all %d machines stopped at epoch %d/%d",
                            m_all, early_stop_epoch, epochs)
                emit_event("early_stop", path="fleet", epoch=early_stop_epoch,
                           n_machines=m_all)
                break
            epoch += chunk
        if track_best and best_params is not None and bool(ever):
            params = best_params
        params = {n: t.contiguous() for n, t in self._leaves(params).items()}

        losses = (np.concatenate(rows["loss"]).astype(np.float64) if rows["loss"]
                  else np.zeros((0, m_all)))
        if rows["val"]:
            val = np.concatenate(rows["val"]).astype(np.float64)
            if has_val is not None:
                has_val = self._host_rows(np.asarray(has_val, dtype=bool), shard)
                if not has_val.all():
                    val[:, ~has_val] = np.nan
            self.val_losses_ = val
        self._finish_quarantine(
            np.concatenate(rows["healthy"]) if rows["healthy"]
            else np.ones((0, m_all), dtype=bool),
            machine_names, m_all, healthy_entry, start_epoch,
        )
        self.history_ = []
        for i in range(m_all):
            history = {"loss": [float(v) for v in losses[:, i]]}
            if self.val_losses_ is not None and not np.isnan(self.val_losses_[:, i]).any():
                history["val_loss"] = [float(v) for v in self.val_losses_[:, i]]
            self.history_.append(history)
        n_stopped = int((~rows["active"][-1][-1]).sum()) if early_stopping and rows["active"] else 0
        self._record_fit_telemetry(
            wall_time_s=time.perf_counter() - fit_start, loop_time_s=step_time,
            epochs_configured=epochs, epochs_run=epochs_run, start_epoch=start_epoch,
            n_machines=m_all, steps_per_epoch=n_batches, early_stopping=early_stopping,
            early_stop_epoch=early_stop_epoch, n_stopped=n_stopped,
            n_host_syncs=n_host_syncs, dispatch_times=dispatch_times,
            timesteps_trained=timesteps_trained,
        )
        if shard is not None:
            params = {name: _mesh_gather(value, self.mesh) for name, value in params.items()}
        return params, losses

    def _record_fit_telemetry(self, *, wall_time_s: float, loop_time_s: float,
                              epochs_configured: int, epochs_run: int, start_epoch: int,
                              n_machines: int, steps_per_epoch: int, early_stopping: bool,
                              early_stop_epoch: Optional[int], n_stopped: int,
                              n_host_syncs: int, dispatch_times: List[float],
                              timesteps_trained: int) -> None:
        """``fit_telemetry_``, the registry's ``gordo_train_*`` series and
        the ``fit_finished`` event of one fit. The steady epoch is the
        mean of the epochs after the first (which pays the process's first
        launches and allocations); with one epoch there is none."""
        steady = (sum(dispatch_times[1:]) / len(dispatch_times[1:])
                  if len(dispatch_times) > 1 else None)
        throughput = timesteps_trained / loop_time_s if loop_time_s > 0 else None
        epochs_per_sync = epochs_run / n_host_syncs if n_host_syncs else None
        dispatch_overhead = sum(dispatch_times) or None
        n_quarantined = int((~self.healthy_).sum())
        self.fit_telemetry_ = {
            "path": "fleet",
            "wall_time_s": wall_time_s,
            "epoch_loop_s": loop_time_s,
            "first_epoch_s": dispatch_times[0] if dispatch_times else None,
            "first_dispatch_s": dispatch_times[0] if dispatch_times else None,
            "first_dispatch_epochs": 1,
            "steady_state_epoch_s": steady,
            # an eager fit compiles nothing
            "compile_time_s": None,
            "epochs_configured": epochs_configured,
            "epochs_run": epochs_run,
            "epochs_dispatched": len(dispatch_times),
            "resumed_from_epoch": start_epoch if start_epoch else None,
            "n_machines": n_machines,
            "steps_per_epoch": steps_per_epoch,
            "sensor_timesteps_trained": timesteps_trained,
            "sensor_timesteps_per_s": throughput,
            "steady_state_sensor_timesteps_per_s": (
                timesteps_trained / epochs_run / steady if steady and epochs_run else None),
            "early_stopping": early_stopping,
            "early_stop_epoch": early_stop_epoch,
            "n_machines_early_stopped": n_stopped,
            "n_machines_quarantined": n_quarantined,
            "epoch_chunk": self.epoch_chunk,
            "n_dispatches": len(dispatch_times),
            "n_host_syncs": n_host_syncs,
            "epochs_per_sync": epochs_per_sync,
            "dispatch_overhead_s": dispatch_overhead,
            "dispatch_gap_s_mean": steady,
        }
        reg = get_registry()
        reg.histogram("gordo_train_fit_seconds", "Fleet fit wall time", ("path",)).observe(
            wall_time_s, path="fleet")
        if steady is not None:
            reg.histogram("gordo_train_epoch_seconds",
                          "Steady-state (after the first) epoch wall time", ("path",)).observe(
                steady, path="fleet")
        reg.counter("gordo_train_epochs_total", "Training epochs executed", ("path",)).inc(
            epochs_run, path="fleet")
        reg.counter("gordo_train_sensor_timesteps_total", "Real sensor-timesteps trained over",
                    ("path",)).inc(timesteps_trained, path="fleet")
        if n_stopped:
            reg.counter("gordo_train_early_stops_total",
                        "Machines halted by per-machine early stopping", ("path",)).inc(
                n_stopped, path="fleet")
        if self.quarantine_nonfinite:
            reg.gauge("gordo_train_quarantined_machines",
                      "Machines quarantined by the non-finite guard (last fit)", ("path",)).set(
                n_quarantined, path="fleet")
        reg.counter("gordo_train_host_syncs_total", "Device->host synchronizations paid by fits",
                    ("path",)).inc(n_host_syncs, path="fleet")
        if epochs_per_sync is not None:
            reg.gauge("gordo_train_epochs_per_sync",
                      "Epochs bought per device->host round-trip (last fit)", ("path",)).set(
                epochs_per_sync, path="fleet")
        if dispatch_overhead is not None:
            reg.histogram("gordo_train_dispatch_seconds",
                          "Host-side dispatch overhead of one whole fit", ("path",)).observe(
                dispatch_overhead, path="fleet")
        emit_event("fit_finished", path="fleet", epochs_run=epochs_run, n_machines=n_machines,
                   wall_time_s=round(wall_time_s, 4), sensor_timesteps_per_s=throughput)

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
                name = machine_names[i] if machine_names and i < len(machine_names) else None
                logger.warning(
                    "Fleet quarantine: machine %s went non-finite at epoch %d; params rolled "
                    "back to last finite epoch and frozen",
                    name if name is not None else f"index {i}", start_epoch + j,
                )
                emit_event("machine_quarantined", path="fleet", machine_index=int(i),
                           machine=name, epoch=int(start_epoch + j))
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
        if self.mesh is not None:
            # each rank forwards its slice of the machines
            lo, hi = self._mesh_range(X.shape[0])
            out = self._predict({name: value[lo:hi] for name, value in params.items()},
                                X[lo:hi], batch_size, precision)
            return host_fetch(out, self.mesh)
        return self._predict(params, X, batch_size, precision).cpu().numpy()

    def _predict(self, params: Tensors, X: torch.Tensor, batch_size: int,
                 precision: str) -> torch.Tensor:
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
        return torch.cat(outs, dim=1)

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
