"""
Optimizer-hyperparameter sweeps as one fleet (the port of
``gordo_tpu.parallel.sweep``).

A sweep over learning rates, weight decays and the like is a fleet whose
machines share their architecture and data and differ only in their
optimizer's hyperparameters: :func:`~gordo_tpu_torch.models.optim.inject_hyperparams`
moves them into the optimizer state, one float32 per machine, and one
:class:`~gordo_tpu_torch.parallel.fleet.FleetTrainer` fit with
``broadcast_data`` trains every variant at once over one device copy of
the data (a Transformer's flash kernels take the variants as their
machine axis, folded into their batch).

With a ``mesh`` the sweep shards its variants over the ranks like any
fleet: the variant axis is padded to a multiple of the ranks with copies
of the last grid point, which the result leaves out.

Every variant starts from the weights a one-machine fit with the same
seed starts from, and draws that fit's shuffles and dropout, so trial i
is a plain fit at grid point i up to the rounding of its hyperparameters
to float32 (module note of ``models/optim.py``). Hyperparameters that
change shapes (widths, windows) are not swept here: a build with
``--model-parameter`` takes one value at a time.
"""

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.optim import flatten, inject_hyperparams
from gordo_tpu_torch.models.specs import _OPT_KWARG_ALIASES, ModelSpec, resolve_optimizer
from gordo_tpu_torch.parallel.fleet import FleetTrainer, StackedData

logger = logging.getLogger(__name__)


class HyperparamSweep:
    """
    Train N optimizer-hyperparameter variants of one model as one fleet.

    Parameters
    ----------
    spec
        The architecture (a factory's ModelSpec); its optimizer and
        ``optimizer_kwargs`` are the base configuration.
    grid
        ``{name: [value of each variant, ...]}``, every list as long (the
        number of variants); names are the optimizer's sweepable
        arguments, ``lr`` and ``decay`` standing for ``learning_rate`` and
        ``weight_decay`` as in ``optimizer_kwargs``.
    lookahead, epoch_chunk, device, mesh
        Passed to the FleetTrainer (the card unless ``device="cpu"``; a
        mesh shards the variants over its ranks, module docstring).
    """

    def __init__(self, spec: ModelSpec, grid: Dict[str, Sequence[float]], lookahead: int = 0,
                 epoch_chunk: int = 1, device: DeviceLike = None, mesh=None):
        if not grid:
            raise ValueError("grid must name at least one hyperparameter")
        lengths = {len(v) for v in grid.values()}
        if len(lengths) != 1:
            raise ValueError(f"All grid value lists must share one length, got {lengths}")
        (self.n_variants,) = lengths
        if self.n_variants == 0:
            raise ValueError("grid value lists are empty")
        self.grid = {_OPT_KWARG_ALIASES.get(k, k): [float(x) for x in v] for k, v in grid.items()}
        self.spec = spec
        # an even split needs the variant axis padded to the mesh; the pad
        # variants repeat the last grid point and are left out of the result
        self.n_padded = FleetTrainer.pad_fleet_size(self.n_variants, mesh)
        ctor, kwargs = resolve_optimizer(spec.optimizer, spec.optimizer_kwargs)
        optimizer = ctor(**kwargs)
        # raises, naming the sweepable ones, for a name that is not
        optimizer = inject_hyperparams(optimizer, tuple(sorted(self.grid)))
        self.trainer = FleetTrainer(spec, lookahead=lookahead, optimizer=optimizer,
                                    epoch_chunk=epoch_chunk, device=device,
                                    broadcast_data=True, mesh=mesh)

    def _inject(self, opt_state: dict) -> dict:
        """The stacked state with the (padded) grid's values as its
        hyperparameters."""
        hyperparams = dict(opt_state["hyperparams"])
        for name, values in self.grid.items():
            padded = list(values) + [values[-1]] * (self.n_padded - len(values))
            hyperparams[name] = hyperparams[name].new_tensor(padded)
        return dict(opt_state, hyperparams=hyperparams)

    def fit(self, X: np.ndarray, y=None, epochs: int = 10, batch_size: int = 128,
            seed: int = 0) -> "SweepResult":
        """Train every variant on the same (X, y); per-variant losses and
        stacked params, ranked best first by :class:`SweepResult`."""
        y = y if y is not None else X.copy()
        trainer = self.trainer
        data = StackedData.from_ragged([np.asarray(X)], [np.asarray(y)], device=trainer.device)
        trainer.seed = int(seed)
        params = trainer.init_params([seed] * self.n_padded)
        # the optimizer's view of the parameters, as fit makes it
        view = params if trainer.optimizer.leafwise else {"flat": flatten(params, lead=1)}
        opt_state = self._inject(trainer.optimizer.init(view, n_machines=self.n_padded))
        params, losses = trainer.fit(data, epochs=epochs, batch_size=batch_size, params=params,
                                     opt_state=opt_state)
        return SweepResult(grid=self.grid, params=params, losses=losses[:, : self.n_variants])


class SweepResult:
    """Per-variant outcome of a :class:`HyperparamSweep`."""

    def __init__(self, grid: Dict[str, List[float]], params, losses: np.ndarray):
        self.grid = grid
        self.params = params
        self.losses = losses  # (epochs, n_variants)

    @property
    def final_losses(self) -> np.ndarray:
        return self.losses[-1]

    @property
    def best_index(self) -> int:
        return int(np.argmin(self.final_losses))

    @property
    def best_hyperparams(self) -> Dict[str, float]:
        return {k: v[self.best_index] for k, v in self.grid.items()}

    def best_params(self):
        """The winning variant's weights as host arrays."""
        return FleetTrainer.unstack_params(self.params, self.best_index)

    def ranking(self) -> List[Tuple[Dict[str, float], float]]:
        """(hyperparameters, final loss) pairs, best first."""
        order = np.argsort(self.final_losses)
        return [({k: v[i] for k, v in self.grid.items()}, float(self.final_losses[i]))
                for i in order]
