"""
Training callbacks (the port of ``gordo_tpu.models.callbacks``), with the
Keras contract the JAX package keeps: the fit loop reads the epoch's
loss (and validation loss) on the host after each epoch and asks every
callback whether to stop.

Configs name them by their Keras paths (``tensorflow.keras.callbacks.
EarlyStopping``, ``keras.callbacks.EarlyStopping``), by the JAX package's
(``gordo_tpu.models.callbacks.EarlyStopping``) or by the port's; the
serializer maps all of them onto these classes
(``gordo_tpu_torch.serializer.callback_from_definition``). A Keras
callback with no counterpart here, such as ``ReduceLROnPlateau``, is
dropped with a warning, as the JAX package drops it.

:func:`fleet_fit_kwargs` maps an estimator's callbacks and
``validation_split`` onto the fleet trainer's per-machine gates, or says
that they do not translate.
"""

import logging
import typing

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _snapshot(params: typing.Dict[str, torch.Tensor]) -> typing.Dict[str, torch.Tensor]:
    """Copies of the parameters: the fit loop updates its tensors in place."""
    return {name: value.detach().clone() for name, value in params.items()}


class Callback:
    """Per-epoch training hook: ``update`` returns True to request a stop."""

    def on_train_begin(self) -> None:
        pass

    def get_params(self, deep: bool = False) -> dict:
        """Constructor arguments, for the serializer's round trip."""
        return {}

    def update(self, epoch: int, logs: typing.Dict[str, float], params) -> bool:
        return False

    def finalize(self, params):
        """The parameters training ends with (these, unless the callback
        restores an earlier snapshot)."""
        return params


class TerminateOnNaN(Callback):
    """Stop the moment any logged loss is not finite (Keras's callback of
    the same name)."""

    def update(self, epoch: int, logs: typing.Dict[str, float], params) -> bool:
        for name, value in logs.items():
            if value is not None and not np.isfinite(value):
                logger.warning("TerminateOnNaN: %s=%r at epoch %d — stopping", name, value, epoch)
                return True
        return False


class EarlyStopping(Callback):
    """
    Stop when a monitored metric stops improving, with Keras's contract:
    ``monitor``/``min_delta``/``patience``/``mode``/``baseline``/
    ``restore_best_weights``/``start_from_epoch``. ``patience`` 0 stops at
    the first epoch without improvement, as 1 does. ``monitor`` falls
    back from ``val_loss`` to ``loss`` with a warning when the fit logs
    no validation loss. The best weights come back only when the callback
    stopped the fit.
    """

    def __init__(
        self,
        monitor: str = "val_loss",
        min_delta: float = 0.0,
        patience: int = 0,
        mode: str = "auto",
        baseline: typing.Optional[float] = None,
        restore_best_weights: bool = False,
        verbose: int = 0,
        start_from_epoch: int = 0,
    ):
        if mode not in ("min", "max", "auto"):
            raise ValueError(f"mode must be 'min', 'max' or 'auto', got {mode!r}")
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.baseline = baseline
        self.restore_best_weights = restore_best_weights
        self.verbose = verbose
        self.start_from_epoch = start_from_epoch
        self._delta = abs(float(min_delta))
        # Keras's 'auto' maximises a metric named like an accuracy and
        # minimises the rest
        self._direction = (
            "max" if (mode == "auto" and "acc" in monitor) else ("min" if mode == "auto" else mode)
        )
        self._warned_missing = False
        self.on_train_begin()

    def get_params(self, deep: bool = False) -> dict:
        return {
            "monitor": self.monitor,
            "min_delta": self.min_delta,
            "patience": self.patience,
            "mode": self.mode,
            "baseline": self.baseline,
            "restore_best_weights": self.restore_best_weights,
            "verbose": self.verbose,
            "start_from_epoch": self.start_from_epoch,
        }

    def on_train_begin(self) -> None:
        self.wait = 0
        self.stopped_epoch: typing.Optional[int] = None
        self.best = np.inf if self._direction == "min" else -np.inf
        if self.baseline is not None:
            self.best = float(self.baseline)
        self.best_params = None

    def _improved(self, value: float) -> bool:
        if self._direction == "min":
            return value < self.best - self._delta
        return value > self.best + self._delta

    def update(self, epoch: int, logs: typing.Dict[str, float], params) -> bool:
        if epoch < int(self.start_from_epoch):
            return False
        value = logs.get(self.monitor)
        if value is None:
            if self.monitor == "loss" or "loss" not in logs:
                return False
            if not self._warned_missing:
                logger.warning(
                    "EarlyStopping monitor %r unavailable (no validation split?); "
                    "monitoring 'loss' instead",
                    self.monitor,
                )
                self._warned_missing = True
                # the stand-in is a loss: a max-mode monitor turns to
                # minimising it
                if self._direction != "min":
                    self._direction = "min"
                    self.best = float(self.baseline) if self.baseline is not None else np.inf
            value = logs["loss"]
        if self._improved(float(value)):
            self.best = float(value)
            self.wait = 0
            if self.restore_best_weights:
                self.best_params = _snapshot(params)
            return False
        self.wait += 1
        if self.wait >= max(int(self.patience), 1):
            self.stopped_epoch = epoch
            if self.verbose:
                logger.info("EarlyStopping at epoch %d (best=%g)", epoch, self.best)
            return True
        return False

    def finalize(self, params):
        if (
            self.restore_best_weights
            and self.best_params is not None
            and self.stopped_epoch is not None
        ):
            return self.best_params
        return params


def fleet_fit_kwargs(fit_args: dict) -> typing.Optional[dict]:
    """
    An estimator's fit configuration (``validation_split`` and its
    ``callbacks``) as :meth:`FleetTrainer.fit` keyword arguments, or None
    when any of it has no exact fleet counterpart. Translatable: one
    EarlyStopping on a min-mode loss monitor with no baseline (its
    patience, min_delta, start_from_epoch and restore_best_weights), and a
    validation split (the trainer's per-machine holdout).
    """
    out: dict = {}
    split = float(fit_args.get("validation_split") or 0.0)
    if split > 0.0:
        out["validation_split"] = split
    from gordo_tpu_torch.models.core import _materialize_callbacks

    for cb in _materialize_callbacks(fit_args.get("callbacks")):
        if not isinstance(cb, EarlyStopping):
            return None
        if "loss" not in cb.monitor or cb._direction == "max" or cb.baseline is not None:
            return None
        if "early_stopping_patience" in out:
            return None  # two gates: the solo loop runs both; one gate cannot
        out.update(
            early_stopping_patience=int(cb.patience),
            early_stopping_min_delta=abs(float(cb.min_delta)),
            early_stopping_start_from_epoch=int(cb.start_from_epoch),
            restore_best_weights=bool(cb.restore_best_weights),
            early_stopping_on_val="val" in cb.monitor and split > 0.0,
        )
    return out
