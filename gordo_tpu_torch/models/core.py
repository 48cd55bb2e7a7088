"""
The estimator base (the port of ``gordo_tpu.models.core.BaseJaxEstimator``).

An estimator is named by ``kind`` (a registered factory) plus the factory
keyword arguments, exactly as in the JAX package, so one definition dict
describes a machine in either package. Its weights come from ``fit``, or
as a state dict of numpy arrays (``load_state_arrays``) from the port's
artifact or from ``gordo_tpu_torch.convert``.

``fit`` keeps the JAX fit's semantics (``gordo_tpu/models/core.py``):
fixed-size batches over ``ceil(n_train / batch_size)`` steps with the
ragged tail padded at weight 0, a shuffle (off by default for windowed
models) that permutes every padded slot, each step's loss
``Σ(per·w) / max(Σw, 1)`` plus the module's activity penalty, Keras
``validation_split`` holding out the last windows before any shuffle,
the Keras callbacks after each epoch (``EarlyStopping``,
``TerminateOnNaN``), and the same ``history_``. The optimizer is optax's
(``gordo_tpu_torch.models.optim``, the fleet trainer's too), bound to the
module's parameters. PyTorch runs eagerly, so an epoch is a Python loop
of steps; the host reads the loss once per epoch. Shuffles and
dropout masks come from one ``torch.Generator`` on the training device,
seeded with ``seed``; the initial weights from another on the CPU
(:meth:`BaseTorchEstimator._initial_state`), so they do not depend on
the device. Neither gives JAX's random numbers.
"""

import copy
import logging
import math
import threading
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.optim import BoundOptimizer
from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import ModelSpec, cast, flax_default_init_, per_sample_loss
from gordo_tpu_torch.ops.windowing import gather_windows
from gordo_tpu_torch.parallel.precision import cast_params

logger = logging.getLogger(__name__)

#: seed of a fit whose kwargs name none (the builder injects one)
DEFAULT_SEED = 0

#: fitted widths a padded-bucket artifact records beside its weights
_WIDTH_ATTRS = ("n_active_features_", "n_active_features_out_")
#: a calibrated build's serving precision and its measured MAE delta,
#: recorded beside the weights when the build calibrated the machine
_PRECISION_ATTRS = ("precision_", "precision_mae_delta_")

#: rows per forward chunk of a row-wise (non-windowed) predict, as in the
#: JAX package
PREDICT_CHUNK_ROWS = 10000


def _materialize_callbacks(raw) -> list:
    """
    The fit argument ``callbacks`` as :class:`~gordo_tpu_torch.models.
    callbacks.Callback` objects: objects as they are, definitions through
    the serializer. A definition of a callback the port does not have,
    or anything else, is dropped with a warning, as the JAX package
    drops it.
    """
    if not raw:
        return []
    from gordo_tpu_torch.models.callbacks import Callback
    from gordo_tpu_torch.serializer import callback_from_definition

    out = []
    for item in raw:
        if isinstance(item, Callback):
            out.append(item)
        elif isinstance(item, (dict, str)):
            try:
                out.append(callback_from_definition(item))
            except ValueError:
                name = item if isinstance(item, str) else next(iter(item), "?")
                logger.warning("Ignoring unsupported training callback %s", name)
        else:
            logger.warning(
                "Ignoring unsupported training callback object %s", type(item).__name__
            )
    return out


class NotFittedError(ValueError, AttributeError):
    """The estimator has no weights yet (sklearn's exception of that name)."""


class BaseTorchEstimator:
    """A registered factory's module plus its weights, on one device."""

    supported_fit_args = [
        "batch_size",
        "epochs",
        "verbose",
        "callbacks",
        "validation_split",
        "shuffle",
        "epoch_chunk",
        "class_weight",
        "initial_epoch",
        "steps_per_epoch",
        "validation_batch_size",
        "max_queue_size",
        "workers",
        "use_multiprocessing",
    ]

    @property
    def lookahead(self) -> int:
        return 0

    @property
    def _windowed(self) -> bool:
        return False

    def __init__(self, kind: Union[str, Callable], **kwargs) -> None:
        self.kind = self.load_kind(kind)
        self.kwargs = kwargs

    def clone(self) -> "BaseTorchEstimator":
        """An unfitted estimator of the same definition (sklearn's clone)."""
        return type(self)(self.kind, **copy.deepcopy(self.kwargs))

    # -- registry / definition protocol -----------------------------------
    @property
    def registry_type(self) -> str:
        return self.__class__.__name__

    def load_kind(self, kind):
        if callable(kind):
            register_model_builder(type=self.registry_type)(kind)
            return kind.__name__
        if kind not in register_model_builder.factories.get(self.registry_type, {}):
            raise ValueError(
                f"kind: {kind} is not an available model for type: "
                f"{self.registry_type}!"
            )
        return kind

    @classmethod
    def from_definition(cls, definition: dict):
        definition = copy.copy(definition)
        kind = definition.pop("kind")
        return cls(kind, **definition)

    def into_definition(self) -> dict:
        definition = copy.copy(self.kwargs)
        if definition.get("callbacks"):
            from gordo_tpu_torch.models.callbacks import Callback
            from gordo_tpu_torch.serializer import callback_into_definition

            # callback objects as their definitions; definitions as given
            definition["callbacks"] = [
                callback_into_definition(cb) if isinstance(cb, Callback) else cb
                for cb in definition["callbacks"]
            ]
        definition["kind"] = self.kind
        return {f"{type(self).__module__}.{type(self).__name__}": definition}

    @classmethod
    def extract_supported_fit_args(cls, kwargs) -> dict:
        return {k: kwargs[k] for k in cls.supported_fit_args if k in kwargs}

    def _build_spec(self) -> ModelSpec:
        build_fn = register_model_builder.factories[self.registry_type][self.kind]
        factory_kwargs = {
            k: v for k, v in self.kwargs.items() if k not in self.supported_fit_args
        }
        spec = build_fn(**factory_kwargs)
        if not isinstance(spec, ModelSpec):
            raise TypeError(
                f"Factory {self.kind!r} returned {type(spec)}, expected ModelSpec"
            )
        return spec

    # -- fit --------------------------------------------------------------
    def _initial_state(self, spec: ModelSpec, seed: int) -> Dict[str, torch.Tensor]:
        """The weights a fit with ``seed`` starts from: Flax's default
        initialisation, drawn on the CPU from a generator seeded with
        ``seed``."""
        flax_default_init_(spec.module, torch.Generator().manual_seed(seed))
        return spec.module.state_dict()

    def fit(self, X, y, *, device: DeviceLike = None, **kwargs) -> "BaseTorchEstimator":
        """
        Train on (X, y) on ``device`` (the card unless ``"cpu"`` is asked
        for). Fit arguments come from the estimator's kwargs, overridden
        by ``kwargs``: ``epochs`` (1), ``batch_size`` (32), ``shuffle``
        (False for windowed models), ``validation_split`` (0),
        ``callbacks`` (run after every epoch on its loss and validation
        loss; ``history_`` holds the epochs that ran) and the ``seed``
        kwarg (0).
        """
        X, y = as_2d(X), as_2d(y)
        self.kwargs.update({"n_features": X.shape[-1], "n_features_out": y.shape[-1]})
        fit_args = self.extract_supported_fit_args(self.kwargs)
        fit_args.update(kwargs)
        epochs = int(fit_args.get("epochs", 1))
        batch_size = int(fit_args.get("batch_size", 32))
        shuffle = bool(fit_args.get("shuffle", not self._windowed))
        seed = int(self.kwargs.get("seed", DEFAULT_SEED))
        validation_split = float(fit_args.get("validation_split") or 0.0)
        if not 0.0 <= validation_split < 1.0:
            raise ValueError(f"validation_split must be in [0, 1), got {validation_split}")
        callbacks = _materialize_callbacks(fit_args.get("callbacks"))
        device = resolve_device(device)

        spec = self._build_spec()
        lb = spec.lookback_window if spec.windowed else 1
        la = self.lookahead if spec.windowed else 0
        n_samples = len(X) - lb + 1 - la if spec.windowed else len(X)
        if n_samples <= 0:
            raise ValueError(
                f"Not enough samples ({len(X)}) for lookback_window={lb}, lookahead={la}"
            )
        # Keras validation_split: the LAST windows are held out, before any
        # shuffle
        n_val = int(n_samples * validation_split)
        n_train = n_samples - n_val
        if n_train <= 0:
            raise ValueError(
                f"validation_split={validation_split} leaves no training "
                f"samples (of {n_samples})"
            )

        module = spec.module
        module.load_state_dict(self._initial_state(spec, seed))
        module.to(device)
        optimizer = spec.make_optimizer(module.parameters())
        generator = torch.Generator(device=device).manual_seed(seed)

        n_batches = max(1, math.ceil(n_train / batch_size))
        n_pad = n_batches * batch_size
        ids = torch.zeros(n_pad, dtype=torch.int64, device=device)
        ids[:n_train] = torch.arange(n_train, device=device)
        weights = torch.zeros(n_pad, dtype=torch.float32, device=device)
        weights[:n_train] = 1.0
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(device)
        yd = torch.from_numpy(np.ascontiguousarray(y)).to(device)

        def gather(sel):
            if spec.windowed:
                return gather_windows(Xd, yd, sel, lb, la)
            return Xd[sel], yd[sel]

        for cb in callbacks:
            cb.on_train_begin()
        params = dict(module.named_parameters())
        losses: list = []
        val_losses: list = []
        for epoch in range(epochs):
            module.train()
            sel_all, w_all = ids, weights
            if shuffle:
                perm = torch.randperm(n_pad, generator=generator, device=device)
                sel_all, w_all = ids[perm], weights[perm]
            loss_sums = []
            for step in range(n_batches):
                part = slice(step * batch_size, (step + 1) * batch_size)
                xb, yb = gather(sel_all[part])
                loss_sums.append(
                    train_step(module, optimizer, spec.loss, xb, yb, w_all[part], generator)
                )
            # one host read per epoch
            losses.append((torch.stack(loss_sums).sum() / n_train).item())
            logs = {"loss": losses[-1]}
            if n_val:
                val_losses.append(
                    validation_loss(module, spec.loss, gather, n_train, n_samples, batch_size)
                )
                logs["val_loss"] = val_losses[-1]
            # every callback sees every epoch: one's stop must not hide the
            # epoch from the others
            if callbacks and any([cb.update(epoch, logs, params) for cb in callbacks]):
                break
        for cb in callbacks:
            final = cb.finalize(params)
            if final is not params:
                with torch.no_grad():
                    for name, value in final.items():
                        params[name].copy_(value)
            cb.best_params = None  # no snapshot outlives the fit
        module.eval()

        self.spec_ = spec
        self.device_ = device
        self.history_ = {
            "loss": losses,
            "params": {
                "epochs": epochs,
                "steps": n_batches,
                "batch_size": batch_size,
                "samples": n_train,
                "metrics": ["loss"] + (["val_loss"] if n_val else []),
            },
        }
        if n_val:
            self.history_["val_loss"] = val_losses
        self.n_features_ = X.shape[-1]
        self.n_features_out_ = y.shape[-1]
        return self

    def _set_fitted(
        self,
        spec: ModelSpec,
        state: Dict[str, np.ndarray],
        device: torch.device,
        n_features: int,
        n_features_out: int,
        history: Optional[dict] = None,
    ) -> "BaseTorchEstimator":
        """Take weights trained elsewhere (a fleet fit): ``state`` into
        ``spec``'s module on ``device``, in eval mode."""
        spec.module.load_state_dict({n: torch.as_tensor(np.asarray(v)) for n, v in state.items()})
        spec.module.to(device).eval()
        self.spec_ = spec
        self.device_ = device
        self.n_features_ = n_features
        self.n_features_out_ = n_features_out
        if history is not None:
            self.history_ = history
        return self

    def get_metadata(self) -> dict:
        return {"history": dict(self.history_)} if hasattr(self, "history_") else {}

    @torch.inference_mode()
    def predict(self, X, **kwargs) -> np.ndarray:
        """
        (rows, n_features_out) float32 outputs of a row-wise model, on the
        device the weights are on, ``PREDICT_CHUNK_ROWS`` rows at a time
        (in bfloat16 weights for a bf16 machine, :meth:`_forward`).
        """
        forward = self._forward()
        X = self._pad_active_input(as_2d(X))
        outs = []
        for start in range(0, len(X), PREDICT_CHUNK_ROWS):
            xb = torch.from_numpy(np.ascontiguousarray(X[start : start + PREDICT_CHUNK_ROWS]))
            outs.append(forward(xb.to(self.device_)).cpu().numpy())
        if not outs:
            return np.empty((0, self.n_features_out_), dtype=np.float32)
        return self._strip_pad_output(np.concatenate(outs))

    # -- weights ----------------------------------------------------------
    def load_state_arrays(
        self, arrays: Dict[str, np.ndarray], device: DeviceLike = None
    ) -> "BaseTorchEstimator":
        """
        Build the module from the definition and load ``arrays`` (the
        module's state dict as numpy, plus any recorded widths) onto
        ``device`` — the card unless ``"cpu"`` is asked for.
        """
        device = resolve_device(device)
        arrays = dict(arrays)
        for attr in _WIDTH_ATTRS:
            if attr in arrays:
                setattr(self, attr, int(arrays.pop(attr)))
        if "precision_" in arrays:
            self.precision_ = str(arrays.pop("precision_"))
            delta = arrays.pop("precision_mae_delta_", None)
            self.precision_mae_delta_ = None if delta is None else float(delta)
        spec = self._build_spec()
        spec.module.load_state_dict(
            {name: torch.tensor(np.asarray(value)) for name, value in arrays.items()}
        )
        spec.module.to(device).eval()
        self.spec_ = spec
        self.device_ = device
        self.n_features_ = self.kwargs["n_features"]
        self.n_features_out_ = self.kwargs.get("n_features_out") or self.n_features_
        return self

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """Inverse of :meth:`load_state_arrays`: host numpy copies."""
        module = self._fitted_module()
        arrays = {
            name: tensor.detach().cpu().numpy()
            for name, tensor in module.state_dict().items()
        }
        for attr in _WIDTH_ATTRS + _PRECISION_ATTRS:
            if getattr(self, attr, None) is not None:
                arrays[attr] = np.asarray(getattr(self, attr))
        return arrays

    def _forward(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """
        The fitted module as a function of its input, returning its output
        (without an activity penalty). For a machine calibrated to bf16
        (``precision_ == "bf16"``) it runs on the weights cast to bfloat16
        (cast once and kept) with the input cast to bfloat16, and returns
        float32: the JAX estimator's bf16 predict. ``functional_call``
        swaps the module's weights for the call, so such calls take a lock.
        """
        module = self._fitted_module()
        if getattr(self, "precision_", "float32") != "bf16":
            return lambda x: first_output(module(x))
        cached = self.__dict__.get("_bf16_weights")
        if cached is None or cached[0] is not module:
            cached = (module, cast_params(dict(module.state_dict()), torch.bfloat16),
                      threading.Lock())
            self._bf16_weights = cached
        _, weights, lock = cached

        def forward(x: torch.Tensor) -> torch.Tensor:
            with lock:
                out = functional_call(module, weights, (cast(x, torch.bfloat16),))
            return cast(first_output(out), torch.float32)

        return forward

    def _fitted_module(self) -> torch.nn.Module:
        if not hasattr(self, "spec_"):
            raise NotFittedError(
                f"This {self.__class__.__name__} has not been fitted yet."
            )
        return self.spec_.module

    # -- padded-bucket widths ---------------------------------------------
    def _pad_active_input(self, X: np.ndarray) -> np.ndarray:
        """Widen a real-width input to the module's width with zero pad
        columns (artifacts built into a padded program record their
        real width as ``n_active_features_``)."""
        n_active = getattr(self, "n_active_features_", None)
        f_prog = getattr(self, "n_features_", None)
        if (
            n_active is None
            or f_prog is None
            or X.shape[-1] != n_active
            or n_active >= f_prog
        ):
            return X
        pad = [(0, 0)] * (X.ndim - 1) + [(0, f_prog - n_active)]
        return np.pad(np.asarray(X), pad)

    def _strip_pad_output(self, out: np.ndarray) -> np.ndarray:
        """Drop inert pad columns from a padded program's output."""
        n_active_out = getattr(self, "n_active_features_out_", None)
        if n_active_out is None or out.shape[-1] <= n_active_out:
            return out
        return out[..., :n_active_out]

    def __repr__(self):
        return f"{self.__class__.__name__}(kind={self.kind!r})"


def train_step(
    module: torch.nn.Module,
    optimizer: BoundOptimizer,
    loss_name: str,
    xb: torch.Tensor,
    yb: torch.Tensor,
    wb: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """
    One optimizer step on a batch with per-sample weights ``wb``; the loss
    is ``Σ(per·w) / max(Σw, 1)`` plus the module's activity penalty when
    it returns ``(output, penalty)``. Returns ``Σ(per·w)``, detached, on
    the device (no host sync).
    """
    out = module(xb, generator=generator)
    out, penalty = out if isinstance(out, tuple) else (out, 0.0)
    loss_sum = (per_sample_loss(loss_name, out, yb) * wb).sum()
    loss = loss_sum / torch.clamp(wb.sum(), min=1.0) + penalty
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss_sum.detach()


@torch.no_grad()
def validation_loss(
    module: torch.nn.Module, loss_name: str, gather, n_train: int, n_samples: int,
    batch_size: int,
) -> float:
    """Mean per-sample loss over the held-out samples ``[n_train,
    n_samples)`` in eval mode, ``batch_size`` at a time."""
    was_training = module.training
    module.eval()
    device = next(module.parameters()).device
    total = torch.zeros((), device=device)
    for start in range(n_train, n_samples, batch_size):
        sel = torch.arange(start, min(start + batch_size, n_samples), device=device)
        xb, yb = gather(sel)
        out = module(xb)
        out = out[0] if isinstance(out, tuple) else out
        total += per_sample_loss(loss_name, out, yb).sum()
    module.train(was_training)
    return (total / (n_samples - n_train)).item()


def first_output(out):
    """A module's output without the activity penalty some modules
    return beside it."""
    return out[0] if isinstance(out, tuple) else out


def as_2d(X, dtype=np.float32) -> np.ndarray:
    """Frame or array -> a (rows, features) array of ``dtype``; with
    ``dtype=None`` float32 and float64 keep their type and anything else
    becomes float64."""
    X = np.asarray(getattr(X, "values", X), dtype=dtype)
    if dtype is None and X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    return X.reshape(len(X), 1) if X.ndim == 1 else X
