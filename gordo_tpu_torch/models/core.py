"""
The estimator base (the port of ``gordo_tpu.models.core.BaseJaxEstimator``,
predict half).

An estimator is named by ``kind`` (a registered factory) plus the factory
keyword arguments, exactly as in the JAX package, so one definition dict
describes a machine in either package. Its weights come in as a state
dict of numpy arrays (``load_state_arrays``), from the port's artifact or
from ``gordo_tpu_torch.convert``; ``fit`` arrives with the training slice.
"""

import copy
from typing import Callable, Dict, Union

import numpy as np
import torch

from gordo_tpu_torch.device import DeviceLike, resolve_device
from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import ModelSpec

#: fitted widths a padded-bucket artifact records beside its weights
_WIDTH_ATTRS = ("n_active_features_", "n_active_features_out_")


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

    def __init__(self, kind: Union[str, Callable], **kwargs) -> None:
        self.kind = self.load_kind(kind)
        self.kwargs = kwargs

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
        definition["kind"] = self.kind
        return {f"{type(self).__module__}.{type(self).__name__}": definition}

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
        spec = self._build_spec()
        spec.module.load_state_dict(
            {name: torch.from_numpy(np.asarray(value)) for name, value in arrays.items()}
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
        for attr in _WIDTH_ATTRS:
            if getattr(self, attr, None) is not None:
                arrays[attr] = np.asarray(getattr(self, attr))
        return arrays

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


def as_2d(X, dtype=np.float32) -> np.ndarray:
    """Frame or array -> a (rows, features) array of ``dtype``."""
    X = np.asarray(getattr(X, "values", X), dtype=dtype)
    return X.reshape(len(X), 1) if X.ndim == 1 else X
