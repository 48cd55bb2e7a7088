"""
Concrete estimator classes (the port of ``gordo_tpu.models.models``):
the feedforward ``AutoEncoder``, the windowed Transformer, TCN, LSTM and
GRU estimators and ``RawModelRegressor``, with the reference's ``Keras*``
class names as aliases.
"""

from pprint import pformat
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.core import BaseTorchEstimator, as_2d
from gordo_tpu_torch.models.specs import ModelSpec, SequentialNet, resolve_dtype, resolve_optimizer
from gordo_tpu_torch.models.utils import explained_variance_score
from gordo_tpu_torch.ops.windowing import windowed_predict

# register the factories on import
from gordo_tpu_torch.models import factories  # noqa: F401


class AutoEncoder(BaseTorchEstimator):
    """Feedforward autoencoder, scored by the explained variance of its
    reconstruction."""

    def score(self, X, y, sample_weight=None) -> float:
        return explained_variance_score(np.asarray(getattr(y, "values", y)), self.predict(X))

    def transform(self, X) -> np.ndarray:
        return self.predict(X)


class WindowedEstimator(BaseTorchEstimator):
    """
    Many-to-one windowed base (the counterpart of ``LSTMBaseEstimator``).
    Samples are sliding windows of ``lookback_window`` rows; the target
    row is offset by ``lookahead`` (0 = reconstruct the window's end,
    1 = forecast the next step).
    """

    def __init__(
        self,
        kind: Union[Callable, str],
        lookback_window: int = 1,
        batch_size: int = 32,
        **kwargs,
    ) -> None:
        kwargs["lookback_window"] = lookback_window
        kwargs["batch_size"] = batch_size
        super().__init__(kind, **kwargs)
        self.lookback_window = lookback_window
        self.batch_size = batch_size

    @property
    def lookahead(self) -> int:
        raise NotImplementedError()

    @property
    def _windowed(self) -> bool:
        return True

    def fit(self, X, y, *, device: DeviceLike = None, **kwargs) -> "WindowedEstimator":
        X, y = as_2d(X), as_2d(y)
        if len(X) < self.lookback_window + self.lookahead:
            raise ValueError(
                f"Found {len(X)} timesteps; need at least "
                f"lookback_window + lookahead = "
                f"{self.lookback_window + self.lookahead}"
            )
        return super().fit(X, y, device=device, **kwargs)

    def score(self, X, y, sample_weight=None) -> float:
        """Explained variance of the predictions against y's tail."""
        out = self.predict(X)
        return explained_variance_score(as_2d(y)[-len(out):], out)

    def get_metadata(self) -> dict:
        metadata = super().get_metadata()
        metadata["forecast_steps"] = self.lookahead
        return metadata

    def predict(self, X, **kwargs) -> np.ndarray:
        """
        (n - lookback_window + 1 - lookahead, n_features_out) float32
        predictions; row i predicts the window ending at
        ``X[i + lookback_window - 1 + lookahead]``. The rows go to the
        device once and the windows are gathered there.
        """
        module = self._fitted_module()
        X = self._pad_active_input(as_2d(X))
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(self.device_)
        out = windowed_predict(module, Xd, self.lookback_window, self.lookahead)
        return self._strip_pad_output(out.cpu().numpy())


class LSTMAutoEncoder(WindowedEstimator):
    """Stacked-LSTM window-end reconstructor."""

    @property
    def lookahead(self) -> int:
        return 0


class LSTMForecast(WindowedEstimator):
    """Stacked-LSTM 1-step-ahead forecaster."""

    @property
    def lookahead(self) -> int:
        return 1


class GRUAutoEncoder(WindowedEstimator):
    """Stacked-GRU window-end reconstructor."""

    @property
    def lookahead(self) -> int:
        return 0


class GRUForecast(WindowedEstimator):
    """Stacked-GRU 1-step-ahead forecaster."""

    @property
    def lookahead(self) -> int:
        return 1


class TransformerAutoEncoder(WindowedEstimator):
    """Transformer-encoder window reconstructor."""

    @property
    def lookahead(self) -> int:
        return 0


class TransformerForecast(WindowedEstimator):
    """Transformer-encoder 1-step-ahead forecaster."""

    @property
    def lookahead(self) -> int:
        return 1


class TCNAutoEncoder(WindowedEstimator):
    """Dilated causal convolution (TCN) window-end reconstructor."""

    @property
    def lookahead(self) -> int:
        return 0


class TCNForecast(WindowedEstimator):
    """TCN 1-step-ahead forecaster."""

    @property
    def lookahead(self) -> int:
        return 1


# layer path/name -> SequentialNet layer kind
_RAW_LAYER_KINDS = {
    "dense": "dense",
    "lstm": "lstm",
    "dropout": "dropout",
    "activation": "activation",
    "flatten": "flatten",
}


def _parse_raw_layer(entry: Union[str, Dict[str, Any]]) -> Tuple[str, Tuple]:
    """One raw-spec layer entry -> (kind, its kwargs as sorted pairs); the
    last part of a class path names the kind (``Dense``,
    ``tensorflow.keras.layers.Dense``)."""
    if isinstance(entry, str):
        path, kwargs = entry, {}
    elif isinstance(entry, dict) and len(entry) == 1:
        path, kwargs = next(iter(entry.items()))
        kwargs = dict(kwargs or {})
    else:
        raise ValueError(f"Cannot parse raw layer entry: {entry!r}")
    name = path.rsplit(".", 1)[-1].lower()
    if name not in _RAW_LAYER_KINDS:
        raise ValueError(
            f"Unsupported raw layer type {path!r}; supported: {sorted(_RAW_LAYER_KINDS)}"
        )
    return _RAW_LAYER_KINDS[name], tuple(sorted(kwargs.items()))


class RawModelRegressor(AutoEncoder):
    """
    An estimator built from a raw architecture config (``kind``)::

        compile:
          loss: mse
          optimizer: adam
        spec:
          layers:
            - Dense: {units: 4, activation: tanh}
            - Dense: {units: 1}

    A legacy spec nested under ``tensorflow.keras.models.Sequential``
    with ``tensorflow.keras.layers.*`` paths reads the same way: the last
    part of a path selects the layer kind.
    """

    _expected_keys = ("spec", "compile")

    def load_kind(self, kind):
        return kind

    def __repr__(self):
        return f"{self.__class__.__name__}(kind: {pformat(self.kind)})"

    def _build_spec(self) -> ModelSpec:
        if not all(k in self.kind for k in self._expected_keys):
            raise ValueError(
                f"Expected spec to have keys: {self._expected_keys}, "
                f"but found {list(self.kind)}"
            )
        spec_cfg = self.kind["spec"]
        # unwrap a legacy {"...Sequential": {"layers": [...]}} nesting
        if isinstance(spec_cfg, dict) and "layers" not in spec_cfg and len(spec_cfg) == 1:
            spec_cfg = next(iter(spec_cfg.values()))
        layers = tuple(_parse_raw_layer(entry) for entry in spec_cfg["layers"])

        compile_cfg = dict(self.kind.get("compile") or {})
        optimizer = compile_cfg.get("optimizer", "Adam")
        optimizer_kwargs = dict(compile_cfg.get("optimizer_kwargs", {}))
        if isinstance(optimizer, dict) and len(optimizer) == 1:
            path, okw = next(iter(optimizer.items()))
            optimizer = path.rsplit(".", 1)[-1]
            optimizer_kwargs.update(okw or {})
        module = SequentialNet(
            self.kwargs["n_features"], layers,
            dtype=resolve_dtype(self.kwargs.get("dtype", "float32")),
        )
        resolve_optimizer(optimizer, optimizer_kwargs)  # a clear config error, early
        return ModelSpec(
            module=module,
            optimizer=optimizer,
            optimizer_kwargs=optimizer_kwargs,
            loss=compile_cfg.get("loss", "mse"),
        )


# the reference's class names
KerasAutoEncoder = AutoEncoder
KerasLSTMBaseEstimator = WindowedEstimator
KerasLSTMAutoEncoder = LSTMAutoEncoder
KerasLSTMForecast = LSTMForecast
KerasRawModelRegressor = RawModelRegressor
