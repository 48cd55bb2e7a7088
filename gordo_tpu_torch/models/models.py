"""
Concrete estimator classes (the port of ``gordo_tpu.models.models``):
the feedforward ``AutoEncoder`` and the windowed Transformer, LSTM and
GRU estimators, with the reference's ``Keras*`` class names as aliases.
"""

from typing import Callable, Union

import numpy as np
import torch

from gordo_tpu_torch.device import DeviceLike
from gordo_tpu_torch.models.core import BaseTorchEstimator, as_2d
from gordo_tpu_torch.models.utils import explained_variance_score
from gordo_tpu_torch.parallel.fleet import windowed_predict

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


# the reference's class names
KerasAutoEncoder = AutoEncoder
KerasLSTMBaseEstimator = WindowedEstimator
KerasLSTMAutoEncoder = LSTMAutoEncoder
KerasLSTMForecast = LSTMForecast
