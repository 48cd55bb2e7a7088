"""
GRU autoencoder / forecast factories (the port of
``gordo_tpu.models.factories.gru``), registered under GRUAutoEncoder and
GRUForecast with the same kinds, arguments, defaults and checks. Same
windowed many-to-one contract and factory trio as the LSTM family.
"""

from typing import Any, Dict, Optional, Tuple, Union

from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import ModelSpec

from .lstm import recurrent_spec
from .utils import hourglass_calc_dims


@register_model_builder(type="GRUAutoEncoder")
@register_model_builder(type="GRUForecast")
def gru_model(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    encoding_dim: Tuple[int, ...] = (256, 128, 64),
    encoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    decoding_dim: Tuple[int, ...] = (64, 128, 256),
    decoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    fused: bool = False,
    time_unroll: int = 1,
    schedule: str = "layer",
    **kwargs,
) -> ModelSpec:
    """
    Stacked GRU encoder/decoder with a Dense head on the last timestep;
    ``fused``, ``schedule`` and ``time_unroll`` as for ``lstm_model``.
    """
    return recurrent_spec(
        "gru",
        n_features,
        n_features_out,
        lookback_window=lookback_window,
        encoding_dim=encoding_dim,
        encoding_func=encoding_func,
        decoding_dim=decoding_dim,
        decoding_func=decoding_func,
        out_func=out_func,
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        dtype=dtype,
        fused=fused,
        time_unroll=time_unroll,
        schedule=schedule,
    )


@register_model_builder(type="GRUAutoEncoder")
@register_model_builder(type="GRUForecast")
def gru_symmetric(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    dims: Tuple[int, ...] = (256, 128, 64),
    funcs: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    **kwargs,
) -> ModelSpec:
    """Symmetric stacked-GRU model."""
    if len(dims) == 0:
        raise ValueError("Parameter dims must have len > 0")
    return gru_model(
        n_features,
        n_features_out,
        lookback_window=lookback_window,
        encoding_dim=tuple(dims),
        decoding_dim=tuple(dims[::-1]),
        encoding_func=tuple(funcs),
        decoding_func=tuple(funcs[::-1]),
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        dtype=dtype,
        **kwargs,
    )


@register_model_builder(type="GRUAutoEncoder")
@register_model_builder(type="GRUForecast")
def gru_hourglass(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    **kwargs,
) -> ModelSpec:
    """Hourglass stacked-GRU model."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return gru_symmetric(
        n_features,
        n_features_out,
        lookback_window=lookback_window,
        dims=dims,
        funcs=tuple([func] * len(dims)),
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        dtype=dtype,
        **kwargs,
    )
