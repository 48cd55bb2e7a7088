"""
LSTM autoencoder / forecast factories (the port of
``gordo_tpu.models.factories.lstm``), registered under LSTMAutoEncoder
and LSTMForecast with the same kinds, arguments, defaults and checks.
"""

from typing import Any, Dict, Optional, Tuple, Union

from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import LSTMNet, ModelSpec, resolve_dtype

from .utils import check_dim_func_len, hourglass_calc_dims


def recurrent_spec(
    cell: str,
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
) -> ModelSpec:
    """Shared builder behind the lstm_* and gru_* factory trios."""
    n_features_out = n_features_out or n_features
    check_dim_func_len("encoding", encoding_dim, encoding_func)
    check_dim_func_len("decoding", decoding_dim, decoding_func)
    module = LSTMNet(
        n_features=n_features,
        layer_dims=tuple(encoding_dim) + tuple(decoding_dim),
        layer_funcs=tuple(encoding_func) + tuple(decoding_func),
        out_dim=n_features_out,
        out_func=out_func,
        cell=cell,
        fused=fused,
        time_unroll=int(time_unroll),
        schedule=schedule,
        dtype=resolve_dtype(dtype),
    )
    return ModelSpec(
        module=module,
        optimizer=optimizer,
        optimizer_kwargs=dict(optimizer_kwargs),
        loss=dict(compile_kwargs).get("loss", "mse"),
        windowed=True,
        lookback_window=lookback_window,
    )


@register_model_builder(type="LSTMAutoEncoder")
@register_model_builder(type="LSTMForecast")
def lstm_model(
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
    Stacked LSTM encoder/decoder with a Dense head on the last timestep.
    ``fused=True`` hoists the input projections out of the time loop
    (``FusedLSTMLayer``); ``schedule="stacked"`` (fused only) steps all
    layers in one time loop. ``time_unroll`` is kept for the definition
    and does not change the port's loop.
    """
    return recurrent_spec(
        "lstm",
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


@register_model_builder(type="LSTMAutoEncoder")
@register_model_builder(type="LSTMForecast")
def lstm_symmetric(
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
    """Symmetric stacked-LSTM model: the encoder dims mirrored for the
    decoder."""
    if len(dims) == 0:
        raise ValueError("Parameter dims must have len > 0")
    return lstm_model(
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


@register_model_builder(type="LSTMAutoEncoder")
@register_model_builder(type="LSTMForecast")
def lstm_hourglass(
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
    """Hourglass stacked-LSTM model: dims shrink linearly into the
    bottleneck and mirror out."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return lstm_symmetric(
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
