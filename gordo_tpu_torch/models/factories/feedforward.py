"""
Feedforward autoencoder factories (the port of
``gordo_tpu.models.factories.feedforward``), registered under
``AutoEncoder`` with the same kinds, arguments, defaults and checks.
"""

from typing import Any, Dict, Optional, Tuple, Union

from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import FeedForwardNet, ModelSpec, resolve_dtype

from .utils import check_dim_func_len, hourglass_calc_dims


@register_model_builder(type="AutoEncoder")
def feedforward_model(
    n_features: int,
    n_features_out: Optional[int] = None,
    encoding_dim: Tuple[int, ...] = (256, 128, 64),
    encoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    decoding_dim: Tuple[int, ...] = (64, 128, 256),
    decoding_func: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    **kwargs,
) -> ModelSpec:
    """Encoder/decoder Dense stack; the L1 activity penalty applies to
    every encoder layer after the first."""
    n_features_out = n_features_out or n_features
    check_dim_func_len("encoding", encoding_dim, encoding_func)
    check_dim_func_len("decoding", decoding_dim, decoding_func)
    layer_dims = tuple(encoding_dim) + tuple(decoding_dim)
    module = FeedForwardNet(
        n_features=n_features,
        layer_dims=layer_dims,
        layer_funcs=tuple(encoding_func) + tuple(decoding_func),
        l1_flags=tuple(0 < i < len(encoding_dim) for i in range(len(layer_dims))),
        out_dim=n_features_out,
        out_func=out_func,
        l1=1e-4,
        dtype=resolve_dtype(dtype),
    )
    return ModelSpec(
        module=module,
        optimizer=optimizer,
        optimizer_kwargs=dict(optimizer_kwargs),
        loss=dict(compile_kwargs).get("loss", "mse"),
    )


@register_model_builder(type="AutoEncoder")
def feedforward_symmetric(
    n_features: int,
    n_features_out: Optional[int] = None,
    dims: Tuple[int, ...] = (256, 128, 64),
    funcs: Tuple[str, ...] = ("tanh", "tanh", "tanh"),
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    **kwargs,
) -> ModelSpec:
    """Symmetric stack: the encoder dims mirrored for the decoder."""
    if len(dims) == 0:
        raise ValueError("Parameter dims must have len > 0")
    return feedforward_model(
        n_features,
        n_features_out,
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


@register_model_builder(type="AutoEncoder")
def feedforward_hourglass(
    n_features: int,
    n_features_out: Optional[int] = None,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    **kwargs,
) -> ModelSpec:
    """Hourglass net: dims shrink linearly into the bottleneck and mirror
    out."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return feedforward_symmetric(
        n_features,
        n_features_out,
        dims=dims,
        funcs=tuple([func] * len(dims)),
        optimizer=optimizer,
        optimizer_kwargs=optimizer_kwargs,
        compile_kwargs=compile_kwargs,
        dtype=dtype,
        **kwargs,
    )
