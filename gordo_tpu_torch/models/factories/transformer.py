"""
Transformer encoder factory (the port of
``gordo_tpu.models.factories.transformer``), registered under
TransformerAutoEncoder / TransformerForecast with the same signature and
defaults: ``dropout`` goes into the module, the optimizer arguments and
``compile_kwargs["loss"]`` into the spec.
"""

from typing import Any, Dict, Optional, Union

from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import ModelSpec, resolve_dtype
from gordo_tpu_torch.models.specs_seq import ATTENTION_IMPLS, TransformerNet


@register_model_builder(type="TransformerAutoEncoder")
@register_model_builder(type="TransformerForecast")
def transformer_model(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    d_model: int = 64,
    n_heads: int = 4,
    n_layers: int = 2,
    ff_dim: Optional[int] = None,
    dropout: float = 0.1,
    causal: bool = True,
    attention_impl: str = "dense",
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    **kwargs,
) -> ModelSpec:
    """
    Encoder-only Transformer over the lookback window.

    ``attention_impl``: "dense" (plain einsum) or "flash" (the
    hand-written CUDA kernel).
    """
    n_features_out = n_features_out or n_features
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attention_impl must be one of {ATTENTION_IMPLS}, got {attention_impl!r}"
        )
    module = TransformerNet(
        n_features=n_features,
        d_model=d_model,
        n_heads=n_heads,
        n_layers=n_layers,
        ff_dim=ff_dim or 4 * d_model,
        out_dim=n_features_out,
        causal=causal,
        attention_impl=attention_impl,
        out_func=out_func,
        dtype=resolve_dtype(dtype),
        dropout=dropout,
    )
    return ModelSpec(
        module=module,
        optimizer=optimizer,
        optimizer_kwargs=dict(optimizer_kwargs),
        loss=dict(compile_kwargs).get("loss", "mse"),
        windowed=True,
        lookback_window=lookback_window,
    )
