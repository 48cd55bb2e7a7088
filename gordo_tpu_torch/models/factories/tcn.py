"""
TCN factory (the port of ``gordo_tpu.models.factories.tcn``), registered
under TCNAutoEncoder and TCNForecast with the same signature, defaults
and check.
"""

from typing import Any, Dict, Optional, Tuple, Union

from gordo_tpu_torch.models.register import register_model_builder
from gordo_tpu_torch.models.specs import ModelSpec, resolve_dtype
from gordo_tpu_torch.models.specs_seq import TCNNet, default_dilations


@register_model_builder(type="TCNAutoEncoder")
@register_model_builder(type="TCNForecast")
def tcn_model(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    channels: Tuple[int, ...] = (64, 64, 64),
    kernel_size: int = 3,
    dilations: Optional[Tuple[int, ...]] = None,
    dropout: float = 0.1,
    func: str = "relu",
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Dict[str, Any] = dict(),
    compile_kwargs: Dict[str, Any] = dict(),
    dtype: Union[str, Any] = "float32",
    **kwargs,
) -> ModelSpec:
    """
    A stack of dilated causal convolution blocks, one per entry of
    ``channels``; ``dilations`` default to 1, 2, 4, ...
    """
    n_features_out = n_features_out or n_features
    dilations = tuple(dilations) if dilations is not None else default_dilations(len(channels))
    if len(dilations) != len(channels):
        raise ValueError(
            f"channels ({len(channels)}) and dilations ({len(dilations)}) "
            "must have the same length"
        )
    module = TCNNet(
        n_features=n_features,
        channels=tuple(channels),
        kernel_size=kernel_size,
        dilations=dilations,
        out_dim=n_features_out,
        dropout=dropout,
        func=func,
        out_func=out_func,
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
