"""
Windowed forward pass (the port of the windowed branch of
``gordo_tpu.parallel.fleet.FleetTrainer.predict``, for one machine).

The raw (rows, features) frame goes to the device once and the
(window, lookback, features) batches are gathered there, ``batch_size``
windows at a time, so a request never materialises more than
(batch_size, lookback, features) of windows. The JAX program pads the
last chunk to a fixed shape for its compiler; PyTorch runs eagerly, so
the last chunk is simply shorter.
"""

import torch
from torch import nn

from gordo_tpu_torch.ops.windowing import num_windows

#: windows per forward chunk, as in the JAX package
DEFAULT_BATCH_SIZE = 8192


@torch.inference_mode()
def windowed_predict(
    module: nn.Module,
    X: torch.Tensor,
    lookback_window: int,
    lookahead: int,
    batch_size: int = DEFAULT_BATCH_SIZE,
) -> torch.Tensor:
    """
    ``module`` over every window of ``X`` (rows, features):
    (n - lookback_window + 1 - lookahead, out) rows, row i from the
    window ``X[i : i + lookback_window]``.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    n_out = num_windows(len(X), lookback_window, lookahead)
    if n_out <= 0:
        raise ValueError(
            f"Not enough timesteps ({len(X)}) for "
            f"lookback_window={lookback_window}, lookahead={lookahead}"
        )
    offsets = torch.arange(lookback_window, device=X.device)[None, :]
    outs = []
    for start in range(0, n_out, batch_size):
        stop = min(start + batch_size, n_out)
        starts = torch.arange(start, stop, device=X.device)[:, None]
        out = module(X[starts + offsets])
        # a module may return (output, activity penalty)
        outs.append(out[0] if isinstance(out, tuple) else out)
    return outs[0] if len(outs) == 1 else torch.cat(outs)
