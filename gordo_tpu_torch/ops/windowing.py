"""
Sliding-window index math for sequence models (the part of
``gordo_tpu.ops.windowing`` the port needs, in its own copy).

For data of length ``n``, lookback ``lb`` and lookahead ``la``:

- number of samples  = ``n - lb + 1 - la``
- sample ``i`` sees rows ``[i, i + lb)`` of X
- sample ``i`` targets row ``i + lb - 1 + la`` of y

so ``la=0`` targets the window's last element (autoencoder) and ``la=1``
one step past the window (forecast).

:func:`windowed_predict` is one machine's windowed forward pass (the
windowed branch of ``gordo_tpu.parallel.fleet.FleetTrainer.predict``).
"""

import torch
from torch import nn


def num_windows(n: int, lookback_window: int, lookahead: int) -> int:
    """Number of (window, target) samples derivable from n timesteps."""
    if lookahead < 0:
        raise ValueError(f"Value of `lookahead` can not be negative, is {lookahead}")
    return n - lookback_window + 1 - lookahead


def gather_windows(X, y, sel, lookback_window: int, lookahead: int):
    """
    The training gather, on the device of its inputs: sample ids ``sel``
    (batch,) -> (windows (batch, lookback_window, features) of ``X``,
    targets (batch, targets) of ``y``), window ``i`` rows
    ``[i, i + lookback_window)`` and target row
    ``i + lookback_window - 1 + lookahead``.
    """
    offsets = torch.arange(lookback_window, device=sel.device)
    return X[sel[:, None] + offsets[None, :]], y[sel + (lookback_window - 1 + lookahead)]


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
    window ``X[i : i + lookback_window]``, ``batch_size`` windows at a
    time, gathered on X's device (the JAX program pads the last chunk to
    a fixed shape for its compiler; here the last chunk is shorter).
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
