"""
Sliding-window index math for sequence models (the part of
``gordo_tpu.ops.windowing`` the port needs, in its own copy).

For data of length ``n``, lookback ``lb`` and lookahead ``la``:

- number of samples  = ``n - lb + 1 - la``
- sample ``i`` sees rows ``[i, i + lb)`` of X
- sample ``i`` targets row ``i + lb - 1 + la`` of y

so ``la=0`` targets the window's last element (autoencoder) and ``la=1``
one step past the window (forecast).
"""

import torch


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
