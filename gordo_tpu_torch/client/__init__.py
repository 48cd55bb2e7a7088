"""
The port's client (the counterpart of ``gordo_tpu.client``): batch
predictions, fleet predictions, scoring streams, metadata and model
downloads against the port's server or router, over ``http.client``
with the standard library and numpy (no ``requests``, no pandas).

``Client`` and ``make_date_ranges`` load on first use: ``io``, ``utils``,
``streaming`` and ``forwarders`` import no torch, and ``client`` imports
it only through the data layer it rebuilds datasets with.
"""

__all__ = ["Client", "make_date_ranges", "PredictionResult"]


def __getattr__(name):
    if name in ("Client", "make_date_ranges"):
        from gordo_tpu_torch.client import client

        return getattr(client, name)
    if name == "PredictionResult":
        from gordo_tpu_torch.client.utils import PredictionResult

        return PredictionResult
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
