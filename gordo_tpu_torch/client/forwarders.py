"""
Prediction forwarders (the port of ``gordo_tpu.client.forwarders``):
sinks the client calls with each answered chunk.

A :class:`PredictionForwarder` subclass writes :meth:`forward`; calling
the forwarder runs it under a ``client.forward`` span, which the client's
threads open under the chunk's ``client.request`` span, so the hop keeps
the trace id. :class:`ForwardPredictionsIntoInflux` needs the
``influxdb`` package, which the port does not use: it raises at
construction, naming it (ROADMAP.md queue 3 item 1 (j)).
"""

import abc

from gordo_tpu_torch.observability import tracing


class PredictionForwarder(metaclass=abc.ABCMeta):
    """
    Called by :class:`gordo_tpu_torch.client.Client` after each answered
    chunk, as the JAX forwarder is::

        forwarder(predictions=<frame>, machine=<Machine>, metadata=<dict>,
                  resampled_sensor_data=<frame>)
    """

    def __call__(self, *, predictions=None, machine=None, metadata: dict = None,
                 resampled_sensor_data=None):
        with tracing.start_span(
            "client.forward", machine=machine.name if machine is not None else None
        ):
            return self.forward(predictions=predictions, machine=machine,
                                metadata=metadata if metadata is not None else {},
                                resampled_sensor_data=resampled_sensor_data)

    @abc.abstractmethod
    def forward(self, *, predictions=None, machine=None, metadata: dict = None,
                resampled_sensor_data=None):
        """Write one chunk's frames somewhere."""


class ForwardPredictionsIntoInflux(PredictionForwarder):
    """Refused: writing to Influx needs the ``influxdb`` package."""

    def __init__(self, *args, **kwargs):
        raise ImportError(
            "ForwardPredictionsIntoInflux needs the 'influxdb' package, which this port "
            "does not use; write predictions with another PredictionForwarder "
            "(ROADMAP.md queue 3 item 1 (j))"
        )

    def forward(self, **kwargs):  # pragma: no cover - never constructed
        raise NotImplementedError
