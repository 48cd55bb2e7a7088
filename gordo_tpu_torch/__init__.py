"""
gordo-tpu on PyTorch and CUDA: the port of ``gordo_tpu`` to one NVIDIA
Hopper card, growing slice by slice beside the JAX package it mirrors.

Module names follow ``gordo_tpu`` so each counterpart is easy to find;
the code inside is PyTorch idiom (``nn.Module``s, tensor functions, an
explicit ``device``). Every kernel that ``gordo_tpu`` wrote in Pallas for
the TPU is a kernel written by hand for Hopper here (``csrc/``).

Slices in place: building (cross-validation, thresholds, fit) and
serving over HTTP one ``DiffBasedAnomalyDetector`` around a Transformer
(``TransformerAutoEncoder`` / ``TransformerForecast``), with every
attention call on the flash path going through the hand-written forward
kernel and, in training, the two backward kernels
(``ops/flash_attention.py``); and the default pipeline
(``Pipeline(MinMaxScaler, AutoEncoder)`` in the detector) built from a
machine config by ``python -m gordo_tpu_torch.cli build``, its data
fetched and resampled by the numpy data layer; the LSTM, GRU and TCN
families, the raw regressor and the ``InfImputer`` and
``FunctionTransformer`` steps; and the config layer, which reads the
repo's YAML project configs without PyYAML and builds a whole project
in one process (``builder.local_build``).

Layer map:

- ``gordo_tpu_torch.cli``         — ``build`` and ``run-server`` commands
- ``gordo_tpu_torch.workflow``    — the YAML reader, project configs
- ``gordo_tpu_torch.machine``     — the machine unit, validators, metadata
- ``gordo_tpu_torch.device``      — the device an entry point runs on
- ``gordo_tpu_torch.data``        — datasets, providers, resample and join
- ``gordo_tpu_torch.ops``         — activations, windowing, kernels
- ``gordo_tpu_torch.models``      — modules, estimators, pipeline, detector
- ``gordo_tpu_torch.parallel``    — chunked windowed predict
- ``gordo_tpu_torch.builder``     — builds a machine, or a project, into artifacts
- ``gordo_tpu_torch.serializer``  — the port's artifact format
- ``gordo_tpu_torch.convert``     — carries Flax weights into a port artifact
- ``gordo_tpu_torch.server``      — stdlib WSGI/JSON model server
- ``gordo_tpu_torch.utils``       — frequency aliases, ``capture_args``

The package imports torch, numpy and the standard library only.
"""

from gordo_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
