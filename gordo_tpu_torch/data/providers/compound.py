"""
Provider resolution for configs (the port of
``gordo_tpu.data.providers.compound``).

A dataset whose ``data_provider`` is null reads through a
``DataLakeProvider``, as in the JAX package. With no lake directory
(``GORDO_TPU_LAKE_DIR`` or ``base_dir``) it serves random data with the
same warning as the JAX package: this is the reference's own data
semantics for a machine with no lake, not a change of device. A lake
directory needs the file-system provider, which reads parquet; the
card's machine has no parquet reader, so that raises until it is ported.
"""

import logging
import os
from typing import Optional

from gordo_tpu_torch.data.providers.random_provider import RandomDataProvider

logger = logging.getLogger(__name__)

LAKE_DIR_ENV_VAR = "GORDO_TPU_LAKE_DIR"


class NoSuitableDataProviderError(ValueError):
    """No configured provider can handle a requested tag. Raised by the
    compound provider, which is not ported yet; it keeps its exit code in
    the build command's table."""


class DataLakeProvider(RandomDataProvider):
    """The legacy lake provider name; ``storename``, ``interactive`` and
    the other reference kwargs are accepted and ignored."""

    WIRE_MODULE = "compound"

    def __init__(self, base_dir: Optional[str] = None, threads: int = 10, **kwargs):
        base_dir = base_dir or os.environ.get(LAKE_DIR_ENV_VAR)
        if base_dir:
            raise NotImplementedError(
                f"Reading the lake at {base_dir!r} needs the file-system provider, "
                "which is not ported yet (ROADMAP.md queue 1: file, object-store "
                "and Influx providers)"
            )
        logger.warning(
            "DataLakeProvider: no lake directory configured (set %s or "
            "base_dir); falling back to RandomDataProvider",
            LAKE_DIR_ENV_VAR,
        )
        super().__init__()
        # the arguments as given, for to_dict
        self._params = {"base_dir": base_dir, "threads": threads, **kwargs}
