"""
Data providers: sources of raw tag series.

- ``RandomDataProvider``: deterministic random series;
- ``DataLakeProvider``: the provider of a config whose ``data_provider``
  is null (random data when no lake directory is configured).
"""

from .base import GordoBaseDataProvider
from .compound import DataLakeProvider, NoSuitableDataProviderError
from .random_provider import RandomDataProvider

#: the providers a config may name, by class name
PROVIDERS = {cls.__name__: cls for cls in (RandomDataProvider, DataLakeProvider)}

__all__ = [
    "GordoBaseDataProvider",
    "RandomDataProvider",
    "DataLakeProvider",
    "NoSuitableDataProviderError",
    "PROVIDERS",
]
