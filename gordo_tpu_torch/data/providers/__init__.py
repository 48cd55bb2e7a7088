"""
Data providers: sources of raw tag series.

- ``RandomDataProvider``: deterministic random series;
- ``FileSystemProvider``: CSV files of a lake directory, a file per tag
  (and year);
- ``LongFormatProvider``: melted ``(tag, time, value)`` CSV files, in
  date directories or not;
- ``CompoundProvider``: sub-providers, each tag read by the first that
  claims it;
- ``DataLakeProvider``: the provider of a config whose ``data_provider``
  is null (the lake through the file-system provider; random data when
  no lake directory is configured).
"""

from .base import GordoBaseDataProvider
from .compound import CompoundProvider, DataLakeProvider, NoSuitableDataProviderError
from .filesystem import FileSystemProvider
from .longformat import LongFormatProvider
from .random_provider import RandomDataProvider

#: the providers a config may name, by class name
PROVIDERS = {
    cls.__name__: cls
    for cls in (RandomDataProvider, FileSystemProvider, LongFormatProvider, CompoundProvider,
                DataLakeProvider)
}

__all__ = [
    "GordoBaseDataProvider",
    "RandomDataProvider",
    "FileSystemProvider",
    "LongFormatProvider",
    "CompoundProvider",
    "DataLakeProvider",
    "NoSuitableDataProviderError",
    "PROVIDERS",
]
