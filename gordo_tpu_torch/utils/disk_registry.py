"""
A file-per-key registry on disk, the index of the model build cache (the
port of ``gordo_tpu.utils.disk_registry``): ``write_key``, ``get_value``
and ``delete_value``, each key a file named by the key under the
registry directory, holding its value as text.
"""

import logging
import os
import re
from pathlib import Path
from typing import Optional, Union

logger = logging.getLogger(__name__)

#: a key is a file name: letters, digits, '_', '.', '-', and not '.' or '..'
_VALID_KEY = re.compile(r"^(?!\.\.?\Z)[A-Za-z0-9_.\-]+\Z")

PathLike = Union[os.PathLike, str]


def _key_path(registry_dir: PathLike, key: str) -> Path:
    if not _VALID_KEY.match(key):
        raise ValueError(
            f"Key {key!r} is not a valid registry key (allowed: letters, digits, '_', '.', '-')"
        )
    return Path(registry_dir) / key


def write_key(registry_dir: PathLike, key: str, val: str) -> None:
    """Store ``val`` under ``key``, creating the registry directory if
    needed; an existing value is overwritten, with a warning."""
    path = _key_path(registry_dir, key)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        logger.warning("Overwriting existing registry key %s", key)
    path.write_text(str(val))


def get_value(registry_dir: PathLike, key: str) -> Optional[str]:
    """The value stored under ``key``; None when there is none."""
    path = _key_path(registry_dir, key)
    return path.read_text() if path.is_file() else None


def delete_value(registry_dir: PathLike, key: str) -> bool:
    """Delete ``key``; whether there was something to delete."""
    path = _key_path(registry_dir, key)
    if path.is_file():
        path.unlink()
        return True
    return False
