"""
Atomic file-system publication (the port of ``gordo_tpu.utils.atomic``).

A reader (the server polling a build report, a resuming build loading an
artifact, a resumed fit reading its checkpoint) sees the old complete
state or the new complete state, never a torn one. Every helper stages
in the destination's own directory (``os.replace`` and ``os.link`` are
atomic only within one file system) and removes its staging entry when
it fails, so a crash leaves at worst a dot file that readers ignore.
"""

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional, Union

PathLike = Union[str, os.PathLike]


def _staged(path: Path, write: Callable[[Any], None], mode: str, publish) -> Path:
    """Write a sibling temp file of ``path`` with ``write`` and publish it
    with ``publish(tmp, path)``; the temp file never outlives a failure."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.tmp-")
    try:
        with os.fdopen(fd, mode) as fh:
            write(fh)
        publish(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_bytes(path: PathLike, payload: bytes) -> Path:
    """Publish ``payload`` at ``path`` (write a temp file, then replace);
    parent directories are created as needed."""
    return _staged(Path(path), lambda fh: fh.write(payload), "wb", os.replace)


def _dump_json(payload, indent, sort_keys, default, trailing_newline):
    def write(fh):
        json.dump(payload, fh, indent=indent, sort_keys=sort_keys, default=default)
        if trailing_newline:
            fh.write("\n")

    return write


def atomic_write_json(
    path: PathLike,
    payload: Any,
    *,
    indent: Optional[int] = None,
    sort_keys: bool = False,
    default: Optional[Callable] = None,
    trailing_newline: bool = True,
) -> Path:
    """Publish ``payload`` as JSON at ``path``: serialized into a sibling
    temp file, then ``os.replace``-d into place."""
    return _staged(Path(path), _dump_json(payload, indent, sort_keys, default, trailing_newline),
                   "w", os.replace)


def atomic_create_json(
    path: PathLike,
    payload: Any,
    *,
    indent: Optional[int] = None,
    sort_keys: bool = False,
    default: Optional[Callable] = None,
) -> Path:
    """Publish the JSON file at ``path`` only if nothing is there
    (``FileExistsError`` otherwise): the finished temp file is
    ``os.link``-ed into place, which lands whole or fails, so of racing
    writers exactly one succeeds. The temp file is removed either way."""
    path = Path(path)

    def link(tmp, dest):
        try:
            os.link(tmp, dest)
        finally:
            os.unlink(tmp)

    return _staged(path, _dump_json(payload, indent, sort_keys, default, True), "w", link)


def atomic_publish_dir(tmp_dir: PathLike, dest_dir: PathLike) -> Path:
    """Publish an assembled staging directory at ``dest_dir`` with one
    ``os.replace``. An existing destination is removed first (a directory
    cannot be renamed onto a non-empty one); a crash between the two
    steps leaves no directory, which readers treat as not written."""
    tmp_dir, dest_dir = Path(tmp_dir), Path(dest_dir)
    if dest_dir.exists():
        shutil.rmtree(dest_dir)
    os.replace(tmp_dir, dest_dir)
    return dest_dir


def atomic_symlink_swap(target: PathLike, pointer: PathLike) -> None:
    """Re-point the symlink ``pointer`` at ``target``: a fresh sibling
    link is ``os.replace``-d over it, so readers resolve the old target or
    the new one, never a missing link."""
    pointer = str(pointer)
    tmp = os.path.join(os.path.dirname(pointer) or ".",
                       f".{os.path.basename(pointer)}-tmp-{os.getpid()}")
    try:
        os.unlink(tmp)
    except OSError:
        pass
    os.symlink(str(target), tmp)
    try:
        os.replace(tmp, pointer)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
