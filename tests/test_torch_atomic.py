"""
The port's atomic publication helpers (``gordo_tpu_torch.utils.atomic``)
against the JAX package's (``gordo_tpu.utils.atomic``): the same
operations leave the same files, bytes for bytes, and a failure midway
leaves the destination as it was and no staging entry behind.
"""

import os

import pytest

from gordo_tpu.utils import atomic as jax_atomic
from gordo_tpu_torch.utils import atomic


def _tree(root):
    """Every entry under ``root``: {relative path: bytes, or the link's
    target, or None for a directory}."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ("link", os.readlink(path))
            elif os.path.isdir(path):
                out[rel] = None
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def _both(tmp_path, operation):
    """Run ``operation(module, root)`` with each package's helpers in a
    directory of its own; the two trees."""
    trees = []
    for name, module in (("jax", jax_atomic), ("port", atomic)):
        root = tmp_path / name
        root.mkdir()
        operation(module, root)
        trees.append(_tree(root))
    return trees


PAYLOAD = {"b": [1, 2.5, None], "a": {"nested": "x"}}


@pytest.mark.parametrize("kwargs", [{}, {"indent": 2, "sort_keys": True},
                                    {"trailing_newline": False}])
def test_write_json_writes_the_same_bytes(tmp_path, kwargs):
    def op(module, root):
        module.atomic_write_json(root / "sub" / "report.json", PAYLOAD, **kwargs)
        module.atomic_write_json(root / "sub" / "report.json", {"again": True}, **kwargs)

    jax_tree, port_tree = _both(tmp_path, op)
    assert port_tree == jax_tree
    assert set(port_tree) == {"sub", os.path.join("sub", "report.json")}


def test_write_bytes_and_create_json(tmp_path):
    def op(module, root):
        module.atomic_write_bytes(root / "blob.bin", b"\x00\x01payload")
        module.atomic_create_json(root / "done.json", PAYLOAD, sort_keys=True)
        with pytest.raises(FileExistsError):
            module.atomic_create_json(root / "done.json", {"second": "writer"})

    jax_tree, port_tree = _both(tmp_path, op)
    assert port_tree == jax_tree
    assert sorted(port_tree) == ["blob.bin", "done.json"]


def test_publish_dir_and_symlink_swap(tmp_path):
    def op(module, root):
        for revision, content in (("rev-1", b"one"), ("rev-2", b"two")):
            staging = root / f".{revision}.tmp"
            staging.mkdir()
            (staging / "model.txt").write_bytes(content)
            module.atomic_publish_dir(staging, root / revision)
        # publishing over an existing directory replaces it whole
        staging = root / ".rev-1.tmp"
        staging.mkdir()
        (staging / "other.txt").write_bytes(b"replaced")
        module.atomic_publish_dir(staging, root / "rev-1")
        os.symlink("rev-1", root / "latest")
        module.atomic_symlink_swap("rev-2", root / "latest")

    jax_tree, port_tree = _both(tmp_path, op)
    assert port_tree == jax_tree
    assert port_tree["latest"] == ("link", "rev-2")
    assert os.path.join("rev-1", "other.txt") in port_tree
    assert os.path.join("rev-1", "model.txt") not in port_tree


class _Unserializable:
    pass


def test_a_failure_midway_leaves_the_old_file_and_no_staging(tmp_path):
    """Serialization fails after the temp file exists: the destination
    keeps its old content and the temp file is gone, in both packages."""

    def op(module, root):
        module.atomic_write_json(root / "report.json", {"old": 1})
        with pytest.raises(TypeError):
            module.atomic_write_json(root / "report.json", {"new": _Unserializable()})
        with pytest.raises(TypeError):
            module.atomic_create_json(root / "fresh.json", {"new": _Unserializable()})
        with pytest.raises(TypeError):
            module.atomic_write_bytes(root / "blob.bin", object())

    jax_tree, port_tree = _both(tmp_path, op)
    assert port_tree == jax_tree
    assert sorted(port_tree) == ["report.json"]
    assert port_tree["report.json"] == b'{"old": 1}\n'


def test_symlink_swap_failure_leaves_the_pointer(tmp_path):
    """``os.replace`` of a link onto a directory fails: the pointer (here
    a real directory) stays and no staging link is left, in both."""

    def op(module, root):
        (root / "pointer").mkdir()
        (root / "pointer" / "keep").write_bytes(b"k")
        with pytest.raises(OSError):
            module.atomic_symlink_swap("elsewhere", root / "pointer")

    jax_tree, port_tree = _both(tmp_path, op)
    assert port_tree == jax_tree
    assert sorted(port_tree) == ["pointer", os.path.join("pointer", "keep")]
