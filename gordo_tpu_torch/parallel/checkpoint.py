"""
Epoch checkpoints of a stacked fleet fit (the port of
``gordo_tpu.parallel.checkpoint``): a long fleet fit that dies resumes
from its last completed epoch instead of from the start.

Each checkpoint is a directory ``<directory>/<epoch>/`` of three ``.npz``
files, ``params.npz``, ``opt_state.npz`` (nested names joined with
``/``) and ``extra.npz`` (host arrays such as the trainer's early-stopping
and quarantine state, when given), staged in a dot directory and
published with :func:`~gordo_tpu_torch.utils.atomic.atomic_publish_dir`.
A ``manifest.json`` of the files' sizes is written once the directory
has landed, and ``restore`` checks it: a checkpoint whose files disagree
with their manifest is torn, is deleted, and the previous kept epoch is
restored instead, with a warning; one that does not load is skipped the
same way but kept (a layout mismatch is no proof of damage). ``keep``
checkpoints are kept, the oldest deleted first.

The JAX package saves with orbax; the two packages cannot read each
other's checkpoints. Saves are synchronous, so :meth:`wait` has nothing
to wait for; it is kept for the JAX API's callers.
"""

import json
import logging
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gordo_tpu_torch.utils import atomic

logger = logging.getLogger(__name__)

MANIFEST_FILENAME = "manifest.json"
_PARTS = ("params", "opt_state", "extra")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested dict of leaves -> ``{"a/b": leaf}``."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for key, value in tree.items():
            out.update(_flatten(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def _host(value) -> np.ndarray:
    """A leaf as a numpy array; a bfloat16 tensor as its bits (int16)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        return value.numpy()
    return np.asarray(value)


def _leaf_like(array: np.ndarray, like) -> Any:
    """A loaded array shaped and typed as the template's leaf ``like``
    (a tensor goes to the template's device and type)."""
    if not isinstance(like, torch.Tensor):
        like = np.asarray(like)
        if array.shape != like.shape:
            raise ValueError(f"shape {array.shape}, template {like.shape}")
        return array.astype(like.dtype, copy=False)
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if like.dtype == torch.bfloat16:
        tensor = tensor.view(torch.bfloat16)
    if tuple(tensor.shape) != tuple(like.shape) or tensor.dtype != like.dtype:
        raise ValueError(f"{tuple(tensor.shape)} {tensor.dtype}, template "
                         f"{tuple(like.shape)} {like.dtype}")
    return tensor.to(like.device)


def _rebuild(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {key: _rebuild(value, flat, f"{prefix}{key}/") for key, value in template.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint lacks {key!r}")
    try:
        return _leaf_like(flat[key], template)
    except ValueError as err:
        raise ValueError(f"{key}: {err}") from None


class FleetCheckpointer:
    """Epoch-granular checkpoints of (params, optimizer state, extra)
    under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = str(directory)
        self.keep = max(1, int(keep))
        Path(self.directory).mkdir(parents=True, exist_ok=True)

    def _step_dir(self, epoch: int) -> Path:
        return Path(self.directory) / str(int(epoch))

    def all_epochs(self) -> List[int]:
        """The checkpointed epochs, oldest first (staging entries, which
        start with a dot, are not checkpoints)."""
        epochs = []
        for entry in Path(self.directory).iterdir():
            if entry.is_dir() and entry.name.isdigit():
                epochs.append(int(entry.name))
        return sorted(epochs)

    def latest_epoch(self) -> Optional[int]:
        """The last checkpointed epoch, or None."""
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, params: Any, opt_state: Any,
             extra: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Write epoch ``epoch``'s checkpoint (replacing one of that epoch),
        stamp it with its manifest, and drop checkpoints past ``keep``."""
        parts = {"params": params, "opt_state": opt_state}
        if extra is not None:
            parts["extra"] = {k: np.asarray(v) for k, v in extra.items()}
        staging = Path(tempfile.mkdtemp(dir=self.directory, prefix=f".{int(epoch)}.tmp-"))
        try:
            for part, tree in parts.items():
                np.savez(staging / f"{part}.npz",
                         **{k: _host(v) for k, v in _flatten(tree).items()})
            step_dir = atomic.atomic_publish_dir(staging, self._step_dir(epoch))
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        manifest = {entry.name: entry.stat().st_size for entry in sorted(step_dir.iterdir())
                    if entry.name != MANIFEST_FILENAME}
        atomic.atomic_write_json(step_dir / MANIFEST_FILENAME, manifest, trailing_newline=False)
        for old in self.all_epochs()[: -self.keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    # -- torn-write verification ----------------------------------------
    def _verify(self, epoch: int) -> bool:
        """The step's files against its manifest; a step without one is
        not rejected here (loading it is the test)."""
        step_dir = self._step_dir(epoch)
        manifest_path = step_dir / MANIFEST_FILENAME
        if not manifest_path.is_file():
            return True
        try:
            manifest = json.loads(manifest_path.read_text())
        except ValueError:
            logger.warning("Checkpoint %s has an unreadable manifest; treating as torn", step_dir)
            return False
        for rel, size in manifest.items():
            path = step_dir / rel
            if not path.is_file() or path.stat().st_size != int(size):
                logger.warning(
                    "Checkpoint %s is torn: %s is %s bytes, manifest says %d", step_dir, rel,
                    path.stat().st_size if path.is_file() else "missing", int(size),
                )
                return False
        return True

    def _load(self, epoch: int, template: dict) -> dict:
        step_dir = self._step_dir(epoch)
        out = {}
        for part in _PARTS:
            if part not in template:
                continue
            with np.load(step_dir / f"{part}.npz", allow_pickle=False) as npz:
                flat = {name: npz[name] for name in npz.files}
            if set(flat) != set(_flatten(template[part])):
                raise KeyError(f"{part} holds {sorted(flat)}, template "
                               f"{sorted(_flatten(template[part]))}")
            out[part] = _rebuild(template[part], flat)
        return out

    def _restore_verified(self, templates: List[dict], epoch: Optional[int]
                          ) -> Tuple[dict, int, int]:
        """The newest checkpoint that verifies and loads, newest first:
        (payload, epoch, index of the template that matched). Each
        template is tried at each epoch in order."""
        if epoch is not None:
            candidates = [int(epoch)]
        else:
            candidates = sorted(self.all_epochs(), reverse=True)
            if not candidates:
                raise FileNotFoundError(f"No checkpoints under {self.directory}")
        last_error: Optional[Exception] = None
        for step in candidates:
            if not self._verify(step):
                logger.warning("Deleting unrestorable checkpoint at epoch %d so the resumed "
                               "fit can save it again", step)
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
                continue
            for index, template in enumerate(templates):
                try:
                    restored = self._load(step, template)
                except Exception as exc:  # a layout mismatch or a damaged file
                    last_error = exc
                    continue
                return restored, step, index
            logger.warning("Checkpoint at epoch %d failed to restore (%s); falling back to the "
                           "previous kept epoch", step, last_error)
        raise FileNotFoundError(
            f"No restorable checkpoint under {self.directory} (tried epochs {candidates}; "
            f"last error: {last_error!r})"
        )

    # -- restore ---------------------------------------------------------
    def restore(self, params_template: Any, opt_state_template: Any,
                epoch: Optional[int] = None) -> Tuple[Any, Any, int]:
        """(params, opt_state, epoch) of the newest restorable checkpoint
        (or of ``epoch``), each leaf typed and placed as its template's."""
        restored, found, _ = self._restore_verified(
            [{"params": params_template, "opt_state": opt_state_template}], epoch)
        logger.info("Restored fleet checkpoint at epoch %d", found)
        return restored["params"], restored["opt_state"], found

    def restore_with_extra(
        self,
        params_template: Any,
        opt_state_template: Any,
        extra_template: Dict[str, np.ndarray],
        epoch: Optional[int] = None,
        optional_extra_keys: Tuple[str, ...] = (),
    ) -> Tuple[Any, Any, int, Optional[Dict[str, np.ndarray]]]:
        """Like :meth:`restore`, with the ``extra`` dict: None when the
        checkpoint was saved without one or with another layout. The
        layouts without each of ``optional_extra_keys``, and with those
        keys alone, are tried before giving the extra state up."""
        plain = {"params": params_template, "opt_state": opt_state_template}

        def with_extra(template: Dict[str, np.ndarray]) -> dict:
            return dict(plain, extra={k: np.asarray(v) for k, v in template.items()})

        templates = [with_extra(extra_template)]
        reduced = dict(extra_template)
        for key in optional_extra_keys:
            if key in reduced and len(reduced) > 1:
                reduced = {k: v for k, v in reduced.items() if k != key}
                templates.append(with_extra(reduced))
        optional_only = {k: extra_template[k] for k in optional_extra_keys if k in extra_template}
        if optional_only and len(optional_only) < len(extra_template):
            templates.append(with_extra(optional_only))
        templates.append(plain)
        restored, found, which = self._restore_verified(templates, epoch)
        if which == len(templates) - 1:
            logger.info("Restored fleet checkpoint at epoch %d", found)
            return restored["params"], restored["opt_state"], found, None
        logger.info("Restored fleet checkpoint (+extra state) at epoch %d", found)
        return (restored["params"], restored["opt_state"], found,
                {k: np.asarray(v) for k, v in restored["extra"].items()})

    def close(self) -> None:
        """Nothing to release."""
