"""
Blue/green revision assembly (the port of ``gordo_tpu.lifecycle.promote``).

A promotion never changes the served revision. It stages a sibling
revision directory, dot-prefixed while it is being built so that the
server's ``/revisions`` listing and ``latest`` resolution never see it,
in which each machine is:

- **promoted**: the refit candidate's artifact is written in;
- **retained**: the live artifact's files are hard-linked (the same
  bytes and inode; a copy where links cannot cross file systems); or
- **quarantined**: the live artifact is retained for metadata and
  download, and the machine is named in the new revision's
  ``build_report.json``, so serving answers it with the structured 409.

``promotion_report.json`` (every decision) and ``build_report.json`` are
written into the staging directory before the one ``os.rename`` that
publishes it; a crash before then (the ``promote:torn`` fault) leaves a
dot-prefixed directory that never becomes ``latest``. The ``latest``
symlink is re-pointed by symlink swap and ``rename``, and the server
resolves it on every request.
"""

import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Optional, Union

from gordo_tpu_torch import serializer
from gordo_tpu_torch.robustness import faults
from gordo_tpu_torch.utils import atomic

logger = logging.getLogger(__name__)

PROMOTION_REPORT_FILENAME = "promotion_report.json"
#: the builder's casualty record (``builder.fleet_build``), named here so
#: that the promoter needs no builder import
BUILD_REPORT_FILENAME = "build_report.json"
#: the stem of staging directories, which readers skip as dot entries
STAGING_PREFIX = ".promote-"

PathLike = Union[str, os.PathLike]


class TornPromotion(RuntimeError):
    """Revision assembly died before publication; its staging directory
    is left as the crash left it (dot-prefixed: never listed, never
    ``latest``), and a retry stages a fresh sibling."""

    def __init__(self, message: str, staging_dir: str):
        super().__init__(message)
        self.staging_dir = staging_dir


def new_revision_name(parent: PathLike) -> str:
    """
    The next revision name: epoch milliseconds, bumped past every numeric
    sibling (a staging directory's number too), so that name order is
    promotion order even within one millisecond.
    """
    candidate = int(time.time() * 1000)
    try:
        entries = os.listdir(parent)
    except FileNotFoundError:
        entries = []
    existing = [int(n) for n in entries if n.isdigit()]
    existing += [
        int(n[len(STAGING_PREFIX):])
        for n in entries
        if n.startswith(STAGING_PREFIX) and n[len(STAGING_PREFIX):].isdigit()
    ]
    if existing:
        candidate = max(candidate, max(existing) + 1)
    while os.path.exists(os.path.join(parent, str(candidate))) or os.path.exists(
        os.path.join(parent, f"{STAGING_PREFIX}{candidate}")
    ):
        candidate += 1
    return str(candidate)


def _link_or_copy_tree(src: Path, dst: Path) -> None:
    """Hard-link every file of ``src`` under ``dst`` (retention at no
    storage cost, bitwise the same); ``copy2`` where a link fails."""
    for root, _, files in os.walk(src):
        rel = os.path.relpath(root, src)
        target_root = dst if rel == "." else dst / rel
        target_root.mkdir(parents=True, exist_ok=True)
        for fname in files:
            src_file = os.path.join(root, fname)
            dst_file = target_root / fname
            try:
                os.link(src_file, dst_file)
            except OSError:
                shutil.copy2(src_file, dst_file)


def _write_json(path: Path, payload: dict) -> None:
    """A plain write: the staging directory's rename makes it atomic."""
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")


def assemble_revision(
    live_dir: PathLike,
    decisions: Dict[str, dict],
    candidates: Dict[str, tuple],
    build_report: dict,
    promotion_report: dict,
) -> Path:
    """
    Stage and publish one new sibling revision of ``live_dir``.

    ``decisions`` maps machines of the live revision to their records
    (``{"decision": "promoted"|"retained"|"quarantined", ...}``; a machine
    without one is retained); ``candidates`` maps the promoted machines to
    their refit ``(model, Machine)``. Both reports are written into the
    staging directory, stamped with the new revision's name, before the
    rename that publishes it. Returns the published directory.
    """
    live_dir = Path(live_dir)
    parent = live_dir.parent
    revision = new_revision_name(parent)
    staging = parent / f"{STAGING_PREFIX}{revision}"
    staging.mkdir(parents=True)

    machine_dirs = sorted(
        name for name in os.listdir(live_dir)
        if not name.startswith(".") and os.path.isdir(live_dir / name)
    )
    n_assembled = 0
    try:
        for name in machine_dirs:
            record = decisions.get(name) or {}
            if record.get("decision") == "promoted":
                model, machine = candidates[name]
                serializer.dump(model, staging / name, machine.to_dict())
            else:
                _link_or_copy_tree(live_dir / name, staging / name)
            n_assembled += 1
            faults.inject_promotion_tear(n_assembled)

        build_report = dict(build_report)
        build_report.setdefault("version", 1)
        build_report["revision"] = revision
        _write_json(staging / BUILD_REPORT_FILENAME, build_report)
        promotion_report = dict(promotion_report)
        promotion_report.setdefault("version", 1)
        promotion_report["revision"] = revision
        _write_json(staging / PROMOTION_REPORT_FILENAME, promotion_report)
    except Exception as exc:
        # the staging directory stays as the record of the tear;
        # KeyboardInterrupt and SystemExit pass through unwrapped
        raise TornPromotion(
            f"Revision assembly for {revision} died after {n_assembled} machine(s): {exc!r} "
            f"(staging left at {staging})",
            staging_dir=str(staging),
        ) from exc

    final = parent / revision
    os.rename(staging, final)  # the publication: atomic
    logger.info("Published revision %s (%d machines) next to %s",
                revision, len(machine_dirs), live_dir.name)
    return final


def repoint_latest(pointer: PathLike, target_dir: PathLike) -> None:
    """
    Re-point the ``latest`` symlink at ``target_dir`` (symlink swap and
    ``rename``: readers see the old target or the new one). A pointer
    that is a real directory is refused: flipping it would delete served
    artifacts.
    """
    pointer = os.path.abspath(str(pointer))
    if os.path.lexists(pointer) and not os.path.islink(pointer):
        raise ValueError(
            f"{pointer} is a real directory, not a latest symlink; cannot re-point it "
            "(serve the new revision via ?revision= or redeploy MODEL_COLLECTION_DIR)"
        )
    target_dir = os.path.abspath(str(target_dir))
    if os.path.dirname(pointer) == os.path.dirname(target_dir):
        # a relative target keeps the collection tree relocatable
        target: str = os.path.basename(target_dir)
    else:
        target = target_dir
    atomic.atomic_symlink_swap(target, pointer)


def read_promotion_report(revision_dir: PathLike) -> Optional[dict]:
    """The revision's ``promotion_report.json``, or None (a revision of a
    plain build has none)."""
    path = os.path.join(str(revision_dir), PROMOTION_REPORT_FILENAME)
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        logger.warning("Unreadable promotion report at %s", path)
        return None
