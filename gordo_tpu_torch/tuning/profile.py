"""
The tuning profile (the port of ``gordo_tpu.tuning.profile``): a
versioned ``tuning_profile.json`` beside a collection's artifacts, with
the cost model's recommendations for that collection.

``build-fleet`` and ``run-server`` read the collection's profile by
default, with the JAX precedence: a knob given by flag (or, for the
server, an explicit setting) wins, then its environment variable, then
the profile, then the built-in default. argparse cannot tell a default
from a given value, so the tuned options are parsed with ``None`` as
their default and resolved by :func:`resolve_tuned_options`. Each
application emits one ``tuning_profile_loaded`` event and sets
``gordo_tuning_profile_applied{knob}`` to 1 for each applied knob; with
no profile, or every knob given, nothing is read or emitted.

A profile of an unknown future ``profile_version`` is not applied (a
warning; ``tune plan --check`` fails on it). A profile that recommends a
knob the port lacks (``Knob.unported``) is refused with
:class:`UnportedKnobError`, naming the knob and the reason, not ignored.
``GORDO_TUNING_PROFILE`` names a profile file for every collection, or
with ``off``/``0``/``false``/``no`` turns profiles off. Standard library
only.
"""

import json
import logging
import os
import typing
from pathlib import Path

from gordo_tpu_torch.observability.events import emit_event
from gordo_tpu_torch.observability.registry import get_registry
from gordo_tpu_torch.tuning.knobs import KNOBS_BY_NAME
from gordo_tpu_torch.tuning.model import Recommendation
from gordo_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger(__name__)

PROFILE_VERSION = 1
TUNING_PROFILE_FILENAME = "tuning_profile.json"
PROFILE_ENV_VAR = "GORDO_TUNING_PROFILE"
_DISABLE_TOKENS = frozenset({"off", "0", "false", "no"})


class TuningProfileError(ValueError):
    """A profile that must not be applied: unreadable, unversioned, or
    of a future ``profile_version``."""


class UnportedKnobError(TuningProfileError):
    """A profile that recommends knobs the port does not have."""


def build_profile(recommendations: typing.Mapping[str, Recommendation],
                  corpus_meta: typing.Optional[dict] = None,
                  generated: typing.Optional[str] = None) -> dict:
    """The profile's payload (the JAX schema)."""
    from datetime import datetime, timezone

    return {
        "profile_version": PROFILE_VERSION,
        "generated": generated or datetime.now(timezone.utc).isoformat(),
        "corpus": dict(corpus_meta or {}),
        "recommendations": {name: rec.to_dict() for name, rec in recommendations.items()},
    }


def write_profile(target: typing.Union[str, Path],
                  recommendations: typing.Mapping[str, Recommendation],
                  corpus_meta: typing.Optional[dict] = None) -> Path:
    """Publish the profile at ``target`` whole (a directory gets
    ``tuning_profile.json`` inside it)."""
    path = Path(target)
    if path.is_dir():
        path = path / TUNING_PROFILE_FILENAME
    return atomic_write_json(path, build_profile(recommendations, corpus_meta), indent=2,
                             sort_keys=True)


def load_profile(path: typing.Union[str, Path]) -> dict:
    """A profile file, parsed and version-checked; anything that must not
    be applied raises :class:`TuningProfileError`."""
    path = Path(path)
    try:
        payload = json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        raise TuningProfileError(f"{path}: unreadable profile: {exc}")
    if not isinstance(payload, dict):
        raise TuningProfileError(f"{path}: profile must be a JSON object")
    version = payload.get("profile_version")
    if not isinstance(version, int) or isinstance(version, bool):
        raise TuningProfileError(
            f"{path}: missing/invalid profile_version "
            f"(got {version!r}; this build understands <= {PROFILE_VERSION})"
        )
    if version > PROFILE_VERSION:
        raise TuningProfileError(
            f"{path}: profile_version {version} is newer than this build "
            f"understands ({PROFILE_VERSION}) — refusing to apply a "
            f"half-understood profile; upgrade gordo-tpu or re-fit with "
            f"`gordo-tpu tune fit`"
        )
    if not isinstance(payload.get("recommendations", {}), dict):
        raise TuningProfileError(f"{path}: 'recommendations' must be an object")
    return payload


def unported_recommendations(profile: dict) -> typing.Dict[str, str]:
    """``{knob: why the port lacks it}`` for the profile's
    recommendations of knobs the port does not have."""
    out = {}
    for name in (profile.get("recommendations") or {}):
        knob = KNOBS_BY_NAME.get(name)
        if knob is not None and knob.unported is not None:
            out[name] = knob.unported
    return out


def refuse_unported(path: typing.Union[str, Path], profile: dict) -> None:
    """Raise :class:`UnportedKnobError` when the profile recommends a
    knob the port lacks, naming each and its reason."""
    unported = unported_recommendations(profile)
    if unported:
        raise UnportedKnobError(
            f"{path}: the tuning profile recommends knob(s) the port does not have: "
            + "; ".join(f"{name} ({why})" for name, why in sorted(unported.items()))
            + f". Re-fit it with the port's `tune fit`, or set {PROFILE_ENV_VAR}=off"
        )


def validate_profile(profile: dict) -> typing.List[str]:
    """What no longer agrees between a profile and this registry (the
    ``tune plan --check`` gate): a renamed or removed knob, a value out
    of its domain, a knob that is not tunable, and a knob the port lacks."""
    problems: typing.List[str] = []
    for name, entry in (profile.get("recommendations") or {}).items():
        knob = KNOBS_BY_NAME.get(name)
        if knob is None:
            problems.append(
                f"recommendation for unknown knob {name!r} (renamed or "
                f"removed from the registry?)"
            )
            continue
        if not knob.tunable:
            problems.append(f"recommendation for non-tunable knob {name!r}")
        if knob.unported is not None:
            problems.append(f"recommendation for knob {name!r} the port lacks ({knob.unported})")
        value = (entry or {}).get("value")
        if not knob.domain.contains(value):
            problems.append(
                f"{name}: recommended value {value!r} outside domain "
                f"({knob.domain.describe()})"
            )
    return problems


def resolve_profile_path(collection_dir: typing.Optional[typing.Union[str, Path]]
                         ) -> typing.Optional[Path]:
    """The profile file of ``collection_dir``, or None (turned off or
    absent): one environment lookup and at most one stat."""
    override = os.environ.get(PROFILE_ENV_VAR)
    if override:
        if override.strip().lower() in _DISABLE_TOKENS:
            return None
        return Path(override)
    if not collection_dir:
        return None
    path = Path(collection_dir) / TUNING_PROFILE_FILENAME
    return path if path.is_file() else None


def recommended_values(profile: dict, subsystems: typing.Optional[typing.Sequence[str]] = None
                       ) -> typing.Dict[str, typing.Any]:
    """``{knob: value}`` of the profile's valid recommendations (of
    ``subsystems``, if given); an unknown, untunable or out-of-domain
    entry is skipped with a warning."""
    wanted = set(subsystems) if subsystems else None
    out: typing.Dict[str, typing.Any] = {}
    for name, entry in (profile.get("recommendations") or {}).items():
        knob = KNOBS_BY_NAME.get(name)
        if knob is None or not knob.tunable:
            logger.warning("Ignoring profile recommendation for unknown/non-tunable knob %r",
                           name)
            continue
        if wanted is not None and knob.subsystem not in wanted:
            continue
        value = (entry or {}).get("value")
        if not knob.domain.contains(value):
            logger.warning("Ignoring profile recommendation %s=%r: outside domain (%s)",
                           name, value, knob.domain.describe())
            continue
        out[name] = value
    return out


def load_collection_profile(collection_dir: typing.Optional[typing.Union[str, Path]]
                            ) -> typing.Optional[typing.Tuple[Path, dict]]:
    """(path, profile) of the collection, or None when turned off or
    absent. A profile that cannot be applied (a torn write, a future
    version) logs and gives None: the explicit and default values stand.
    One that recommends a knob the port lacks raises
    :class:`UnportedKnobError`."""
    path = resolve_profile_path(collection_dir)
    if path is None:
        return None
    try:
        profile = load_profile(path)
    except TuningProfileError as exc:
        logger.warning("Not applying tuning profile: %s", exc)
        return None
    refuse_unported(path, profile)
    return path, profile


def record_applied(path: typing.Union[str, Path], profile: dict,
                   applied: typing.Mapping[str, typing.Any], subsystem: str) -> None:
    """What an application leaves: one ``tuning_profile_loaded`` event
    naming the knobs that took the profile's values, and the
    ``gordo_tuning_profile_applied`` gauge at 1 for each."""
    emit_event(
        "tuning_profile_loaded",
        path=str(path),
        profile_version=profile.get("profile_version"),
        subsystem=subsystem,
        applied={name: applied[name] for name in sorted(applied)},
        n_applied=len(applied),
    )
    gauge = get_registry().gauge(
        "gordo_tuning_profile_applied",
        "1 per knob whose running value came from the collection's tuning profile",
        ("knob",),
    )
    for name in applied:
        gauge.set(1, knob=name)


class TunedOption(typing.NamedTuple):
    """An option a profile may default: its knob, the attribute (or
    setting) that holds it, its environment variable, its type and its
    built-in default."""

    knob: str
    attr: str
    env_var: str
    cast: typing.Callable[[typing.Any], typing.Any]
    default: typing.Any


def resolve_tuned_options(values: typing.Dict[str, typing.Any],
                          collection_dir: typing.Optional[typing.Union[str, Path]],
                          options: typing.Sequence[TunedOption], subsystem: str
                          ) -> typing.Dict[str, typing.Any]:
    """Fill ``values`` (attribute -> given value, None where not given)
    in place with each option's value: the given one, else its
    environment variable's, else the collection's profile's, else the
    built-in default. The profile is read only when an option falls
    through to it, and an application is recorded (:func:`record_applied`)
    only when some knob took a profile value. ``collection_dir`` None
    reads no profile. Returns ``{knob: value}`` of the applied knobs."""
    loaded: typing.Any = None  # None: not read yet; False: none
    recommended: typing.Dict[str, typing.Any] = {}
    applied: typing.Dict[str, typing.Any] = {}
    for option in options:
        if values.get(option.attr) is not None:
            values[option.attr] = option.cast(values[option.attr])
            continue
        raw = os.environ.get(option.env_var)
        if raw:
            values[option.attr] = option.cast(raw)
            continue
        if loaded is None:
            loaded = (load_collection_profile(collection_dir) if collection_dir else None) or False
            if loaded:
                recommended = recommended_values(loaded[1])
        if loaded and option.knob in recommended:
            values[option.attr] = option.cast(recommended[option.knob])
            applied[option.knob] = values[option.attr]
        else:
            values[option.attr] = option.default
    if loaded and applied:
        logger.info("Applying tuning profile %s: %s", loaded[0],
                    ", ".join(f"{k}={v}" for k, v in sorted(applied.items())))
        record_applied(loaded[0], loaded[1], applied, subsystem)
    return applied
