"""
Validating descriptors and runtime fixes (the port of
``gordo_tpu.machine.validators``, the parts ``Machine`` and the datasets
use). Each raises ``ValueError`` where the JAX one does. ISO text is
parsed with ``datetime.fromisoformat`` where the JAX package uses
dateutil's ``isoparse``.
"""

import copy
import datetime
import logging
import re

logger = logging.getLogger(__name__)


class BaseDescriptor:
    """An attribute descriptor that validates on ``__set__``."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return instance.__dict__.get(self.name)

    def __set__(self, instance, value):
        self.validate(value)
        instance.__dict__[self.name] = value

    def validate(self, value):
        raise NotImplementedError()


class ValidDatetime(BaseDescriptor):
    """A timezone-aware datetime, or ISO text that parses to one."""

    def validate(self, value):
        if isinstance(value, str):
            value = datetime.datetime.fromisoformat(value)
        if not isinstance(value, datetime.datetime):
            raise ValueError(f"'{value}' is not a valid datetime")
        if value.tzinfo is None:
            raise ValueError(f"Datetime '{value}' needs timezone information")

    def __set__(self, instance, value):
        if isinstance(value, str):
            value = datetime.datetime.fromisoformat(value)
        self.validate(value)
        instance.__dict__[self.name] = value


class ValidDataset(BaseDescriptor):
    """A dataset object or a dataset config dict."""

    def validate(self, value):
        from gordo_tpu_torch.data.base import GordoBaseDataset

        if not isinstance(value, (GordoBaseDataset, dict)):
            raise ValueError(f"'{value}' is not a valid dataset config or dataset object")


class ValidModel(BaseDescriptor):
    """
    A model config dict that the port's ``serializer.from_definition``
    builds: a model the port lacks is refused here, at construction. The
    dry run is skipped when the owner sets ``_strict = False``.
    """

    def validate(self, value, strict: bool = True):
        if not isinstance(value, dict):
            raise ValueError(f"Model config must be a dict, got {value!r}")
        if not strict:
            return
        from gordo_tpu_torch.serializer import from_definition

        try:
            from_definition(value)
        except Exception as exc:
            raise ValueError(f"Invalid model config: {exc}") from exc

    def __set__(self, instance, value):
        self.validate(value, strict=getattr(instance, "_strict", True))
        instance.__dict__[self.name] = value


class ValidMetadata(BaseDescriptor):
    def validate(self, value):
        from gordo_tpu_torch.machine.metadata import Metadata

        if value is not None and not isinstance(value, (dict, Metadata)):
            raise ValueError(f"'{value}' is not a valid metadata")


def fix_resource_limits(resources: dict) -> dict:
    """
    A k8s-style resources dict whose cpu and memory limits are at least
    their requests: a limit below its request is lifted to it. Values
    must be integers (or text of one). The input is not changed.
    """
    resources = copy.deepcopy(resources)
    requests = resources.get("requests", {}) or {}
    limits = resources.get("limits", {}) or {}
    for key in ("cpu", "memory"):
        req, lim = requests.get(key), limits.get(key)
        if req is not None and not isinstance(req, int):
            try:
                requests[key] = req = int(req)
            except (TypeError, ValueError):
                raise ValueError(f"Resource request {key}={req!r} is not an integer")
        if lim is not None and not isinstance(lim, int):
            try:
                limits[key] = lim = int(lim)
            except (TypeError, ValueError):
                raise ValueError(f"Resource limit {key}={lim!r} is not an integer")
        if req is not None and lim is not None and lim < req:
            logger.warning(
                "Resource %s limit %s is below request %s; lifting limit to request",
                key, lim, req,
            )
            limits[key] = req
    out = dict(resources)
    if requests:
        out["requests"] = requests
    if limits:
        out["limits"] = limits
    return out


def fix_runtime(runtime: dict) -> dict:
    """:func:`fix_resource_limits` applied to every runtime section with a
    ``resources`` block, in a new dict."""
    runtime = copy.deepcopy(runtime)
    for section in runtime.values():
        if isinstance(section, dict) and isinstance(section.get("resources"), dict):
            section["resources"] = fix_resource_limits(section["resources"])
    return runtime


class ValidMachineRuntime(BaseDescriptor):
    """A runtime dict, stored with :func:`fix_runtime` applied."""

    def validate(self, value):
        if not isinstance(value, dict):
            raise ValueError(f"'{value}' is not a valid runtime config dict")

    def __set__(self, instance, value):
        self.validate(value)
        instance.__dict__[self.name] = fix_runtime(value)


_URL_RE = re.compile(r"^[a-z0-9]([a-z0-9\-]{0,61}[a-z0-9])?$")


class ValidUrlString(BaseDescriptor):
    """A Kubernetes DNS-1123 label: lowercase letters, digits and '-', no
    '-' at either end, at most 63 characters."""

    def validate(self, value):
        if not isinstance(value, str) or not self.valid_url_string(value):
            raise ValueError(
                f"'{value}' is not a valid name: must be a lowercase DNS-1123 "
                "label (a-z, 0-9, '-'), max 63 chars, not starting/ending with '-'"
            )

    @staticmethod
    def valid_url_string(value: str) -> bool:
        return len(value) <= 63 and bool(_URL_RE.match(value))
