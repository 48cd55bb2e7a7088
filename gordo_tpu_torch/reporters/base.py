"""
The reporter base (the port of ``gordo_tpu.reporters.base``).

A reporter is configured as ``{<class path>: {<argument>: <value>}}``;
the class path's last part names the reporter, so the JAX package's
paths (``gordo_tpu.reporters.postgres.SqliteReporter``) and the port's
both work, and :meth:`BaseReporter.to_dict` writes the JAX path.
"""

import abc


class ReporterException(Exception):
    """A configured reporter failed (the build command's exit code 90)."""


class BaseReporter(abc.ABC):
    #: the JAX package's module of the reporter class (``to_dict``)
    WIRE_MODULE = "gordo_tpu.reporters.postgres"

    @abc.abstractmethod
    def report(self, machine):
        """Report a built machine (its config and build metadata)."""

    def to_dict(self) -> dict:
        return {f"{self.WIRE_MODULE}.{type(self).__name__}": dict(getattr(self, "_params", {}))}

    @classmethod
    def from_dict(cls, config) -> "BaseReporter":
        """A reporter from ``{<class path>: {<argument>: <value>}}`` (or a
        bare class path, for a reporter of no arguments)."""
        from gordo_tpu_torch.reporters import postgres

        if isinstance(config, str):
            config = {config: {}}
        if not isinstance(config, dict) or len(config) != 1:
            raise ReporterException(f"Config {config!r} is not one reporter definition")
        ((path, kwargs),) = config.items()
        reporter = postgres.REPORTERS.get(str(path).rsplit(".", 1)[-1])
        if reporter is None:
            raise ReporterException(f"Config {config!r} names no reporter of this package")
        return reporter(**(kwargs or {}))
