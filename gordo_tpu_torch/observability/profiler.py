"""
Profiler trace hooks (the port of ``gordo_tpu.observability.profiler``),
on ``torch.profiler``.

``maybe_trace(name, directory)`` traces a region's host and card activity
(CPU operators, CUDA runtime calls and kernels, the flash kernels among
them) into ``<directory>/<name>-<unix_ms>/trace.json``, a Chrome trace
(``export_chrome_trace``: Perfetto and ``chrome://tracing`` load it)
where the JAX package writes a TensorBoard dump. The directory is the
argument, else ``GORDO_TPU_PROFILE_DIR``; with neither the region runs
untraced and nothing here touches torch.

``annotate(name)`` is ``torch.profiler.record_function(name)`` inside an
active ``maybe_trace`` region of the calling thread, so builder phases
(``data-fetch``, ``cross-validation``, ``fit``) and the fleet trainer's
``train-dispatch`` show as named ranges over their kernels; outside one
it is a no-op.

A profiler that fails never breaks the traced work (``_profiler_call``):
torch allows one profiler a process, so a region entered while another
profiler runs is not traced, with a warning, and runs as it would.
"""

import contextlib
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

PROFILE_DIR_ENV_VAR = "GORDO_TPU_PROFILE_DIR"

#: the file a trace directory holds
TRACE_FILENAME = "trace.json"

# set while a maybe_trace region is active, so annotate() works for both
# env-var and explicit-directory tracing
_active = threading.local()

#: distinguishable "the profiler call failed" result
_FAILED = object()


def _profiler_call(what: str, fn):
    """Run one ``torch.profiler`` operation, returning :data:`_FAILED`
    (and warning) instead of raising: a missing CUDA profiler, a second
    profiler or an export error must never break the traced work."""
    try:
        import torch.profiler

        return fn(torch.profiler)
    except Exception:
        logger.warning("Could not %s", what, exc_info=True)
        return _FAILED


def profile_dir() -> str:
    """The configured trace directory, or '' when tracing is off."""
    return os.environ.get(PROFILE_DIR_ENV_VAR, "")


def _start(profiler):
    import torch

    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    session = profiler.profile(activities=activities)
    session.start()
    return session


def _stop(session, target: str) -> str:
    session.stop()
    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, TRACE_FILENAME)
    session.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(name: str, directory: str = ""):
    """
    Trace the region into ``<directory>/<name>-<unix_ms>/trace.json`` when
    a directory is configured (the argument wins over the environment);
    a no-op otherwise. A profiler failure never breaks the traced work.
    """
    directory = directory or profile_dir()
    if not directory:
        yield
        return

    target = os.path.join(directory, f"{name}-{int(time.time() * 1000)}")
    session = _profiler_call("start torch profiler trace", _start)
    started = session is not _FAILED
    if started:
        _active.tracing = True
    try:
        yield
    finally:
        if started:
            _active.tracing = False
            path = _profiler_call("stop torch profiler trace",
                                  lambda profiler: _stop(session, target))
            if path is not _FAILED:
                logger.info("Wrote profiler trace to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """
    A named range inside an active ``maybe_trace`` region; a no-op when
    none is active, and never breaks the annotated work if the profiler
    is unusable.
    """
    if not getattr(_active, "tracing", False):
        yield
        return
    span = _profiler_call("annotate torch profiler trace",
                          lambda profiler: profiler.record_function(name))
    if span is _FAILED:
        yield
        return
    with span:
        yield
