"""
``capture_args`` (the port of the one in ``gordo_tpu.utils.utils``): an
object records its constructor arguments so ``to_dict`` can give them
back; and ``backoff_seconds``, the house retry policy (the port of
``gordo_tpu.client.utils.backoff_seconds``).
"""

import functools
import inspect
import random
from typing import Optional


def backoff_seconds(attempt: int, cap: int = 300, jitter: float = 0.0,
                    rng: Optional[random.Random] = None) -> float:
    """Seconds before retry ``attempt`` (1-based): 8, 16, 32, ..., at most
    ``cap``; with ``jitter`` a delay lands uniformly in ``[base * (1 -
    jitter), base]``, drawn from ``rng`` (default: ``random``'s)."""
    base = min(2 ** (attempt + 2), cap)
    if not jitter:
        return base
    return base * (1.0 - jitter * (rng or random).random())


def capture_args(init):
    """
    Decorate ``__init__`` to record the call's arguments on
    ``self._params``: positional ones by name, defaults of the ones left
    out too (so the record is the effective configuration), and a
    trailing ``**kwargs`` flattened into the record.
    """

    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        sig = inspect.signature(init)
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        params = dict(bound.arguments)
        params.pop("self", None)
        for name, param in sig.parameters.items():
            if param.kind is inspect.Parameter.VAR_KEYWORD and name in params:
                params.update(params.pop(name))
            if param.kind is inspect.Parameter.VAR_POSITIONAL and name in params:
                params[name] = list(params[name])
        self._params = params
        return init(self, *args, **kwargs)

    return wrapper
