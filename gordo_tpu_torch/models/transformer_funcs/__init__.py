"""
Functions a ``FunctionTransformer`` pipeline step may name (the port of
``gordo_tpu.models.transformer_funcs``).
"""

from .general import multiply_by

#: the ported functions, by the JAX package's path
FUNCTIONS = {"gordo_tpu.models.transformer_funcs.general.multiply_by": multiply_by}
# the reference's and the port's own prefixes, read as the JAX package's
_PREFIXES = (
    ("gordo.machine.model.transformer_funcs.", "gordo_tpu.models.transformer_funcs."),
    ("gordo_tpu_torch.models.transformer_funcs.", "gordo_tpu.models.transformer_funcs."),
)


def resolve_function(path: str):
    """The ported function a config names by path; any other path raises
    ``ValueError``, since the port imports no code a config names."""
    for old, new in _PREFIXES:
        if path.startswith(old):
            path = new + path[len(old) :]
    try:
        return FUNCTIONS[path]
    except KeyError:
        raise ValueError(
            f"FunctionTransformer func {path!r} is not a function the port has; "
            f"ported: {sorted(FUNCTIONS)}"
        ) from None
