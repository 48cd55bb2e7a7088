"""
General transformer functions (the port of
``gordo_tpu.models.transformer_funcs.general``), for a config's
``FunctionTransformer`` step::

    sklearn.preprocessing.FunctionTransformer:
      func: gordo_tpu.models.transformer_funcs.general.multiply_by
      kw_args: {factor: 2}
"""


def multiply_by(X, factor):
    """The input times a constant factor."""
    return X * factor
