"""
The config overlay (the port of ``gordo_tpu.workflow.helpers``).
"""

from copy import deepcopy


def patch_dict(original_dict: dict, patch_dictionary: dict) -> dict:
    """
    ``patch_dictionary`` laid over ``original_dict``: every path of the
    patch is added or replaces the value there; nothing is removed. A new
    dict is returned and neither input changes.

    >>> patch_dict({"highKey": {"lowkey1": 1, "lowkey2": 2}}, {"highKey": {"lowkey1": 10}})
    {'highKey': {'lowkey1': 10, 'lowkey2': 2}}
    """
    result = deepcopy(original_dict)

    def merge(base: dict, patch: dict) -> None:
        for key, value in patch.items():
            if isinstance(value, dict) and isinstance(base.get(key), dict):
                merge(base[key], value)
            else:
                base[key] = deepcopy(value)

    merge(result, patch_dictionary)
    return result
