"""
Noisy-period filters (the counterpart of ``gordo_tpu.data.filter_periods``).

The port carries only the default, no period filter.
"""


def check_filter_periods(filter_periods) -> None:
    """Raise for a non-empty ``filter_periods``: it is not ported yet."""
    if filter_periods:
        raise NotImplementedError(
            f"filter_periods {filter_periods!r} is not ported yet (ROADMAP.md "
            "queue 1: non-empty row_filter and filter_periods)"
        )
