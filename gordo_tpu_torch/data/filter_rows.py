"""
Row filters (the counterpart of ``gordo_tpu.data.filter_rows``).

A row filter is a pandas ``eval`` expression over the tag columns; the
port has no expression evaluator yet, so it carries only the default,
the empty filter.
"""


def check_row_filter(row_filter) -> None:
    """Raise for a non-empty ``row_filter``: it is not ported yet."""
    if row_filter:
        raise NotImplementedError(
            f"row_filter {row_filter!r} is not ported yet (ROADMAP.md queue 1: "
            "non-empty row_filter and filter_periods)"
        )
