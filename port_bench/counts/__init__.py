"""The benchmark's own arithmetic: operations and bytes computed from
shapes, and the table of the card's published peaks. One module per
architecture (``counts/<arch>.py``), found by the ``arch`` of a
configuration file, so a new architecture adds a file and edits none."""

import importlib


def for_arch(arch: str):
    """The counts module of an architecture (``counts/<arch>.py``)."""
    return importlib.import_module(f"counts.{arch}")
