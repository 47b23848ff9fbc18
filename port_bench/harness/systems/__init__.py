"""How the benchmark builds the program and its plain reference for each
architecture: ``harness/systems/<arch>.py``, found by the ``arch`` of a
configuration file."""

import importlib


def for_arch(arch: str):
    return importlib.import_module(f"harness.systems.{arch}")
