"""How requests arrive at a serving cell: ``harness/arrivals/<name>.py``,
found by the ``arrivals`` of a traffic mix. Each module has

- ``plan(traffic, params, seconds, rng) -> (n, due)``: how many requests
  the schedule holds, and their due offsets from the window's start (None
  where a request is due when it is sent);
- ``drive(traffic, n, due, submit, freed, t0, seconds)``: sends them, calling
  ``submit(i)`` at the moment request ``i`` is sent; ``freed`` is a
  ``queue.Queue`` that receives each request's index once it is answered,
  lost or refused."""

import importlib


def load(name: str):
    try:
        return importlib.import_module(f"harness.arrivals.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"harness.arrivals.{name}":
            raise
        raise SystemExit(f"port_bench: no arrivals {name!r} (harness/arrivals/{name}.py)") from e
