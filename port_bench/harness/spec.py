"""A cell by name: ``BENCHMARK.json`` at the checkout's root names its
configuration and traffic; each lives in a file of its own under
``port_bench/`` (``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``), and each metric in ``metrics/<name>.py``. A mix's
``kind`` names its runner, ``harness/<kind>.py``, and a serving mix's
``arrivals`` its generator, ``harness/arrivals/<arrivals>.py``. Adding a cell,
a mix or a metric adds files and entries, and edits none."""

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: str
    read: Callable  # read(run) -> float or None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    params: dict  # the cell's own file: rate, limits, ...
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def runner(kind: str):
    """``harness/<kind>.py``, the runner of a traffic mix's ``kind``."""
    if not (BENCH_DIR / "harness" / f"{kind}.py").exists():
        raise SystemExit(f"port_bench: no runner for traffic kind {kind!r} (harness/{kind}.py)")
    return importlib.import_module(f"harness.{kind}")


def load_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``; a metric ``<stem>.<family>`` with no
    file of its own is read by ``metrics/<stem>.py``, which the families
    whose reading is the same share."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: Dict = None) -> Cell:
    bench = bench if bench is not None else _load_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have: {', '.join(sorted(by_name))})")
    w = by_name[name]
    config = _load_json(BENCH_DIR / "configs" / f"{w['config']}.json")
    traffic = _load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    params = _load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = {**config, "precision": params["precision"]}  # a cell's own
    e2e = [Metric(m["name"], m["unit"], m["name"], load_reader(m["name"]))
           for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m.name for m in e2e}
    layer = [Metric(m["name"], m["unit"], m["moves"], load_reader(m["name"]))
             for m in bench["per_layer"]
             if m["moves"] in reported and _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, params, e2e, layer)
