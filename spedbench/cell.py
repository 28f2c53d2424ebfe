"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

* ``configs/<config>.json`` (the file the config entry names): the graph
  generator, its parameters, ``num_clusters`` and ``k``;
* ``traffic/<mix>.json``: the job's ``ClusteringConfig`` and solver
  fields and S, the steps a job;
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``graphs/<generator>.py``: ``generate(params, seed, device)``;
* the config's ``reference``, a module under ``spedbench/``: the plain
  reference's ``solve`` and ``labels``;
* ``layers/<metric>.py``: ``read(ctx)``, one per per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def clustering(self) -> dict:
        return self.traffic["clustering"]

    @property
    def solver(self) -> dict:
        return self.traffic["solver"]

    @property
    def steps(self) -> int:
        s = self.solver
        return max(1, s["steps"] // s["eval_every"]) * s["eval_every"]


def _for_cell(metrics: list[dict], name: str) -> list[dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    cell = Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))
    k = (config["num_clusters"] + cell.clustering["extra_eigvecs"]
         + (1 if cell.clustering["drop_trivial"] else 0))
    if k != config["k"]:
        raise ValueError(f"{name}: the mix gives k = {k}, the config "
                         f"states {config['k']}")
    return cell


def generator(cell: Cell):
    """The ``generate`` function of the config's graph generator."""
    mod = importlib.import_module(f"spedbench.graphs.{cell.config['generator']}")
    return mod.generate


def reader(metric: str):
    """The ``read`` function of ``layers/<metric>.py``."""
    path = HERE / "layers" / f"{metric}.py"
    modname = "spedbench_layer_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(cell: Cell):
    """The module the config's ``reference`` names (a path such as
    ``spedbench/reference/pipeline.py``), imported by its dotted name."""
    path = Path(cell.config["reference"])
    if (path.suffix != ".py" or path.is_absolute() or ".." in path.parts
            or path.parts[0] != HERE.name):
        raise ValueError(f"{cell.name}: the reference {str(path)!r} is not "
                         f"a module under {HERE.name}/")
    return importlib.import_module(".".join(path.with_suffix("").parts))
