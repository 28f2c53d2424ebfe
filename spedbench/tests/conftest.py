"""CPU tests of the benchmark: ``python -m pytest spedbench/tests -q``
from the root of the checkout (the card-only test is marked ``cuda``)."""
from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("sbm4m.limit251", "g500-s22.limit251")


def shrink(cell):
    """The cell at a size a CPU test holds: 4,200 SBM nodes or a SCALE 13
    Kronecker graph (past 4,096 nodes, where the program skips its dense
    oracle), a degree-31 series, 2 k-means restarts and B = 2,048; every
    other field, and the limits, as committed."""
    config = dict(cell.config)
    if config["generator"] == "kronecker":
        config.update(scale=13, num_nodes=1 << 13)
    else:
        config.update(num_nodes=4200)
    traffic = copy.deepcopy(cell.traffic)
    traffic["clustering"].update(degree=31, kmeans_restarts=2,
                                 batch_edges=2048)
    return dataclasses.replace(cell, config=config, traffic=traffic)


@pytest.fixture
def tiny_cell():
    from spedbench import cell as cells

    return lambda name: shrink(cells.load(name))
