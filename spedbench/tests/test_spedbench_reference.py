"""The plain reference against the program's plain (``backend="segment"``)
pipeline on the CPU at a tiny size, and the reference's own pieces."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from spedbench.graphs import planted_partition as pp
from spedbench.reference import compare, pipeline

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
CLUSTERING = {"transform": "limit_neg_exp", "degree": 31, "auto_scale": True,
              "dilation_strength": 8.0, "extra_eigvecs": 1,
              "drop_trivial": True, "kmeans_restarts": 2,
              "batch_edges": 2048}
SOLVER = {"method": "mu_eg", "lr": 1e-3, "steps": 4, "eval_every": 2}


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest_even():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, 1 + 0.51 * ulp,
                      -(1 + 1.5 * ulp), 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + 2 * ulp, 1 + ulp, -(1 + 2 * ulp), 3.0])
    assert torch.equal(pipeline.tf32_round(x), want)
    r = pipeline.tf32_round(torch.randn(1000))
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())


def test_laplacian_sums_duplicates():
    edges = torch.tensor([[0, 1], [1, 2], [0, 1], [3, 2]], dtype=torch.int32)
    lap = pipeline.laplacian_csr(edges, 4).to_dense()
    want = torch.tensor([[2., -2, 0, 0], [-2, 3, -1, 0], [0, -1, 2, -1],
                         [0, 0, -1, 1]])
    assert torch.equal(lap, want)


def test_series_step_uses_twice_the_largest_degree():
    deg = torch.tensor([1.0, 5.0, 2.0])
    assert pipeline.series_c(deg, CLUSTERING) == pytest.approx(8.0 / 10 / 31)


@pytest.mark.parametrize("estimation", ["exact_edges", "minibatch"])
def test_reference_matches_the_segment_pipeline(estimation):
    from repro_torch.core import clustering, laplacian, solvers

    n, k = 4200, 8  # past 4096 nodes the program skips its dense oracle
    edges = pp.generate({"num_nodes": n, "num_blocks": k,
                         "avg_degree_in": 16, "avg_degree_out": 1}, 21, "cpu")
    clu = {**CLUSTERING, "estimation": estimation}
    g = laplacian.make_edge_list(edges, n, device="cpu")
    cfg = clustering.ClusteringConfig(
        num_clusters=k, seed=77, backend="segment",
        solver=solvers.SolverConfig(**SOLVER), **clu)
    labels, info = clustering.spectral_cluster(g, cfg)
    ref = pipeline.solve(edges, n, clu, SOLVER, k, 77)
    ref_labels = pipeline.labels(info["eigvecs"], clu, k, 77)
    got = compare.numbers(info["eigvecs"], labels, ref, ref_labels)
    assert got["eigvec_err"] < 1e-3
    assert got["label_mismatch"] == 0.0
    # the panel moved: a step left out would read 1
    assert float((ref.v - ref.v0).norm()) > 1e-4


def test_judge_fails_a_value_over_its_limit_or_missing():
    ok, checks = compare.judge({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0.0})
    assert ok and checks["a"] == {"value": 0.1, "limit": 0.2}
    assert not compare.judge({"a": 0.3, "b": 0.0}, {"a": 0.2, "b": 0.0})[0]
    assert not compare.judge({"a": 0.1}, {"a": 0.2, "b": 0.0})[0]
    assert not compare.judge({"a": float("nan")}, {"a": 0.2})[0]


def test_reference_imports_nothing_of_the_program():
    """The reference is plain PyTorch: no JAX, no JAX package, nothing of
    the program, and no other module of the benchmark but its own."""
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro",
                                   "repro_torch"), (path.name, name)
                if top == "spedbench":
                    assert name.startswith("spedbench.reference"), name
