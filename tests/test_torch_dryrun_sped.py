"""The port's SPED dry-run (``repro_torch.launch.dryrun_sped``) against
the JAX package's.

  * the four variants of ``build_step`` on one gloo world of 2 CPU ranks
    (a (2, 1) ("data", "model") mesh, each rank holding its edge slice;
    ``tests/torch_dist_ranks.run_dryrun_sped``) against
    ``repro.launch.dryrun_sped.build_step`` on a (1, 1) CPU mesh, at
    n = 512, E = 4096, k = 8, from the same edges and panel: the f32
    variants to 1e-5 max-abs (measured 6.0e-8); ``cheb64_bf16`` to 2e-3
    of the panel's largest magnitude (measured 5.3e-4: both round the
    series' panel to bf16 after every operation, the port's scatter
    adding in bf16 over two edge slices and then across the ranks, the
    JAX package's over one);
  * the all_reduces a step and their payload, counted at run time;
  * ``run_cell``'s keys and its ``analytic`` values against the JAX
    package's formulas on its own series;
  * ``main`` as a subprocess: the 8 cells' file names and summary lines.

``repro.launch.dryrun_sped`` asks XLA for 512 host devices when imported:
it is imported inside the fixture, after ``jax.devices()``, with
``XLA_FLAGS`` restored after.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro import compat
from repro_torch import parallel
from repro_torch.launch import dryrun_sped

ROOT = Path(__file__).resolve().parents[1]
N, E, K = 512, 4096, 8
F32_TOL = 1e-5
BF16_TOL = 2e-3  # of the panel's largest magnitude
MATVECS = {"limit251": 251, "cheb64": 65, "cheb64_fused": 65,
           "cheb64_bf16": 65}  # Clenshaw: degree + 1, the first on zeros
PER_MATVEC = {"limit251": 2, "cheb64": 2, "cheb64_fused": 1, "cheb64_bf16": 1}


def _inputs():
    edges = {k: v.numpy() for k, v in dryrun_sped.random_edges(
        N, E, seed=3, device="cpu").items()}
    v = np.linalg.qr(np.random.default_rng(4).standard_normal((N, K)))[0]
    return {"edges": edges, "v": np.ascontiguousarray(v, np.float32)}


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    jax.devices()  # the backend is up: the import below cannot change it
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("XLA_FLAGS", raising=False)
        from repro.launch import dryrun_sped as jsped

        mesh = compat.make_mesh((1, 1), ("data", "model"))
        want = {}
        with compat.set_mesh(mesh):
            for variant in dryrun_sped.VARIANTS:
                step = jax.jit(jsped.build_step(variant, mesh,
                                                ("data", "model")))
                want[variant] = np.asarray(step(
                    jnp.asarray(inputs["v"]),
                    {k: jnp.asarray(a) for k, a in inputs["edges"].items()}))
    results = parallel.run_ranks(2, ranks.run_dryrun_sped, inputs, device="cpu",
                                 timeout=300.0)
    return {"ranks": [r.value for r in results], "want": want, "jsped": jsped}


@pytest.mark.parametrize("variant", dryrun_sped.VARIANTS)
def test_variant_matches_repro(world, variant):
    want = world["want"][variant]
    for r in world["ranks"]:
        got = r[variant][0]
        assert got.shape == want.shape and np.isfinite(got).all()
        err = float(np.abs(got - want).max())
        if variant.endswith("bf16"):
            assert err <= BF16_TOL * float(np.abs(want).max()), err
        else:
            assert err <= F32_TOL, err
    assert parallel.bitwise_equal([r[variant][0] for r in world["ranks"]])


@pytest.mark.parametrize("variant", dryrun_sped.VARIANTS)
def test_all_reduces_a_step(world, variant):
    count = MATVECS[variant] * PER_MATVEC[variant]
    item = 2 if variant.endswith("bf16") else 4
    for r in world["ranks"]:
        _, calls, nbytes = r[variant]
        assert calls == count
        assert nbytes == count * N * K * item
    cell = dryrun_sped.run_cell(variant, False, device="cpu")
    assert cell["collectives"]["count"] == {"all-reduce": count}
    assert cell["collectives"]["total_bytes"] == (
        count * dryrun_sped.N_NODES * dryrun_sped.K * item)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("variant", dryrun_sped.VARIANTS)
def test_run_cell_keys_and_analytic(world, variant, multi_pod):
    jsped = world["jsped"]
    rec = dryrun_sped.run_cell(variant, multi_pod, device="cpu")
    assert set(rec) == {"arch", "shape", "mesh", "status", "kind", "devices",
                        "seconds", "flops", "bytes_accessed", "analytic",
                        "memory", "collectives"}
    devices = 512 if multi_pod else 256
    s = jsped.make_series(variant)
    assert rec["devices"] == devices
    assert rec["arch"] == f"sped-graph-{variant}"
    assert rec["shape"] == "n4M_e64M_k32"
    assert rec["mesh"] == ("multipod" if multi_pod else "pod")
    assert rec["analytic"] == {
        "flops_per_dev": s.degree * (6.0 * jsped.N_EDGES * jsped.K) / devices,
        "hbm_bytes_per_dev": s.degree * (
            jsped.N_EDGES * (3 * 4 + 2 * 4 * jsped.K) / devices
            + 2 * jsped.N_NODES * jsped.K * 4),
        "degree": s.degree}
    panel = jsped.N_NODES * jsped.K * 4
    assert rec["memory"] == {"argument_bytes": panel + jsped.N_EDGES // devices
                             * 12, "output_bytes": panel, "temp_bytes": None}
    assert rec["flops"] is None and rec["bytes_accessed"] is None
    assert (dryrun_sped.N_NODES, dryrun_sped.N_EDGES, dryrun_sped.K,
            dryrun_sped.RHO_UB) == (jsped.N_NODES, jsped.N_EDGES, jsped.K,
                                    jsped.RHO_UB)


def test_main_writes_the_eight_cells(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun_sped", "--out",
         str(tmp_path), "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == sorted(f"sped__{v}__{m}.json" for v in dryrun_sped.VARIANTS
                           for m in ("pod", "multipod"))
    lines = [l for l in out.stdout.splitlines() if l.startswith("[sped-dryrun]")]
    assert len(lines) == 8 and "AR count 502" in lines[0]
    rec = json.loads((tmp_path / "sped__cheb64_fused__pod.json").read_text())
    assert rec["status"] == "ok" and rec["kind"] == "sped_step"
