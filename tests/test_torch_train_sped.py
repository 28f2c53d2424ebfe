"""The port's SPED training loop (``launch/train.py --mode sped``) on the
CPU, against the JAX package's.

  * five steps fed ``repro``'s own draws through the minibatch
    operator's ``sel`` (row i of step t: ``randint(fold_in(fold_in(
    PRNGKey(seed + 7), t), i))``, as tests/test_torch_minibatch.py
    replays them), from JAX's init panel: the panel equals ``repro``'s
    to 1e-5 max-abs (the TOL of tests/test_backend.py; measured 4.5e-8);
  * the port of tests/test_system.py's SPED training test (250 steps, 150
    nodes, 3 clusters, a checkpoint directory), with the subspace error
    and cluster agreement of both packages' runs beside each other (the
    draws differ, so the bar is the clustering: both recover the
    cliques, errors within 0.1);
  * a run resumed from its step-200 checkpoint ends bitwise equal to the
    uninterrupted run: step t draws from a generator seeded from
    (seed + 7, t), so a resume replays nothing.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.core import graphs as jgraphs
from repro.core import limit_neg_exp as jlimit_neg_exp
from repro.core import operators as jops
from repro.core import solvers as jsolvers
from repro.core import spectral_radius_upper_bound as jrho
from repro_torch.core import solvers
from repro_torch.launch import train
from repro_torch.train import checkpoint as ckpt

CPU = torch.device("cpu")
TOL = 1e-5
SPED_ARGS = ["--mode", "sped", "--steps", "250", "--nodes", "150",
          "--clusters", "3", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One ATen thread for this module's many small-tensor ops, restored
    after (parallel workers share the CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_sped_steps_fed_jax_draws_match_repro():
    args = train.parse_args(SPED_ARGS)
    g, _, op = train.sped_problem(args, CPU)
    gj, _ = jgraphs.clique_graph(args.nodes, args.clusters, seed=args.seed)
    series = jlimit_neg_exp(args.degree, scale=args.tau / float(jrho(gj)))
    jop = jops.minibatch_operator(gj, series, batch_edges=args.batch_edges)
    k = args.clusters + 1
    jstate = jsolvers.init_state(jax.random.PRNGKey(args.seed), g.num_nodes, k)
    step_fn = jax.jit(lambda st, key: jsolvers.mu_eg_step(st, jop(key, st.v),
                                                          args.lr))
    state = solvers.SolverState(v=torch.from_numpy(np.array(jstate.v)),
                                step=torch.zeros((), dtype=torch.int32))
    key = jax.random.PRNGKey(args.seed + 7)
    for t in range(5):
        kt = jax.random.fold_in(key, t)
        jstate = step_fn(jstate, kt)
        sel = torch.from_numpy(np.stack([
            np.asarray(jax.random.randint(jax.random.fold_in(kt, i),
                                          (args.batch_edges,), 0, g.num_edges))
            for i in range(args.degree + 1)]))
        state = train.sped_step(op, state, t, args, sel=sel)
    assert float(np.abs(state.v.numpy() - np.asarray(jstate.v)).max()) <= TOL
    assert int(state.step) == int(jstate.step) == 5


def test_sped_training_loop_converges(tmp_path, capsys):
    assert train.main(SPED_ARGS + ["--ckpt-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    err, acc = (float(x) for x in
                out.split("subspace_error ")[1].split(" cluster_accuracy "))
    assert ckpt.latest_step(str(tmp_path / "ck")) == 200
    jerr, jacc = jtrain.train_sped(argparse.Namespace(
        **{**vars(train.parse_args(SPED_ARGS)), "ckpt_dir": None}))
    assert acc == jacc == 1.0
    assert abs(err - jerr) <= 0.1 and err < 0.5


def test_sped_resume_is_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    full = train.train_sped(train.parse_args(SPED_ARGS + ["--ckpt-dir", ck]), CPU)
    assert ckpt.latest_step(ck) == 200  # no save at 250: not a multiple
    resumed = train.train_sped(train.parse_args(SPED_ARGS + ["--ckpt-dir", ck]), CPU)
    assert (full.steps, resumed.steps) == (250, 50)
    assert torch.equal(resumed.v, full.v)
    assert (resumed.error, resumed.accuracy) == (full.error, full.accuracy)
