"""End-to-end spectral clustering with SPED (paper Secs. 1-2, 5).

Pipeline: edges -> L -> [spectrum transform + Eq. 8 reversal] -> top-k
solver (mu-EG / Oja) -> bottom-k eigenvector embedding -> k-means.

The operator is estimated three ways: ``exact_edges`` (the full edge
list), ``minibatch`` (a fresh uniform batch of edges per series factor,
paper Sec. 3) or ``walks`` (random walks on the edge incidence graph,
Sec. 4.3), with a fixed transform or with ``transform="auto"`` (probe
the spectrum and let :func:`repro_torch.spectral.plan_dilation` pick
family, degree and scale; the walks estimator skips the probe).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import spans
from repro_torch.core import kmeans as km
from repro_torch.core import laplacian as lap
from repro_torch.core import metrics, operators, series, solvers, walks

ESTIMATIONS = ("exact_edges", "minibatch", "walks")


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    num_clusters: int = 4
    extra_eigvecs: int = 1  # compute k + extra for a stable embedding
    # a series name, 'identity', or 'auto' (probe the spectrum and let
    # repro_torch.spectral.plan_dilation pick family + degree + scale)
    transform: str = "limit_neg_exp"
    degree: int = 251
    auto_scale: bool = True  # pre-scale L to a target radius (Fig. 4 fix)
    # effective decay strength tau: with auto_scale the transform acts like
    # -e^{-tau * lam / rho}
    dilation_strength: float = 8.0
    estimation: str = "exact_edges"  # exact_edges | minibatch | walks
    batch_edges: int = 1024
    num_walkers: int = 4096
    solver: solvers.SolverConfig = dataclasses.field(
        default_factory=solvers.SolverConfig)
    drop_trivial: bool = True  # skip the all-ones nullvector in the embedding
    kmeans_restarts: int = 8
    seed: int = 0
    # matvec / solver-step kernels (repro_torch.core.backend):
    # auto | segment | kernel; auto = kernel on CUDA, segment on the CPU
    backend: str = "auto"


def build_series(cfg: ClusteringConfig, rho_ub: float) -> series.SpectralSeries:
    scale = cfg.dilation_strength / max(rho_ub, 1e-30) if cfg.auto_scale else 1.0
    if cfg.transform == "identity":
        # no transform; reversal needs lambda* > rho(L) (Eq. 8)
        return series.with_lambda_star(series.identity_series(), rho_ub * 1.01)
    if cfg.transform == "limit_neg_exp":
        return series.limit_neg_exp(cfg.degree, scale=scale)
    if cfg.transform == "taylor_neg_exp":
        return series.taylor_neg_exp(cfg.degree)
    if cfg.transform == "taylor_log":
        return series.taylor_log(cfg.degree)
    if cfg.transform == "cheb_neg_exp":
        tau = cfg.dilation_strength / rho_ub if cfg.auto_scale else 1.0
        return series.cheb_neg_exp(cfg.degree, rho=rho_ub, tau=tau)
    if cfg.transform == "cheb_log":
        return series.cheb_log(cfg.degree, rho=rho_ub)
    raise ValueError(f"unknown transform {cfg.transform!r}")


@spans.span("sped.cluster", allocs=True)
def spectral_cluster(g: lap.EdgeList, cfg: ClusteringConfig,
                     v_star: torch.Tensor | None = None):
    """Run the full pipeline on the graph's device.  Returns
    (labels, info dict)."""
    if cfg.estimation not in ESTIMATIONS:
        raise ValueError(f"unknown estimation mode {cfg.estimation!r}")
    k = cfg.num_clusters + cfg.extra_eigvecs + (1 if cfg.drop_trivial else 0)
    plan = None
    with spans.span("sped.prep"):
        rho_ub = float(lap.spectral_radius_upper_bound(g))
        if cfg.transform == "auto" and cfg.estimation != "walks":
            # deferred: spectral builds on core
            from repro_torch import spectral

            gen = torch.Generator(device=g.device).manual_seed(cfg.seed + 3)
            _, plan = spectral.probe_and_plan(g, k=k, generator=gen,
                                              budget=cfg.degree,
                                              backend=cfg.backend)
            s = spectral.series_from_plan(plan)
            # solver steps are not scale-invariant: renormalize the user's lr
            # (tuned for a unit-scale series) to the planned operator's scale
            cfg = dataclasses.replace(
                cfg, solver=dataclasses.replace(
                    cfg.solver, lr=plan.suggested_lr(cfg.solver.lr)))
        elif cfg.transform == "auto":
            # the walks estimator builds its own low-degree operator below,
            # so a probe's plan would be discarded: s only names
            # info["series"]
            s = series.with_lambda_star(series.identity_series(),
                                        rho_ub * 1.01)
        else:
            s = build_series(cfg, rho_ub)
        if cfg.estimation == "exact_edges":
            op = operators.edge_series_operator(g, s, backend=cfg.backend)
        elif cfg.estimation == "minibatch":
            op = operators.minibatch_operator(g, s, cfg.batch_edges,
                                              backend=cfg.backend)
        else:
            # the walk variance grows with the degree: a LOW-degree
            # power-basis fit of the same spectral map (beyond the paper)
            deg = min(cfg.degree, 6)
            tau = cfg.dilation_strength / rho_ub if cfg.auto_scale else 1.0
            op = walks.walk_polynomial_operator(
                g, lap.build_edge_incidence(g),
                walks.lowdeg_negexp_coeffs(deg, rho_ub, tau), lambda_star=0.0,
                num_walkers=cfg.num_walkers)

        if v_star is None and g.num_nodes <= 4096:
            _, v_star = metrics.ground_truth_bottom_k(
                lap.laplacian_dense(g), k)

    scfg = dataclasses.replace(cfg.solver, k=k, seed=cfg.seed,
                               backend=cfg.backend)
    stochastic = cfg.estimation != "exact_edges"
    state, trace = solvers.run_solver(op, g.num_nodes, scfg, v_star=v_star,
                                      stochastic=stochastic, device=g.device)

    with spans.span("sped.post"):
        start = 1 if cfg.drop_trivial else 0
        embedding = state.v[:, start: start + cfg.num_clusters]
        # row-normalize the embedding (standard spectral clustering practice)
        norms = torch.linalg.vector_norm(embedding, dim=1, keepdim=True)
        embedding = embedding / torch.clamp(norms, min=1e-12)
        gen = torch.Generator(device=g.device).manual_seed(cfg.seed + 1)
        result = km.kmeans(gen, embedding, cfg.num_clusters,
                           restarts=cfg.kmeans_restarts)
    info = {
        "trace": trace,
        "series": s.name,
        "rho_ub": rho_ub,
        "eigvecs": state.v,
        "embedding": embedding,
        "plan": plan,
    }
    return result.labels, info


def exact_cluster_reference(g: lap.EdgeList, num_clusters: int, seed: int = 0):
    """Ground-truth pipeline via dense eigh, the oracle for tests."""
    _, v = metrics.ground_truth_bottom_k(lap.laplacian_dense(g), num_clusters,
                                         drop_trivial=True)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                        min=1e-12)
    gen = torch.Generator(device=g.device).manual_seed(seed + 1)
    return km.kmeans(gen, v, num_clusters).labels
