"""End-to-end spectral clustering with SPED (paper Secs. 1-2, 5).

Pipeline: edges -> L -> [spectrum transform + Eq. 8 reversal] -> top-k
solver (mu-EG / Oja) -> bottom-k eigenvector embedding -> k-means.

The port runs the ``exact_edges`` estimation with a fixed transform;
``transform="auto"`` and the ``minibatch`` and ``walks`` estimators come
with later slices of the port and raise here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kmeans as km
from repro_torch.core import laplacian as lap
from repro_torch.core import metrics, operators, series, solvers


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    num_clusters: int = 4
    extra_eigvecs: int = 1  # compute k + extra for a stable embedding
    transform: str = "limit_neg_exp"  # a series name, or 'identity'
    degree: int = 251
    auto_scale: bool = True  # pre-scale L to a target radius (Fig. 4 fix)
    # effective decay strength tau: with auto_scale the transform acts like
    # -e^{-tau * lam / rho}
    dilation_strength: float = 8.0
    estimation: str = "exact_edges"
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
    if cfg.transform == "auto":
        raise NotImplementedError(
            "transform='auto' (probe and plan) arrives with ROADMAP slice 3, "
            "the auto-tuned path")
    raise ValueError(f"unknown transform {cfg.transform!r}")


def spectral_cluster(g: lap.EdgeList, cfg: ClusteringConfig,
                     v_star: torch.Tensor | None = None):
    """Run the full pipeline on the graph's device.  Returns
    (labels, info dict)."""
    if cfg.estimation in ("minibatch", "walks"):
        raise NotImplementedError(
            f"estimation={cfg.estimation!r} arrives with ROADMAP slice 4, "
            "the stochastic estimators")
    if cfg.estimation != "exact_edges":
        raise ValueError(cfg.estimation)
    rho_ub = float(lap.spectral_radius_upper_bound(g))
    k = cfg.num_clusters + cfg.extra_eigvecs + (1 if cfg.drop_trivial else 0)
    s = build_series(cfg, rho_ub)
    scfg = dataclasses.replace(cfg.solver, k=k, seed=cfg.seed,
                               backend=cfg.backend)
    op = operators.edge_series_operator(g, s, backend=cfg.backend)

    if v_star is None and g.num_nodes <= 4096:
        _, v_star = metrics.ground_truth_bottom_k(lap.laplacian_dense(g), k)

    state, trace = solvers.run_solver(op, g.num_nodes, scfg, v_star=v_star,
                                      device=g.device)

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
        "plan": None,
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
