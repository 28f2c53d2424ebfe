"""Matrix-free spectral probes: SLQ, Hutchinson, and edge localizers.

The dilation transforms have free parameters (degree, spectral-radius
scale, reversal shift) whose right values depend on the graph's
spectrum.  This module estimates that spectrum with a handful of matvecs
of the ``MatVec`` convention of :mod:`repro_torch.core.operators`.

``lanczos``
    m-step Lanczos with full (twice-is-enough classical Gram-Schmidt)
    reorthogonalization.  Breakdown (Krylov space exhausted, e.g. m >= n)
    is sticky: the recurrence continues on zero vectors, which appends
    decoupled zero-weight blocks to the tridiagonal.  It runs P starting
    vectors at once as one (n, P) panel, so each step is ONE matvec of the
    panel (one kernel launch on the card); the reorthogonalization and the
    breakdown test are per column.
``slq_probe``
    Stochastic Lanczos quadrature (Ubaru, Chen & Saad 2017): each probe's
    tridiagonal yields Ritz nodes and weights (squared first eigenvector
    components), from which come a residual-corrected ``lambda_max``, a
    trace estimate and a coarse spectral density.
``hutchinson_trace``
    Girard-Hutchinson trace estimator with Rademacher probes, for plain
    and generator-taking (stochastic) matvecs.
``bottom_edge``
    Bottom-edge eigengap localizer on the estimated counting function.

Random draws come from an explicit ``torch.Generator`` on the graph's
device, so they differ from the JAX package's ``jax.random`` draws; the
tests inject the same probe vectors to compare the two.  ``ritz``,
``weights`` and ``trace`` are fp32, as in the JAX package, and the host
readouts cast them to float64, so a plan depends on the same values.

Node-padded operators are handled by ``n_real``: probe vectors are
masked to the first ``n_real`` rows.  ``probe_sharded_edge_arrays`` runs
the same probe over edge buffers sharded across ranks, and
``probe_model_sharded`` over panel shards (each rank's owned rows).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.laplacian import EdgeList
from repro_torch.device import resolve_device

MatVec = Callable[[torch.Tensor], torch.Tensor]

# Breakdown test is RELATIVE to the raw matvec norm: normalizing a
# residual that is pure round-off would amplify its non-orthogonal
# round-off and poison every later reorthogonalization, so such steps
# terminate the recurrence instead.
_BREAKDOWN_REL = 1e-4
_TINY = 1e-30


class ProbeResult(NamedTuple):
    """Compressed spectral information from one SLQ run (fp32 tensors);
    ``n`` is the REAL node count the quadrature is normalized to."""

    ritz: torch.Tensor  # (num_probes, num_steps) Ritz nodes per probe
    weights: torch.Tensor  # (num_probes, num_steps) quadrature weights, rows sum to 1
    lambda_max: torch.Tensor  # () residual-corrected top-edge estimate
    trace: torch.Tensor  # () SLQ estimate of tr(L)
    n: torch.Tensor  # () float32 real node count
    num_matvecs: torch.Tensor  # () int32 probe cost in single-vector matvecs


def lanczos(matvec: MatVec, v0: torch.Tensor, num_steps: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """m-step Lanczos with full reorthogonalization.

    ``v0`` is an (n, P) panel of starting vectors (need not be normalized;
    one vector is passed as ``v[:, None]``); ``matvec`` maps (n, P)
    panels.  Returns (alpha, beta), each (P, m): the tridiagonal is
    diag(alpha) + offdiag(beta[..., :-1]); beta[..., -1] is the residual
    norm feeding the Ritz-value error bound.
    """
    n, p = v0.shape
    # probe-major working copies: q[j] is (P, n), rows of one probe
    # contiguous for the reorthogonalization products
    q0 = v0.T / torch.clamp(torch.linalg.vector_norm(v0, dim=0),
                            min=_TINY)[:, None]
    # num_steps + 1 vectors: the last is scratch for the final next-vector
    q = torch.zeros((p, num_steps + 1, n), dtype=v0.dtype, device=v0.device)
    q[:, 0] = q0
    alpha = torch.zeros((p, num_steps), dtype=v0.dtype, device=v0.device)
    beta = torch.zeros_like(alpha)
    for i in range(num_steps):
        w = matvec(q[:, i].T.contiguous()).T  # (P, n), one panel matvec
        raw_norm = torch.linalg.vector_norm(w, dim=1)
        alpha[:, i] = (q[:, i] * w).sum(dim=1)
        # full reorthogonalization against every stored vector (rows > i
        # are zero, so no masking); twice removes the first pass's residue
        for _ in range(2):
            coef = torch.bmm(q, w[:, :, None])  # (P, m+1, 1)
            w = w - torch.bmm(q.transpose(1, 2), coef)[:, :, 0]
        b = torch.linalg.vector_norm(w, dim=1)
        keep = (b > _BREAKDOWN_REL * (raw_norm + _TINY)).to(w.dtype)
        q[:, i + 1] = keep[:, None] * w / torch.clamp(b, min=_TINY)[:, None]
        beta[:, i] = keep * b
    return alpha, beta


def _tridiag_eig(alpha: torch.Tensor, beta: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta, U) of the m x m Lanczos tridiagonal(s); batched over any
    leading dimensions of alpha (..., m)."""
    t = torch.diag_embed(alpha)
    if alpha.shape[-1] > 1:
        t = t + torch.diag_embed(beta[..., :-1], 1) \
            + torch.diag_embed(beta[..., :-1], -1)
    return torch.linalg.eigh(t)


def _mask(n: int, n_real, device) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=device)
            < float(n_real)).to(torch.float32)


def slq_probe(
    matvec: MatVec,
    n: int,
    generator: torch.Generator | None = None,
    *,
    num_probes: int = 4,
    num_steps: int = 24,
    n_real: int | torch.Tensor | None = None,
    v0: torch.Tensor | None = None,
) -> ProbeResult:
    """Stochastic Lanczos quadrature of the operator's spectrum.

    The probe vectors are an (n, num_probes) standard-normal panel drawn
    from ``generator`` on its device, or the given ``v0``; ``n_real``
    masks them to the real rows of a node-padded operator.
    """
    if v0 is None:
        v0 = torch.randn((n, num_probes), generator=generator,
                         dtype=torch.float32, device=generator.device)
    num_probes = v0.shape[1]
    n_real_f = torch.tensor(float(n if n_real is None else n_real),
                            dtype=torch.float32, device=v0.device)
    if n_real is not None:
        v0 = v0 * _mask(n, n_real, v0.device)[:, None]
    alpha, beta = lanczos(matvec, v0, num_steps)
    theta, u = _tridiag_eig(alpha, beta)
    weights = u[:, 0, :] ** 2  # quadrature weights; rows sum to 1
    # Ritz residual ||L y - theta y|| = beta_m |e_m^T u| per pair
    resid = beta[:, -1:] * torch.abs(u[:, -1, :])
    lam_ub = torch.max(theta + resid, dim=1).values
    trace = n_real_f * torch.mean(torch.sum(weights * theta, dim=1))
    return ProbeResult(
        ritz=theta,
        weights=weights,
        lambda_max=torch.max(lam_ub),
        trace=trace,
        n=n_real_f,
        num_matvecs=torch.tensor(num_probes * num_steps, dtype=torch.int32),
    )


def probe_edge_arrays(
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    generator: torch.Generator | None,
    n_real: int | torch.Tensor,
    *,
    num_nodes: int,
    num_probes: int = 4,
    num_steps: int = 24,
    backend: str = "auto",
) -> ProbeResult:
    """SLQ over bare (possibly capacity-padded) edge buffers.

    ``backend`` routes the probe matvec through
    :mod:`repro_torch.core.backend` ("auto": K1 on the card, segment on
    the CPU), so the estimate runs the same kernels as the solve: on the
    kernel path each Lanczos step is one K1 launch on the
    (n, num_probes) panel, at any n.
    """
    from repro_torch.core import backend as backend_mod

    matvec = backend_mod.edge_arrays_matvec_fn(src, dst, weight, backend)
    return slq_probe(matvec, num_nodes, generator, num_probes=num_probes,
                     num_steps=num_steps, n_real=n_real)


def probe_sharded_edge_arrays(
    mesh,
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    generator: torch.Generator | None,
    n_real: int | torch.Tensor,
    *,
    num_nodes: int,
    edge_axes=("data",),
    num_probes: int = 4,
    num_steps: int = 24,
    backend: str = "auto",
    v0: torch.Tensor | None = None,
) -> ProbeResult:
    """SLQ over edge buffers SHARDED over the mesh's edge axes: the same
    Lanczos recurrence as :func:`probe_edge_arrays`, each matvec the
    rank's slice (K1 over its row CSR on the card) and one all_reduce
    (``core.distributed``), so a sharded service's dilation anchors agree
    with a one-device service's up to the order of the sums.  Every rank
    passes the same global buffers (their length divisible by the shard
    count) and the same ``generator`` state or ``v0``, and gets the same
    result."""
    from repro_torch import parallel
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import distributed

    local = distributed._local_fused(
        mesh, edge_axes, src, dst, weight, num_nodes,
        backend_mod.resolve_backend(backend, src.device))
    matvec = distributed._psum_matvec(local, parallel.edge_group(mesh, edge_axes))
    return slq_probe(matvec, num_nodes, generator, num_probes=num_probes,
                     num_steps=num_steps, n_real=n_real, v0=v0)


def probe_model_sharded(
    mesh,
    rows,
    n_real: int | torch.Tensor,
    *,
    num_nodes: int | None = None,
    model_axes=("model",),
    num_probes: int = 4,
    num_steps: int = 24,
    generator: torch.Generator | None = None,
    v0: torch.Tensor | None = None,
    backend: str = "auto",
) -> ProbeResult:
    """SLQ over a PANEL-sharded layout: the Lanczos recurrence of
    :func:`probe_edge_arrays`, each matvec this rank's OWNED rows of
    ``L v`` (``ops.model_local_rows`` at ``alpha = 1, beta = 0``: K2 on
    the card) and one all_reduce that assembles the disjoint row ranges,
    as the panel-sharded tick decomposes its operator.

    ``rows`` is the JAX package's layout (``ModelShardedBlocking``; the
    rank reads the row CSR of its ``shard(s)``) or this rank's own
    owned-row CSR (``graph_store.model_shard_rows``), which then needs
    ``num_nodes``.  Every rank passes the same ``generator`` state or
    ``v0`` (num_nodes, num_probes) and gets the same result."""
    from repro_torch import parallel
    from repro_torch.core import backend as backend_mod
    from repro_torch.core import program
    from repro_torch.kernels.edge_spmm import ops as es_ops

    sidx = parallel.model_shard_index(mesh, model_axes)
    if isinstance(rows, es_ops.ModelShardedBlocking):
        num_nodes = rows.num_nodes
        rows = es_ops.blocking_rows(rows.shard(sidx))
    if num_nodes is None:
        raise ValueError("probe_model_sharded: owned-row CSRs need num_nodes")
    r = rows.row_ptr.shape[0] - 1
    n_pad = parallel.num_model_shards(mesh, model_axes) * r
    start = sidx * r
    group = parallel.edge_group(mesh, model_axes)
    use_kernel = backend_mod.resolve_backend(
        backend, rows.row_ptr.device) == "kernel"

    def matvec(v):
        z = v.new_zeros((n_pad,) + tuple(v.shape[1:]))
        z[start:start + r] = es_ops.model_local_rows(
            rows, v, 1.0, 0.0, start, use_kernel=use_kernel)
        return program._psum(z, group)[:num_nodes]

    return slq_probe(matvec, num_nodes, generator, num_probes=num_probes,
                     num_steps=num_steps, n_real=n_real, v0=v0)


def probe_graph(
    g: EdgeList,
    generator: torch.Generator | None = None,
    num_probes: int = 4,
    num_steps: int = 24,
    backend: str = "auto",
) -> ProbeResult:
    """SLQ-probe an EdgeList's Laplacian spectrum on ``backend`` (see
    :func:`probe_edge_arrays`); ``generator`` defaults to one seeded 0 on
    the graph's device."""
    if generator is None:
        generator = torch.Generator(device=g.device).manual_seed(0)
    num_steps = min(num_steps, g.num_nodes)
    return probe_edge_arrays(
        g.src, g.dst, g.weight, generator, g.num_nodes,
        num_nodes=g.num_nodes, num_probes=num_probes, num_steps=num_steps,
        backend=backend)


def probe_from_eigenvalues(lam, device=None) -> ProbeResult:
    """Exact ProbeResult from a full spectrum: the oracle the planner is
    calibrated against (same planner, perfect probe)."""
    dev = resolve_device(device)
    lam = torch.sort(torch.as_tensor(
        np.asarray(lam, np.float32).ravel(), device=dev)).values
    n = lam.shape[0]
    return ProbeResult(
        ritz=lam[None, :],
        weights=torch.full((1, n), 1.0 / n, dtype=torch.float32, device=dev),
        lambda_max=lam[-1],
        trace=torch.sum(lam),
        n=torch.tensor(float(n), dtype=torch.float32, device=dev),
        num_matvecs=torch.tensor(0, dtype=torch.int32),
    )


def hutchinson_trace(
    matvec,
    n: int,
    generator: torch.Generator,
    *,
    num_probes: int = 16,
    keyed: bool = False,
    n_real: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """Girard-Hutchinson trace estimate with Rademacher probes.

    ``keyed=True`` treats ``matvec`` as a stochastic op(generator, v) (the
    minibatch Laplacian, say) and calls it once per probe, so each probe
    sees its own batch draw and the estimator stays unbiased for
    E_batch[op].  A plain matvec takes all probes as one (n, P) panel.
    """
    z = torch.randint(0, 2, (n, num_probes), generator=generator,
                      device=generator.device).to(torch.float32) * 2.0 - 1.0
    if n_real is not None:
        z = z * _mask(n, n_real, z.device)[:, None]
    if keyed:
        az = torch.stack([matvec(generator, z[:, p].contiguous())
                          for p in range(num_probes)], dim=1)
    else:
        az = matvec(z)
    return torch.mean(torch.sum(z * az, dim=0))


# ---------------------------------------------------------------------------
# Host-side readouts (feed the planner).
# ---------------------------------------------------------------------------

def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _counting_points(probe: ProbeResult) -> tuple[np.ndarray, np.ndarray]:
    """Pooled (sorted ritz nodes, cumulative eigenvalue counts)."""
    theta = _host64(probe.ritz).ravel()
    num_probes = probe.ritz.shape[0]
    count = _host64(probe.weights).ravel() * float(probe.n) / num_probes
    order = np.argsort(theta)
    return theta[order], np.cumsum(count[order])


def eigenvalue_count(probe: ProbeResult, t: float) -> float:
    """Estimated #{lambda_i <= t} from the SLQ measure."""
    theta, cum = _counting_points(probe)
    idx = np.searchsorted(theta, t, side="right")
    return float(cum[idx - 1]) if idx > 0 else 0.0


def _crossing(theta: np.ndarray, cum: np.ndarray, level: float) -> float:
    return float(theta[min(np.searchsorted(cum, level), len(theta) - 1)])


def bottom_edge(probe: ProbeResult, k: int) -> tuple[float, float]:
    """Coarse (lambda_k, lambda_{k+1}) localizer (1-indexed, ascending).

    Scans the estimated counting function for the WIDEST gap between
    pooled Ritz nodes whose below-count is plausibly k (within
    max(1, k/2)); falls back to the plain k-th/(k+1)-th crossings when no
    gap has a plausible count.
    """
    theta, cum = _counting_points(probe)
    tol = max(1.0, 0.5 * k)
    best_width = -1.0
    best = None
    for i in range(len(theta) - 1):
        if abs(cum[i] - k) <= tol:
            width = theta[i + 1] - theta[i]
            if width > best_width:
                best_width = width
                best = (theta[i], theta[i + 1])
    if best is None:
        best = (_crossing(theta, cum, k - 0.5), _crossing(theta, cum, k + 0.5))
    lam_k, lam_k1 = best
    lam_k = max(float(lam_k), 0.0)
    return lam_k, max(float(lam_k1), lam_k)


def spectral_density(
    probe: ProbeResult,
    num_bins: int = 32,
    lo: float = 0.0,
    hi: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Coarse spectral-density histogram: (bin_edges (B+1,), mass (B,));
    ``mass`` sums to ~n (Ritz nodes outside [lo, hi] are clipped into the
    boundary bins)."""
    if hi is None:
        hi = float(probe.lambda_max)
    hi = max(hi, lo + 1e-12)
    theta = _host64(probe.ritz).ravel()
    num_probes = probe.ritz.shape[0]
    count = _host64(probe.weights).ravel() * float(probe.n) / num_probes
    edges = np.linspace(lo, hi, num_bins + 1)
    mass, _ = np.histogram(np.clip(theta, lo, hi), bins=edges, weights=count)
    return edges, mass
