"""Baselines from the paper's related-work section (App. B), so SPED is
compared with more than the identity transform:

* **Bethe Hessian** (Saade et al. 2014): H(r) = (r^2 - 1) I - r A + D,
  r = sqrt(average branching ratio).  The eigenvectors of H's negative
  eigenvalues carry the communities of an SBM graph down to the
  detectability threshold.
* **Shift-and-invert power iteration** (Garber et al. 2016): the bottom
  eigenvectors of L as the top ones of (L + shift I)^{-1}, applied by
  conjugate-gradient solves (matrix-free like SPED, but each operator
  application costs a CG solve instead of a fixed polynomial).
* **Lanczos** (reference eigensolver): the host-precision oracle for
  graphs too large for dense eigh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kmeans import kmeans
from repro_torch.core.laplacian import EdgeList, adjacency_dense, degrees
from repro_torch.device import resolve_device


def bethe_hessian_dense(g: EdgeList, r: float | None = None):
    """(H(r), r) with H(r) = (r^2 - 1) I - r A + D.  Default r =
    sqrt(sum d_i^2 / sum d_i - 1), the paper's average branching ratio."""
    a = adjacency_dense(g)
    d = degrees(g)
    if r is None:
        r = float(torch.sqrt(torch.sum(d * d)
                             / torch.clamp(torch.sum(d), min=1e-9) - 1.0))
    eye = torch.eye(g.num_nodes, device=g.device)
    return (r * r - 1.0) * eye - r * a + torch.diag(d), r


def bethe_hessian_cluster(g: EdgeList, num_clusters: int, seed: int = 0):
    """Spectral clustering with the Bethe Hessian's bottom eigenvectors;
    the k-means draws come from a ``torch.Generator`` seeded with
    ``seed`` on the graph's device."""
    h, r = bethe_hessian_dense(g)
    lam, vecs = torch.linalg.eigh(h)
    emb = vecs[:, :num_clusters]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                            min=1e-12)
    gen = torch.Generator(device=g.device).manual_seed(seed)
    res = kmeans(gen, emb, num_clusters)
    return res.labels, {"r": r, "negative_eigs": int(torch.sum(lam < 0))}


def cg_solve(matvec, b: torch.Tensor, x0: torch.Tensor | None = None,
             iters: int = 50, tol: float = 1e-6) -> torch.Tensor:
    """Conjugate gradient for an SPD matvec on an (n, k) right-hand side.
    Exactly ``iters`` iterations, no early exit (``tol`` is kept for the
    JAX package's signature and unused there too), so iteration counts
    match across packages and devices."""
    del tol
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = torch.sum(r * r, dim=0)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.clamp(torch.sum(p * ap, dim=0), min=1e-30)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rs_new = torch.sum(r * r, dim=0)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta[None, :] * p
        rs = rs_new
    return x


def shift_invert_operator(matvec, shift: float, cg_iters: int = 50):
    """V -> (L + shift I)^{-1} V by CG: a solver-compatible operator whose
    top-k is the bottom-k of L."""

    def shifted(v):
        return matvec(v) + shift * v

    def op(v):
        return cg_solve(shifted, v, iters=cg_iters)

    return op


def lanczos_bottom_k(matvec, n: int, k: int, iters: int = 0, seed: int = 0,
                     device=None):
    """Bottom-k eigenpairs of a symmetric operator by Lanczos with full
    reorthogonalization, on the host in float64 numpy (the reference, not
    the scalable path).  ``matvec`` runs on ``device`` (None = the CUDA
    card): each step copies one (n,) float32 vector there and one back.
    The start vector is numpy's ``default_rng(seed)``, as in the JAX
    package.  Returns (lam (k,), vecs (n, k)) float32 on ``device``."""
    dev = resolve_device(device)
    iters = iters or min(n, max(4 * k, 64))
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n,))
    q /= np.linalg.norm(q)
    qs = [q]
    alphas, betas = [], []
    for j in range(iters):
        qv = torch.from_numpy(qs[-1].astype(np.float32)).to(dev)
        w = matvec(qv).cpu().numpy().astype(np.float64)
        alpha = float(w @ qs[-1])
        w = w - alpha * qs[-1] - (betas[-1] * qs[-2] if betas else 0.0)
        for qq in qs:  # full reorthogonalization (stability)
            w = w - (w @ qq) * qq
        beta = float(np.linalg.norm(w))
        alphas.append(alpha)
        if beta < 1e-12 or j == iters - 1:
            break
        betas.append(beta)
        qs.append(w / beta)
    t = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    lam, s = np.linalg.eigh(t)
    vecs = np.stack(qs, axis=1) @ s[:, :k]
    vecs /= np.linalg.norm(vecs, axis=0, keepdims=True)
    return (torch.from_numpy(lam[:k].astype(np.float32)).to(dev),
            torch.from_numpy(vecs.astype(np.float32)).to(dev))
