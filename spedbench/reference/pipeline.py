"""Plain PyTorch reference of one clustering job (paper Secs. 1-3, 5):
Laplacian -> dilated series ``(I - c L)^degree`` (Table 2's limit form)
-> mu-EigenGame steps (:func:`solve`), then row-normalised embedding ->
k-means (:func:`labels`).

It imports nothing of the program.  It builds its own Laplacian from the
benchmark's raw edge list, draws the job's initial panel and minibatches
from the job's seed in the order the pipeline defines (the initial
panel, then each step's (degree + 1, B) edge draw) and the k-means seeds
from seed + 1, and computes in float32 with TF32 off.  ``tf32=True``
computes every matrix product on TF32 inputs (10 mantissa bits, as the
tensor cores round them): the benchmark's control, one precision below
the configuration's float32.  k-means takes its distances a block of
rows at a time, in the sums the whole (n, k, d) broadcast would take,
so its memory does not grow with n k d.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

KMEANS_ITERS = 25
# the most bytes that k-means' distances hold at a time, whatever n, k
# and d: one row block's (rows, m, d) differences and their squares
BLOCK_BYTES = 1 << 30


@dataclasses.dataclass
class Solve:
    v0: torch.Tensor  # (n, k) the initial orthonormal panel
    v: torch.Tensor  # (n, k) the panel after the job's steps


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest even."""
    xi = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((xi >> 13) & 1)
    return ((xi + bias) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return tf32_round(a) @ tf32_round(b) if tf32 else a @ b


def degrees(edges: torch.Tensor, n: int) -> torch.Tensor:
    """Weighted degrees of unit-weight edges (parallel edges count)."""
    flat = edges.reshape(-1).long()
    return torch.bincount(flat, minlength=n).float()


def laplacian_csr(edges: torch.Tensor, n: int) -> torch.Tensor:
    """L = D - A as a sparse CSR matrix, duplicates summed."""
    s, d = edges[:, 0].long(), edges[:, 1].long()
    diag = torch.arange(n, device=edges.device)
    w = torch.ones(s.shape[0], dtype=torch.float32, device=edges.device)
    idx = torch.stack([torch.cat([s, d, diag]), torch.cat([d, s, diag])])
    vals = torch.cat([-w, -w, degrees(edges, n)])
    del s, d, w
    coo = torch.sparse_coo_tensor(idx, vals, (n, n),
                                  check_invariants=False).coalesce()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return coo.to_sparse_csr()


def series_c(deg: torch.Tensor, clustering: dict) -> float:
    """The limit series' step c = scale / degree, scale = strength / rho
    with rho = 2 max degree, Gershgorin's bound on L (Sec. 5.4)."""
    rho = 2.0 * float(deg.max())
    scale = (clustering["dilation_strength"] / max(rho, 1e-30)
             if clustering["auto_scale"] else 1.0)
    return scale / clustering["degree"]


def mu_eg_step(v: torch.Tensor, av: torch.Tensor, lr: float,
               tf32: bool) -> torch.Tensor:
    """mu-EigenGame (unloaded) step in its panel form:
    V + lr grad = V (I - lr (C0 + diag d)) + lr AV, with C0 the transposed
    strict lower triangle of V^T A V and d_i = <v_i, grad_i> before the
    Riemannian projection; then every column normalised."""
    k = v.shape[1]
    x = torch.cat([v, av], dim=1)
    s = matmul(x.T, x, tf32)
    vv, vav = s[:k, :k], s[:k, k:]
    c0 = torch.tril(vav, -1).T
    d = torch.diagonal(vav) - torch.diagonal(vv @ c0)
    eye = torch.eye(k, dtype=v.dtype, device=v.device)
    m1 = eye - lr * (c0 + torch.diag(d))
    vn = matmul(v, m1, tf32) + matmul(av, lr * eye, tf32)
    return vn / torch.clamp(torch.linalg.vector_norm(vn, dim=0, keepdim=True),
                            min=1e-30)


def kmeans(generator: torch.Generator, x: torch.Tensor, k: int,
           restarts: int, tf32: bool) -> torch.Tensor:
    """Best of ``restarts`` Lloyd runs from k-means++ seeds (first centre
    uniform, then D^2-weighted), ``KMEANS_ITERS`` iterations each; the
    labels of the run with the least inertia."""
    best_labels, best_inertia = None, None
    for _ in range(restarts):
        _, labels, inertia = lloyd(x, plusplus(generator, x, k), tf32)
        if best_inertia is None or bool(inertia < best_inertia):
            best_labels, best_inertia = labels, inertia
    return best_labels


def plusplus(generator: torch.Generator, x: torch.Tensor,
             k: int) -> torch.Tensor:
    """k-means++ seeds (k, d): the first centre uniform, each next one drawn
    with probability d2 / sum(d2), d2 each row's least squared distance to
    the centres drawn so far.  d2 is kept as a running minimum that takes
    the one new centre's distances a draw: a minimum is exact, so it is
    the minimum over every centre drawn, bit for bit."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    c = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    c[0] = x[first[0]]
    d2 = None
    for i in range(1, k):
        new = nearest(x, c[i - 1:i])[0]
        d2 = new if d2 is None else torch.minimum(d2, new)
        total = torch.sum(d2)
        probs = torch.where(total > 0, d2 / torch.clamp(total, min=1e-30),
                            torch.full_like(d2, 1.0 / n))
        c[i] = x[torch.multinomial(probs, 1, generator=generator)[0]]
    return c


def lloyd(x: torch.Tensor, c: torch.Tensor, tf32: bool):
    """``KMEANS_ITERS`` Lloyd passes from the centres ``c``: the last
    centres, each row's label under them, and the inertia."""
    k = c.shape[0]
    for _ in range(KMEANS_ITERS):
        labels = nearest(x, c)[1]
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = matmul(onehot.T, x, tf32)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1)[:, None], c)
    d2, labels = nearest(x, c)
    return c, labels, torch.sum(d2)


def nearest(x: torch.Tensor, c: torch.Tensor):
    """Each row's least squared distance to the centres ``c`` (n,) and the
    lowest index that takes it (n,), a block of rows at a time."""
    n = x.shape[0]
    d2 = torch.empty(n, dtype=x.dtype, device=x.device)
    labels = torch.empty(n, dtype=torch.long, device=x.device)
    for rows in row_blocks(n, c.shape[0] * x.shape[1] * x.element_size()):
        block = _sq_dists(x[rows], c)
        d2[rows] = torch.min(block, dim=1).values
        labels[rows] = torch.argmin(block, dim=1)
    return d2, labels


def row_blocks(n: int, row_bytes: int) -> list[slice]:
    """Slices that cover n rows in blocks of at most ``BLOCK_BYTES`` of
    temporaries, a row taking ``2 * row_bytes`` (its (m, d) differences
    and their squares).  The blocks differ by one row at most: none is
    left small, since on the card torch sums a reduction of fewer than
    16 outputs with wider lanes, in another order."""
    rows = max(1, BLOCK_BYTES // (2 * row_bytes))
    count = max(1, -(-n // rows))
    return [slice(n * i // count, n * (i + 1) // count) for i in range(count)]


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(rows, m) squared distances, each summed over the last axis of the
    (rows, m, d) squares.  From 16 outputs on, the order torch sums in
    does not depend on their number, so a block gives the whole
    broadcast's bits."""
    return torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)


def exact_operator(edges: torch.Tensor, n: int, c: float, degree: int):
    """V -> (I - c L)^degree V, each factor one sparse product."""
    lap = laplacian_csr(edges, n)

    def op(gen: torch.Generator, v: torch.Tensor) -> torch.Tensor:
        u = v
        for _ in range(degree):
            u = torch.addmm(u, lap, u, beta=1.0, alpha=-c)
        return u
    return op


def minibatch_operator(edges: torch.Tensor, c: float, degree: int,
                       batch: int):
    """V -> prod over i of (I - c L_i) V, L_i the Laplacian of the i-th
    row of a (degree + 1, B) uniform draw of edges with replacement,
    scaled by E / B (each factor unbiased for L, paper Sec. 3)."""
    e = edges.shape[0]
    scale = e / batch
    src, dst = edges[:, 0].long(), edges[:, 1].long()

    def op(gen: torch.Generator, v: torch.Tensor) -> torch.Tensor:
        sel = torch.randint(0, e, (degree + 1, batch), generator=gen,
                            device=v.device)
        u = v
        for i in range(degree):
            s, d = src[sel[i]], dst[sel[i]]
            diff = (u[s] - u[d]) * scale
            lu = torch.zeros_like(u)
            lu.index_add_(0, s, diff)
            lu.index_add_(0, d, -diff)
            u = torch.add(u, lu, alpha=-c)
        return u
    return op


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def solve(edges: torch.Tensor, n: int, clustering: dict, solver: dict,
          num_clusters: int, seed: int, tf32: bool = False) -> Solve:
    """The panel of one job of the cell's mix on ``edges`` (E, 2), seeded
    by ``seed``: the initial panel and the panel after the job's steps."""
    if clustering["transform"] != "limit_neg_exp":
        raise ValueError(f"no reference for transform {clustering['transform']!r}")
    _no_tf32()
    dev = edges.device
    k = (num_clusters + clustering["extra_eigvecs"]
         + (1 if clustering["drop_trivial"] else 0))
    degree = clustering["degree"]
    c = series_c(degrees(edges, n), clustering)
    if clustering["estimation"] == "exact_edges":
        op = exact_operator(edges, n, c, degree)
    elif clustering["estimation"] == "minibatch":
        op = minibatch_operator(edges, c, degree, clustering["batch_edges"])
    else:
        raise ValueError(f"no reference for estimation "
                         f"{clustering['estimation']!r}")

    gen = torch.Generator(device=dev).manual_seed(seed)
    v0 = torch.randn((n, k), generator=gen, dtype=torch.float32, device=dev)
    v0 = torch.linalg.qr(v0)[0].contiguous()
    v = v0
    evals = max(1, solver["steps"] // solver["eval_every"])
    for _ in range(evals * solver["eval_every"]):
        v = mu_eg_step(v, op(gen, v), solver["lr"], tf32)
    return Solve(v0=v0, v=v)


def labels(v: torch.Tensor, clustering: dict, num_clusters: int, seed: int,
           tf32: bool = False) -> torch.Tensor:
    """k-means labels of the row-normalised embedding of panel ``v`` (the
    columns after the trivial one), seeded by ``seed`` + 1."""
    _no_tf32()
    start = 1 if clustering["drop_trivial"] else 0
    emb = v[:, start:start + num_clusters]
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                            min=1e-12)
    gen = torch.Generator(device=v.device).manual_seed(seed + 1)
    return kmeans(gen, emb, num_clusters, clustering["kmeans_restarts"], tf32)
