"""Plain PyTorch versions of the fused mu-EG update (mirrors
``solvers.mu_eg_step``) and the k x k coefficient algebra."""
import torch


def mu_eg_update(v: torch.Tensor, av: torch.Tensor, lr: float) -> torch.Tensor:
    k = v.shape[1]
    vav = v.T @ av
    lower = torch.tril(torch.ones((k, k), dtype=v.dtype, device=v.device), -1)
    penalties = v @ (lower * vav).T
    grad = av - penalties
    grad = grad - v * torch.sum(v * grad, dim=0, keepdim=True)
    vn = v + lr * grad
    return vn / torch.clamp(torch.linalg.vector_norm(vn, dim=0, keepdim=True),
                            min=1e-30)


def gram2k(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: the (2k, 2k) gram of [V | AV]."""
    x = torch.cat([v, av], dim=1)
    return x.T @ x


def panel_mix(v: torch.Tensor, av: torch.Tensor, m1: torch.Tensor,
              m2: torch.Tensor, colscale: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4: (V @ M1 + AV @ M2) * colscale."""
    return (v @ m1 + av @ m2) * colscale[None, :]


def coefficient_matrices(s2: torch.Tensor, k: int, lr: float):
    """(M1, M2, colscale) from the 2k x 2k gram of [V | AV] such that
    mu_eg_update(V, AV) == (V @ M1 + AV @ M2) * colscale.

    penalties = V C0 with C0 = (tril(vav, -1))^T; the Riemannian
    coefficient d = diag(vav) - diag(vv C0); V + lr grad = V M1 + AV M2
    with M1 = I - lr (C0 + diag(d)), M2 = lr I; the column norms^2 are
    diag([M1; M2]^T S2 [M1; M2]).
    """
    vv = s2[:k, :k]
    vav = s2[:k, k:]
    avav = s2[k:, k:]
    eye = torch.eye(k, dtype=s2.dtype, device=s2.device)
    lower = torch.tril(torch.ones((k, k), dtype=s2.dtype, device=s2.device), -1)
    c0 = (lower * vav).T
    d = torch.diagonal(vav) - torch.diagonal(vv @ c0)
    m1 = eye - lr * (c0 + torch.diag(d))
    m2 = lr * eye
    norm2 = (
        torch.diagonal(m1.T @ vv @ m1)
        + torch.diagonal(m1.T @ vav @ m2)
        + torch.diagonal(m2.T @ vav.T @ m1)
        + torch.diagonal(m2.T @ avav @ m2)
    )
    colscale = torch.rsqrt(torch.clamp(norm2, min=1e-60))
    return m1, m2, colscale
