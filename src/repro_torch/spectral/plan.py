"""Dilation planner: probed spectrum -> tuned transform configuration.

``plan_dilation`` makes a closed-form decision on top of a
:class:`repro_torch.spectral.probes.ProbeResult`:

* ``rho``: the SLQ ``lambda_max`` estimate, capped by the Gershgorin bound
  ``2 * max_degree`` when provided (``rho_fallback``, which also carries
  the plan alone when probing is off or returns garbage).
* relative bottom gap ``gamma = (lambda_{k+1} - lambda_k) / rho`` from the
  counting-function localizer.
* strength ``tau`` (the transform acts like ``-exp(-tau * lam / rho)``),
  chosen so the transformed gap ratio reaches ``exp(TARGET_LOG_GAP)`` and
  snapped UP onto ``TAU_GRID``, so probe noise maps to the same plan.
* degree: smallest odd value with ``degree >= DEGREE_PER_TAU * tau``.
* family: ``identity`` when the raw gap is already wide, ``limit_neg_exp``
  when the degree fits the budget, ``cheb_neg_exp`` when it does not.

Host-side numpy, a copy of the JAX package's planner: from the same probe
values the plan comes out equal field for field.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import laplacian as lap
from repro_torch.core import series as series_mod
from repro_torch.spectral import probes as probes_mod

# Snapped dilation strengths.  8.0 is the repo's long-standing default;
# the grid brackets it both ways.
TAU_GRID = (2.0, 4.0, 8.0, 16.0, 24.0, 32.0)
# Aim for a transformed gap ratio of e^3 ~ 20 between the wanted and the
# first unwanted eigenvalue of the reversed operator.
TARGET_LOG_GAP = 3.0
# ...but never decay the WANTED spread below ~exp(-1.5): tau * lambda_k
# / rho <= MAX_WANTED_DECAY.  The trailing panel direction's relative
# convergence signal goes like exp(-tau * lambda_k / rho) (lambda_1 = 0
# on a Laplacian, so lambda_k IS the wanted spread); past ~1.5 the
# over-dilation pathology sets in — a huge tau separates lambda_k from
# lambda_{k+1} beautifully while starving the solver of signal for the
# wanted directions themselves.
MAX_WANTED_DECAY = 1.5
# Raw relative gap above which no transform is needed at all.
GAMMA_IDENTITY = 0.3
# degree >= DEGREE_PER_TAU * tau keeps |1 - tau*lam/(rho*degree)| <= 1
# on lam in [0, rho] with 25% margin for rho underestimation.
DEGREE_PER_TAU = 1.25
MIN_DEGREE = 7
# Chebyshev reaches the same -exp(-tau x) accuracy at roughly half the
# limit-series degree (coefficients decay like Bessel I_j(tau/2)).
CHEB_DEGREE_PER_TAU = 0.6
CHEB_DEGREE_PAD = 6
# Chebyshev fit interval stretches past rho so a slightly low estimate
# cannot put true eigenvalues outside the interpolation range (where a
# Chebyshev polynomial explodes and can fold the spectrum).
CHEB_RHO_MARGIN = 1.05


@dataclasses.dataclass(frozen=True)
class DilationPlan:
    """A fully determined dilation: feed to ``series_from_plan``.

    ``family``/``degree`` are static (compile-relevant); ``tau``/``rho``
    are the per-graph scale the series closes over.  ``source`` records
    how rho was obtained ("slq", "oracle", "fallback").
    """

    family: str  # "identity" | "limit_neg_exp" | "cheb_neg_exp"
    degree: int
    tau: float  # dimensionless strength: map ~ -exp(-tau * lam / rho)
    rho: float  # spectral-radius estimate the scale is anchored to
    lambda_star: float  # Eq. (8) reversal shift
    gamma: float  # probed relative bottom gap (lam_{k+1}-lam_k)/rho
    lam_k: float
    lam_k1: float
    probe_matvecs: int  # single-vector matvecs spent probing
    source: str = "slq"

    @property
    def predicted_gap_ratio(self) -> float:
        """Transformed (lam'_k / lam'_{k+1}) ratio the plan aims for."""
        return float(math.exp(min(self.tau * self.gamma, 60.0)))

    @property
    def scale(self) -> float:
        """`scale` argument for the limit series: maps lam -> tau*lam/rho."""
        return self.tau / max(self.rho, 1e-30)

    @property
    def operator_scale(self) -> float:
        """Magnitude of the reversed operator's top eigenvalue.

        ~1 for the exp-family series (values in (0, 1]); lambda_star for
        the reversed identity (values up to ~rho).  Solver step sizes
        tuned for a unit-scale operator should be divided by this — see
        ``suggested_lr``.
        """
        if self.family == "identity":
            return max(self.lambda_star, 1e-30)
        return 1.0

    def suggested_lr(self, base_lr: float = 0.4) -> float:
        """Step size normalized to the planned operator's scale (mu-EG /
        Oja steps are not scale-invariant: an identity plan on a graph
        with rho ~ 40 needs a ~40x smaller lr than a unit-scale series)."""
        return base_lr / self.operator_scale


def _next_odd(x: float) -> int:
    d = int(math.ceil(x))
    return d if d % 2 == 1 else d + 1


def identity_lambda_star(rho: float) -> float:
    """Eq. (8) reversal shift for the identity family: just above the
    spectral-radius estimate.  THE single definition — the streaming
    service's ordinary-batch rho rescale moves a session's shift with
    this same rule, so the update path and a fresh re-plan agree."""
    return rho * 1.01 + 1e-6


def wanted_decay_cap(lam_k: float, rho: float) -> float:
    """Largest tau keeping tau * lambda_k / rho <= MAX_WANTED_DECAY.

    The single definition of the over-dilation guard, shared by
    ``plan_dilation`` and the streaming service's per-session re-plan.
    """
    lam_k = min(max(lam_k, 0.0), rho)
    return MAX_WANTED_DECAY / max(lam_k / max(rho, 1e-30), 1e-3)


FAMILIES = ("identity", "limit_neg_exp", "cheb_neg_exp")


def plan_dilation(
    probe: probes_mod.ProbeResult | None,
    k: int,
    budget: int = 96,
    rho_fallback: float | None = None,
    source: str = "slq",
    lam_k: float | None = None,
    lam_k1: float | None = None,
    rho: float | None = None,
    tau_cap: float | None = None,
    families: tuple = FAMILIES,
) -> DilationPlan:
    """Select (family, degree, tau, rho, lambda_star) from a probe.

    ``budget`` caps the matvecs one operator application may spend (the
    series degree).  ``rho_fallback`` is the Gershgorin-style bound: it
    caps the probed radius (the bound is certain, the probe is not) and
    carries the plan alone when ``probe`` is None or non-finite —
    callers inside jit-sensitive paths keep working with probing off.
    Explicit ``lam_k``/``lam_k1``/``rho`` override the probe's
    bottom-edge localizer and ``lambda_max`` for callers that carry
    their own estimates (the streaming service re-plans from cached
    probe anchors without re-probing).  ``tau_cap`` bounds the strength
    like the wanted-decay cap (a configured ``dilation_strength``
    ceiling); ``families`` restricts the transform families a caller's
    compiled program set can execute — the streaming tick programs only
    evaluate the ``(I - c L)^degree`` form, so they exclude
    ``cheb_neg_exp`` and the planner weakens tau into the budget
    instead.

    Monotone by construction: for fixed lambda_k and rho, a larger
    probed bottom gap never yields a larger degree (wider gaps need
    less dilation; tau_needed falls with gamma while the wanted-decay
    cap stays put).
    """
    if budget < 1:
        raise ValueError(f"budget {budget} < 1 matvec")
    probe_matvecs = 0
    if probe is not None:
        probe_matvecs = int(probe.num_matvecs)
    if rho is not None:
        rho = float(rho)
    elif probe is not None:
        rho = float(probe.lambda_max)
    else:
        rho = float("nan")
    if rho_fallback is not None:
        rho = min(rho, float(rho_fallback)) if math.isfinite(rho) \
            else float(rho_fallback)
    if not math.isfinite(rho) or rho <= 0.0:
        # degenerate graph (no edges) or no spectral information at all:
        # identity transform, unit shift — nothing to dilate.
        return DilationPlan(
            family="identity", degree=1, tau=0.0, rho=max(rho, 0.0),
            lambda_star=1.0, gamma=1.0, lam_k=0.0, lam_k1=0.0,
            probe_matvecs=probe_matvecs, source="fallback")
    if lam_k is None or lam_k1 is None:
        if probe is not None:
            lam_k, lam_k1 = probes_mod.bottom_edge(probe, k)
        else:
            lam_k = lam_k1 = 0.0  # unknown gap: assume the hard case
            source = "fallback"
    lam_k = min(max(float(lam_k), 0.0), rho)
    lam_k1 = min(max(float(lam_k1), lam_k), rho)
    gamma = (lam_k1 - lam_k) / rho

    if gamma >= GAMMA_IDENTITY and "identity" in families:
        # Raw spectrum is already well separated at k; the reversed
        # identity (lambda* just above rho, Eq. 8) converges fine and
        # costs ONE matvec per application.
        return DilationPlan(
            family="identity", degree=1, tau=0.0, rho=rho,
            lambda_star=identity_lambda_star(rho), gamma=gamma,
            lam_k=lam_k, lam_k1=lam_k1,
            probe_matvecs=probe_matvecs, source=source)

    tau_needed = TARGET_LOG_GAP / max(gamma, 1e-3)
    tau = next((t for t in TAU_GRID if t >= tau_needed), TAU_GRID[-1])
    # Cap: keep the wanted eigenvalues alive (see MAX_WANTED_DECAY),
    # intersected with any caller-configured strength ceiling.
    # Snapped DOWN so the cap wins conflicts; lam_k <= rho guarantees
    # the wanted-decay cap is >= MAX_WANTED_DECAY, which the grid floor
    # covers.
    cap = wanted_decay_cap(lam_k, rho)
    if tau_cap is not None:
        cap = min(cap, float(tau_cap))
    if tau > cap:
        below = [t for t in TAU_GRID if t <= cap]
        tau = below[-1] if below else TAU_GRID[0]
    degree = max(_next_odd(DEGREE_PER_TAU * tau), MIN_DEGREE)
    family = "limit_neg_exp"
    if degree > budget:
        # The safe limit-series degree does not fit: first try the
        # Chebyshev fit of the same map (lower degree, same accuracy)...
        cheb_degree = _next_odd(CHEB_DEGREE_PER_TAU * tau + CHEB_DEGREE_PAD)
        if cheb_degree <= budget and "cheb_neg_exp" in families:
            return DilationPlan(
                family="cheb_neg_exp", degree=cheb_degree, tau=tau, rho=rho,
                lambda_star=0.0, gamma=gamma, lam_k=lam_k, lam_k1=lam_k1,
                probe_matvecs=probe_matvecs, source=source)
        # ...then weaken tau to the strongest grid value the budget can
        # evaluate safely (still monotone: smaller gap never gets MORE
        # degree than the budget).
        affordable = [t for t in TAU_GRID
                      if max(_next_odd(DEGREE_PER_TAU * t), MIN_DEGREE)
                      <= budget]
        if affordable:
            tau = affordable[-1]
            degree = max(_next_odd(DEGREE_PER_TAU * tau), MIN_DEGREE)
        else:
            # budget below even MIN_DEGREE: largest odd degree that fits,
            # strength scaled to what that degree evaluates safely
            degree = max(budget if budget % 2 == 1 else budget - 1, 1)
            tau = degree / DEGREE_PER_TAU
    return DilationPlan(
        family=family, degree=degree, tau=tau, rho=rho,
        lambda_star=0.0, gamma=gamma, lam_k=lam_k, lam_k1=lam_k1,
        probe_matvecs=probe_matvecs, source=source)


def series_from_plan(plan: DilationPlan) -> series_mod.SpectralSeries:
    """Materialize the plan as a SpectralSeries (core.series constructors)."""
    if plan.family == "identity":
        return series_mod.with_lambda_star(
            series_mod.identity_series(), plan.lambda_star)
    if plan.family == "limit_neg_exp":
        return series_mod.limit_neg_exp(plan.degree, scale=plan.scale)
    if plan.family == "cheb_neg_exp":
        return series_mod.cheb_neg_exp(
            plan.degree, rho=plan.rho * CHEB_RHO_MARGIN,
            tau=plan.tau / max(plan.rho, 1e-30))
    raise ValueError(f"unknown plan family {plan.family!r}")


def probe_and_plan(
    g,
    k: int,
    generator=None,
    budget: int = 96,
    num_probes: int = 4,
    num_steps: int = 24,
    backend: str = "auto",
) -> tuple[probes_mod.ProbeResult, DilationPlan]:
    """One-call convenience: SLQ-probe an EdgeList, then plan.

    The Gershgorin bound rides along as the cap/fallback, so the result
    is never worse-anchored than a fixed-scale call.  ``backend`` selects
    the probe matvec kernels (repro_torch.core.backend), so probing runs
    on the same backend as the solve it tunes.
    """
    probe = probes_mod.probe_graph(
        g, generator=generator, num_probes=num_probes, num_steps=num_steps,
        backend=backend)
    plan = plan_dilation(
        probe, k=k, budget=budget,
        rho_fallback=float(lap.spectral_radius_upper_bound(g)))
    return probe, plan
