"""Solve programs: the single-panel loops and the batched group tick.

:func:`apply_solver_step` is THE one place a mu-EG/Oja solver step is
built.  On it stand:

* the single-panel loops :func:`run_chunk` and :func:`run_program` (the
  engine of ``solvers.run_solver``), plain Python loops whose trace
  metrics stay on the device, so the loop never waits on the card;
* the batched tick of a streaming session group (:class:`TickProgram`,
  built by :func:`build_tick_program`): ``chunks x steps`` dilated
  solver steps for every member, then one residual evaluation.  The
  group's dilated operator runs on ONE block-diagonal row CSR
  (:func:`group_edge_rows`, filled from the members' own row CSRs by
  copies): member i's nodes sit at rows ``[i * node_cap, (i + 1) *
  node_cap)`` and its weights are pre-scaled by its dilation scale c_i,
  which is exact since ``c L(w) = L(c w)``.
  Each factor ``u - c_i L_i u`` of every member is then one K1/K2 launch
  for the whole group at ``alpha = -1, beta = 1``, and the solver step
  runs K3/K4 per member over row-slice views of the stacked panel.  On
  the card the tick is replayed from CUDA graphs captured at its first
  call: the per-session c lives in the layout's weights, which the
  program owns and refills in place, and the per-session lr in a device
  tensor, so a re-plan refills buffers and captures nothing new;
* the edge-sharded group tick (``build_tick_program(mesh=...)``,
  :func:`build_tick_sharded_segment`, :func:`build_tick_sharded_pallas`):
  the same program over each rank's SHARD of the members' edges, one
  all_reduce of the stacked panel per dilation factor, eager (see
  :mod:`repro_torch.parallel` for the one-rank-one-shard design), and
  the collective accounting :func:`count_psums` over :func:`_psum`;
* the panel-sharded group tick (``build_tick_program(mesh=...,
  model_axes=...)``, :class:`ModelShardedTickProgram`): each rank owns a
  row range of the panels, one rectangular K2 launch per factor on its
  owned rows, and per mu-EG step one fused rows + gram all_reduce;
* the schedule helpers (:class:`StepSchedule`, :func:`session_lr`,
  :func:`dilation_scale`, :func:`schedule_degrees`) and the
  residual-decay forecasts (:func:`contraction_rate`,
  :func:`predicted_residual`, :func:`predicted_steps_to_tol`), host-side
  copies of the JAX package's, equal float for float.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import parallel, spans
from repro_torch.core import backend as backend_mod
from repro_torch.core import metrics, operators, solvers
from repro_torch.device import resolve_device
from repro_torch.kernels import add_launch_counts
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.kernels.edge_spmm import ref as es_ref

MatVec = Callable[[torch.Tensor], torch.Tensor]

num_model_shards = parallel.num_model_shards


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepSchedule:
    """Hyperparameters of one solve-program invocation.

    ``method`` / ``degree`` / ``steps`` / ``backend`` are the static
    part (:attr:`statics`): a tick program is built per value, so
    adaptive layers move them only on snapped grids (see
    :func:`schedule_degrees`).  ``lr`` is advisory metadata for
    SINGLE-PANEL callers (a plan-derived step size for
    ``run_chunk``/``SolverConfig``); tick programs never read it, their
    learning rates arrive as the per-session ``lrs`` input.
    """

    method: str = "mu_eg"  # "mu_eg" | "oja"
    degree: int = 15  # dilation degree of the (I - c L)^degree operator
    steps: int = 20  # solver steps per program invocation
    lr: float = 0.3  # advisory: single-panel callers; ticks take lrs
    backend: str = "auto"  # repro_torch.core.backend

    @property
    def statics(self) -> tuple:
        """The program-key contribution of this schedule."""
        return (self.method, self.degree, self.steps, self.backend)

    @classmethod
    def from_plan(cls, plan, *, steps: int, base_lr: float,
                  method: str = "mu_eg", backend: str = "auto",
                  max_degree: int | None = None,
                  normalized: bool = True) -> "StepSchedule":
        """Derive (lr, degree) from a :class:`DilationPlan`.

        ``normalized=True`` is the tick-program form ``(I - c L)^degree``
        whose TOP eigenvalue is 1 by construction (an identity plan runs
        as degree 1 with ``c = 1/lambda_star``), so the lr is normalized
        to the plan's WANTED-direction scale (:func:`session_lr`).
        ``normalized=False`` keeps ``plan.suggested_lr`` verbatim for
        callers driving the raw reversed operator ``lambda* I - S(L)``.
        """
        degree = 1 if plan.family == "identity" else int(plan.degree)
        if max_degree is not None:
            cap = max_degree if max_degree % 2 == 1 else max_degree - 1
            degree = min(degree, max(cap, 1))
        if normalized:
            lr = session_lr(plan, base_lr)
        else:
            lr = plan.suggested_lr(base_lr)
        return cls(method=method, degree=degree, steps=steps, lr=lr,
                   backend=backend)


def wanted_scale(plan) -> float:
    """Transformed operator value of the slowest WANTED direction: the
    factor by which a step size tuned for a unit-scale direction
    under-steps it, the denominator of :func:`session_lr`."""
    if plan.family == "identity":
        lam_star = max(plan.lambda_star, 1e-30)
        return max(1.0 - plan.lam_k / lam_star, 1e-3)
    if plan.rho <= 0.0 or not math.isfinite(plan.rho):
        return 1.0
    return math.exp(-plan.tau * min(plan.lam_k, plan.rho) / plan.rho)


# The top direction still sees operator value 1, so the wanted-scale lr
# boost must stay inside the solver's stable step range.
LR_BOOST_CAP = 2.0


def session_lr(plan, base_lr: float, boost_cap: float = LR_BOOST_CAP
               ) -> float:
    """Plan-driven per-session step size for the unit-normalized tick
    form: the base lr boosted by the inverse wanted-direction scale,
    capped at ``boost_cap``."""
    return base_lr * min(1.0 / max(wanted_scale(plan), 1e-3), boost_cap)


def dilation_scale(plan, degree: int) -> float:
    """Per-matvec scale ``c`` of the ``(I - c L)^degree`` form: the series
    step ``tau / (rho * degree)`` of an exp-family plan; an identity plan
    maps onto degree 1 with ``c = 1 / lambda_star``."""
    if plan.family == "identity":
        return 1.0 / max(plan.lambda_star, 1e-30)
    return plan.scale / max(degree, 1)


def schedule_degrees(max_degree: int) -> tuple[int, ...]:
    """Every degree a plan-derived schedule may take under ``max_degree``:
    the planner's snapped tau grid, the identity's degree 1 and the
    budget's largest odd degree."""
    from repro_torch.spectral import plan as plan_mod

    degs = {1, plan_mod.MIN_DEGREE}
    for t in plan_mod.TAU_GRID:
        d = int(math.ceil(plan_mod.DEGREE_PER_TAU * t))
        d = d if d % 2 == 1 else d + 1
        degs.add(max(d, plan_mod.MIN_DEGREE))
    degs.add(max(max_degree if max_degree % 2 == 1 else max_degree - 1, 1))
    return tuple(sorted(d for d in degs if d <= max_degree))


# ---------------------------------------------------------------------------
# collective accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PsumStats:
    """All_reduce calls issued under :func:`count_psums`.

    ``fused`` counts TUPLE reductions (several tensors in one call, one
    all_reduce of their flat concatenation), ``plain`` single-tensor
    ones.  The JAX package counts the calls of a traced program body
    once; here every call made at run time counts, so an operator of
    ``degree`` factors adds ``degree`` per application.
    """

    plain: int = 0
    fused: int = 0


_PSUM_STATS: PsumStats | None = None


@contextlib.contextmanager
def count_psums():
    """Count the all_reduce calls made under this context (every
    collective of the port's sharded paths goes through :func:`_psum`)."""
    global _PSUM_STATS
    prev, _PSUM_STATS = _PSUM_STATS, PsumStats()
    try:
        yield _PSUM_STATS
    finally:
        _PSUM_STATS = prev


def _psum(x, group):
    """``psum`` over ``group``: ``dist.all_reduce(SUM)`` IN PLACE on a
    tensor the caller owns, returned; a tuple of tensors of one dtype is
    reduced in ONE call on their flat concatenation and returned as new
    tensors.  Counted by :func:`count_psums`."""
    if _PSUM_STATS is not None:
        if isinstance(x, tuple):
            _PSUM_STATS.fused += 1
        else:
            _PSUM_STATS.plain += 1
    if isinstance(x, tuple):
        flat = torch.cat([t.reshape(-1) for t in x])
        dist.all_reduce(flat, group=group)
        parts = flat.split([t.numel() for t in x])
        return tuple(p.view_as(t) for p, t in zip(parts, x))
    dist.all_reduce(x, group=group)
    return x


# ---------------------------------------------------------------------------
# the solver step - THE single construction site
# ---------------------------------------------------------------------------


def apply_solver_step(step_fn, state: solvers.SolverState, av: torch.Tensor,
                      lr, gram: torch.Tensor | None = None
                      ) -> solvers.SolverState:
    """THE construction site of the mu-EG/Oja dilated solver step.

    ``gram`` is the hook for a caller that already holds the global
    2k x 2k gram of [V | AV]: the mu-EG update then runs row-locally
    (:func:`solvers.mu_eg_step_from_gram`).
    """
    if gram is not None:
        return solvers.mu_eg_step_from_gram(state, av, gram, lr)
    return step_fn(state, av, lr)


# ---------------------------------------------------------------------------
# single-panel loops
# ---------------------------------------------------------------------------

def run_chunk(opv: MatVec, step_fn, state: solvers.SolverState, lr,
              steps: int) -> tuple[solvers.SolverState, torch.Tensor]:
    """``steps`` dilated solver steps on one panel + one residual eval."""
    for _ in range(steps):
        state = apply_solver_step(step_fn, state, opv(state.v), lr)
    return state, metrics.operator_residual(opv, state.v)


@spans.span("sped.solve")
def run_program(operator: MatVec | solvers.StochMatVec, n: int,
                cfg: solvers.SolverConfig,
                v_star: torch.Tensor | None = None,
                stochastic: bool = False,
                init_v: torch.Tensor | None = None,
                device=None) -> tuple[solvers.SolverState, solvers.Trace]:
    """One-shot solve with ground-truth traces, ``run_solver``'s engine.

    Runs ``max(1, steps // eval_every)`` evals of ``eval_every`` steps
    each (the JAX package's cadence).  One ``torch.Generator`` seeded
    with ``cfg.seed`` on ``device`` (``None`` = the CUDA card, or
    ``init_v``'s device when given) drives the solve: the random initial
    panel is its first draw, and a ``stochastic`` operator, called as
    ``operator(generator, V)``, draws each step's batches after it from
    the same stream, so they never repeat the initial panel's bits.
    ``init_v`` warm-starts from an (n, k) panel via ``init_from_panel``
    and leaves the whole stream to the operator.
    """
    dev = init_v.device if init_v is not None else resolve_device(device)
    step_fn = solvers.make_step_fn(cfg.method, cfg.backend, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    if init_v is None:
        state = solvers.init_state(gen, n, cfg.k)
    else:
        state = solvers.init_from_panel(init_v)
    num_evals = max(1, cfg.steps // cfg.eval_every)
    if v_star is None:
        v_star = torch.zeros((n, cfg.k), dtype=torch.float32, device=dev)
    steps, err, streak = [], [], []
    for _ in range(num_evals):
        for _ in range(cfg.eval_every):
            av = operator(gen, state.v) if stochastic else operator(state.v)
            state = apply_solver_step(step_fn, state, av, cfg.lr)
        with spans.span("sped.eval"):
            steps.append(state.step)
            err.append(metrics.subspace_error(state.v, v_star))
            streak.append(metrics.eigenvector_streak(state.v, v_star))
    return state, solvers.Trace(steps=torch.stack(steps),
                                subspace_error=torch.stack(err),
                                streak=torch.stack(streak))


# ---------------------------------------------------------------------------
# batched (session-group) tick
# ---------------------------------------------------------------------------

def group_edge_rows(member_rows: Sequence[es_ops.EdgeRows], cs,
                    out: es_ops.EdgeRows | None = None,
                    other_stride: int | None = None) -> es_ops.EdgeRows:
    """The block-diagonal row CSR of a session group, written into
    ``out`` (or new tensors).

    ``member_rows`` are the members' own row CSRs
    (``graph_store.edge_rows``), all of one (node capacity n, slots S),
    and ``cs`` their dilation scales.  Member i's rows become rows
    ``[i n, (i + 1) n)``: its live entries are copied after those of the
    members before it, with neighbours offset by ``i n`` and weights
    times ``cs[i]``, and its hub rows, offset, join ONE ascending hub
    list padded with ``G n`` (K1/K2 stop at the first sentinel).  The
    result equals ``build_edge_rows`` of the block-diagonal c-scaled edge
    list bitwise on the live entries and the hub list, without its sort:
    a fill is copies only, plus one host read of every member's live and
    hub counts.  The shapes depend only on (G, n, S).

    ``other_stride`` offsets member i's neighbours by ``i other_stride``
    instead: the members' rows are then a panel shard's R owned rows
    (``graph_store.model_shard_rows``, n = R) whose neighbours index the
    members' stacked (G, other_stride, k) replicated panels."""
    g = len(member_rows)
    n = member_rows[0].row_ptr.shape[0] - 1
    stride = n if other_stride is None else other_stride
    slots = member_rows[0].other.shape[0]
    dev = member_rows[0].row_ptr.device
    if out is None:
        hub_cap = min(g * n, g * slots // (es_ops.HUB_THRESHOLD + 1))
        out = es_ops.EdgeRows(
            row_ptr=torch.empty(g * n + 1, dtype=torch.int32, device=dev),
            other=torch.empty(g * slots, dtype=torch.int32, device=dev),
            weight=torch.empty(g * slots, dtype=torch.float32, device=dev),
            hub_rows=torch.empty(hub_cap + 1, dtype=torch.int32, device=dev))
    counts = torch.stack([torch.stack([r.row_ptr[n].long(),
                                       (r.hub_rows < n).sum()])
                          for r in member_rows]).tolist()
    cs = torch.as_tensor(cs, dtype=torch.float32).to(dev)
    live = hubs = 0
    for i, (r, (nl, nh)) in enumerate(zip(member_rows, counts)):
        torch.add(r.row_ptr[:n], live, out=out.row_ptr[i * n:(i + 1) * n])
        torch.add(r.other[:nl], i * stride, out=out.other[live:live + nl])
        torch.mul(r.weight[:nl], cs[i], out=out.weight[live:live + nl])
        torch.add(r.hub_rows[:nh], i * n, out=out.hub_rows[hubs:hubs + nh])
        live, hubs = live + nl, hubs + nh
    out.row_ptr[g * n:].fill_(live)
    out.other[live:].zero_()
    out.weight[live:].zero_()
    out.hub_rows[hubs:].fill_(g * n)
    return out


def group_operator(rows: es_ops.EdgeRows, degree: int, kind: str,
                   group=None) -> MatVec:
    """(G, n, k) -> (G, n, k): every member's ``(I - c_i L_i)^degree``
    over the group's c-scaled layout, each factor one fused step at
    ``alpha = -1, beta = 1`` on the stacked (G n, k) panel.  ``kind``
    "kernel" launches K1 (G n <= ``backend.ONE_HOT_NODE_LIMIT``) or K2;
    "segment" runs their plain twin over the same rows, on any device.

    With an edge ``group`` the rows are this rank's shard of every
    member: a factor is the shard's ``c_i L_i,s u`` (alpha = 1, beta = 0),
    ONE all_reduce over the group, and ``u - that`` after it (beta must
    apply once, so the AXPY cannot ride the kernel's epilogue)."""
    if kind == "kernel":
        fused = backend_mod.rows_fused_step(rows)
    else:
        def fused(u, alpha, beta):
            return es_ref.edge_spmm_rows(rows.row_ptr, rows.other,
                                         rows.weight, u, alpha, beta)

    def opv_all(vs: torch.Tensor) -> torch.Tensor:
        g, n, k = vs.shape
        u = vs.reshape(g * n, k)
        for _ in range(degree):
            if group is None:
                u = fused(u, -1.0, 1.0)
            else:
                u = u - _psum(fused(u, 1.0, 0.0), group)
        return u.reshape(g, n, k)
    return opv_all


def _step_all(step_fn, vs: torch.Tensor, avs: torch.Tensor,
              lrs: torch.Tensor) -> torch.Tensor:
    """The solver step of every member (K3/K4 per member on the kernel
    path, over row-slice views of the stacked panel); ``lrs[i]`` is a
    device scalar, so a replayed graph reads the lr of its inputs.  The
    tick reports no step counts, so each member steps from count 0."""
    zero = torch.zeros((), dtype=torch.int32, device=vs.device)
    return torch.stack([
        apply_solver_step(step_fn, solvers.SolverState(v=vs[i], step=zero),
                          avs[i], lrs[i]).v for i in range(vs.shape[0])])


def _group_chunk(step_all: MatVec, vs, budget, steps: int):
    """``steps`` solver steps of every member (``step_all``: (G, n, k)
    panels -> the stepped panels), then the freeze: a member whose chunk
    budget is spent (``budget <= 0``) keeps its panel.  Returns
    (vs, budget - 1)."""
    live = budget > 0
    v = vs
    for _ in range(steps):
        v = step_all(v)
    return torch.where(live[:, None, None], v, vs), budget - 1


def _group_residuals(opv_all: MatVec, vs: torch.Tensor) -> torch.Tensor:
    """(G,) ``metrics.panel_residual`` of every member, one dilated
    application of the group."""
    avs = opv_all(vs)
    return torch.stack([metrics.panel_residual(vs[i], avs[i])
                        for i in range(vs.shape[0])])


def _budgets(chunks, g: int, device) -> tuple[torch.Tensor, int]:
    """(G,) int32 chunk budgets on ``device`` from a scalar or (G,)
    ``chunks``, and their max (the chunks the program runs)."""
    if isinstance(chunks, torch.Tensor):
        chunks = chunks.cpu().numpy()
    per = np.broadcast_to(np.asarray(chunks, np.int64), (g,)).copy()
    return torch.as_tensor(per, dtype=torch.int32, device=device), int(per.max())


class TickProgram:
    """One batched tick of a session group: ``prog(member_rows, cs, vs,
    lrs, chunks) -> (vs, res)``.

    ``member_rows`` are the G slots' own row CSRs and ``cs`` their
    dilation scales, ``vs`` the (G, n, k) stacked panels, ``lrs`` the
    (G,) learning rates and ``chunks`` the residual-decay scheduler's
    multiplier: a scalar, or a per-session (G,) budget.  Every member
    runs ``chunks[i] * steps`` solver steps and then FREEZES under a
    mask while its peers go on, up to ``max(chunks)`` chunks; one
    dilated application then gives the (G,) panel residuals.

    The program owns the group's layout: it fills it
    (:func:`group_edge_rows`, c folded into the weights) in place and
    only when a slot's row CSR or c differs from the last fill's
    (``layout_fills`` counts the fills), so two sub-batches that share
    the program refill it, by copies, each time they alternate.  On the
    kernel path the first call runs eagerly (on a side stream) and
    captures two CUDA graphs over the layout and static copies of the
    other inputs: one chunk (``steps`` steps and the freeze) and the
    residual evaluation.  Later calls copy their inputs in, replay the
    chunk graph ``max(chunks)`` times and the evaluation once, and add
    the launches the graphs hold to the counts.  Inputs of other shapes
    raise: a program serves one (G, node capacity, slots, k).
    ``captures`` counts the captures (at most one).  A segment program
    runs the same loop eagerly over the plain twins.

    An EDGE-SHARDED program (``group``, the process group of the mesh's
    edge axes) runs on every rank of the group with the members' SHARD
    row CSRs (``graph_store.shard_edge_rows``): each dilation factor is
    one K1/K2 launch on the shard's layout and one all_reduce of the
    stacked panel, and the solver steps run replicated on every rank.
    It runs eagerly at every call and captures nothing (``captures``
    stays 0): a gloo collective is host work, which a CUDA graph cannot
    hold.
    """

    def __init__(self, schedule: StepSchedule, device=None, group=None):
        self.schedule = schedule
        self.group = group
        self.device = resolve_device(device)
        self.kind = backend_mod.resolve_backend(schedule.backend, self.device)
        self.step_fn = solvers.make_step_fn(schedule.method, self.kind,
                                            self.device)
        self.captures = 0
        self.layout_fills = 0
        self._layout: es_ops.EdgeRows | None = None
        # per slot: (weak reference to its rows' weights, c) of the fill;
        # weak, so the program keeps no evicted or replaced store alive
        self._filled: list[tuple] = []
        self._static = None
        self._other_stride: int | None = None  # group_edge_rows' stride

    def _fill_layout(self, member_rows, cs) -> es_ops.EdgeRows:
        cs = [float(c) for c in cs]
        if len(member_rows) == len(self._filled) and all(
                ref() is r.weight and c == fc
                for r, c, (ref, fc) in zip(member_rows, cs, self._filled)):
            return self._layout
        if self._layout is not None:
            g = len(self._filled)
            got = (len(member_rows), member_rows[0].row_ptr.shape[0] - 1,
                   member_rows[0].other.shape[0])
            want = (g, (self._layout.row_ptr.shape[0] - 1) // g,
                    self._layout.other.shape[0] // g)
            if got != want:
                raise ValueError(f"tick program: (G, n, slots) {got} != "
                                 f"{want} of its layout")
        self._layout = group_edge_rows(member_rows, cs, out=self._layout,
                                       other_stride=self._other_stride)
        self._filled = [(weakref.ref(r.weight), c)
                        for r, c in zip(member_rows, cs)]
        self.layout_fills += 1
        return self._layout

    def _loop(self, rows, vs, lrs, budget, num_chunks: int):
        opv_all = group_operator(rows, self.schedule.degree, self.kind,
                                 self.group)
        for _ in range(num_chunks):
            vs, budget = _group_chunk(
                lambda v: _step_all(self.step_fn, v, opv_all(v), lrs), vs,
                budget, self.schedule.steps)
        return vs, _group_residuals(opv_all, vs)

    def __call__(self, member_rows: Sequence[es_ops.EdgeRows], cs,
                 vs: torch.Tensor, lrs, chunks
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        rows = self._fill_layout(member_rows, cs)
        budget, num_chunks = _budgets(chunks, vs.shape[0], vs.device)
        lrs = torch.as_tensor(lrs, dtype=torch.float32, device=vs.device)
        if self.kind == "segment" or self.group is not None:
            return self._loop(rows, vs, lrs, budget, num_chunks)
        if self._static is None:
            return self._capture(rows, vs, lrs, budget, num_chunks)
        return self._replay(vs, lrs, budget, num_chunks)

    def _capture(self, rows, vs, lrs, budget, num_chunks):
        out = operators.side_stream_call(
            lambda: self._loop(rows, vs, lrs, budget, num_chunks), vs.device)
        st = {"v": vs.clone(memory_format=torch.contiguous_format),
              "lrs": lrs.clone(), "budget": budget.clone()}
        opv_all = group_operator(rows, self.schedule.degree, "kernel")

        def chunk():
            v, left = _group_chunk(
                lambda u: _step_all(self.step_fn, u, opv_all(u), st["lrs"]),
                st["v"], st["budget"], self.schedule.steps)
            st["v"].copy_(v)
            st["budget"].copy_(left)

        st["chunk"] = operators.capture_graph(chunk)
        st["eval"] = operators.capture_graph(
            lambda: _group_residuals(opv_all, st["v"]))
        self._static = st
        self.captures += 1
        return out

    def _replay(self, vs, lrs, budget, num_chunks):
        st = self._static
        if vs.shape != st["v"].shape:
            raise ValueError(f"tick program: panels {tuple(vs.shape)} != "
                             f"{tuple(st['v'].shape)} it was captured at")
        st["v"].copy_(vs)
        st["lrs"].copy_(lrs)
        st["budget"].copy_(budget)
        graph, _, held = st["chunk"]
        for _ in range(num_chunks):
            graph.replay()
            add_launch_counts(held)
        graph, res, held = st["eval"]
        graph.replay()
        add_launch_counts(held)
        return st["v"].clone(), res.clone()


def build_tick_sharded_segment(schedule: StepSchedule, mesh,
                               edge_axes=("data",), device=None) -> TickProgram:
    """Edge-sharded segment tick: the plain twins over this rank's shard
    of the group layout, one all_reduce of the stacked panels per
    dilation factor (see :class:`TickProgram`)."""
    return TickProgram(dataclasses.replace(schedule, backend="segment"),
                       device, group=parallel.edge_group(mesh, edge_axes))


def build_tick_sharded_pallas(schedule: StepSchedule, mesh,
                              edge_axes=("data",), device=None) -> TickProgram:
    """Edge-sharded kernel tick (the JAX package's sharded pallas tick):
    K1/K2 on this rank's shard of the group layout, one all_reduce per
    dilation factor, the dilation AXPY after it and K3/K4 per member.
    The port's layout is a row CSR with no node blocks, so there are no
    blocking statics to pass."""
    return TickProgram(dataclasses.replace(schedule, backend="kernel"),
                       device, group=parallel.edge_group(mesh, edge_axes))


class ModelShardedTickProgram(TickProgram):
    """The PANEL-sharded group tick (the JAX package's
    ``build_tick_model_sharded``): ``prog(member_rows, cs, vs, lrs,
    chunks) -> (vs, res)`` on every rank of the mesh's model axes.

    Rank s owns the rows ``[s R, (s + 1) R)`` of every member's panel,
    padded to ``n_pad = S R`` rows, and ``member_rows`` are its members'
    OWNED-ROW CSRs (``graph_store.model_shard_rows``: every half-edge
    destined to those rows, local rows, global neighbours).  Its group
    layout puts member i's rows at ``i R`` and its neighbours at ``i
    n_pad`` of the flattened (G n_pad, k) replicated panels, weights times
    c_i, so each dilation factor ``u - c_i L_i u`` is ONE rectangular K2
    launch (``v_self`` the owned rows; the plain twin on segment) at
    ``alpha = -1, beta = 1``: the owned rows are final, so the AXPY stays
    in the epilogue.  Collectives only assemble disjoint row ranges:

    * every factor but the last: one plain all_reduce of the embedded
      (G, n_pad, k) panels;
    * mu-EG: the last factor's rows and the per-member 2k x 2k grams of
      [V | AV] over the owned rows (K3) in ONE tuple all_reduce, then
      every rank steps the replicated panels row-locally from the summed
      gram (``apply_solver_step(..., gram=)``; K4);
    * Oja (no gram form): the last factor assembled plainly too, then
      the replicated step.

    A step is ``degree - 1`` plain and 1 fused all_reduce (Oja: ``degree``
    plain); a residual evaluation is ``degree`` plain.  Members freeze
    past their chunk budgets as in :class:`TickProgram`.  Each rank's
    owned rows are sliced from the stepped replicated panel, which is
    the same on every rank, so the panels stay bitwise equal across
    ranks.  Gloo collectives are host work: the program runs eagerly and
    captures nothing.
    """

    def __init__(self, schedule: StepSchedule, mesh, model_axes=("model",),
                 device=None):
        num_shards = parallel.num_model_shards(mesh, model_axes)
        super().__init__(schedule, device,
                         group=parallel.edge_group(mesh, model_axes))
        self.num_shards = num_shards
        self.shard = parallel.model_shard_index(mesh, model_axes)

    def __call__(self, member_rows: Sequence[es_ops.EdgeRows], cs,
                 vs: torch.Tensor, lrs, chunks
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        g, n, k = vs.shape
        r = member_rows[0].row_ptr.shape[0] - 1
        n_pad = self.num_shards * r
        if n_pad < n:
            raise ValueError(f"tick program: {self.num_shards} shards of {r} "
                             f"rows cannot hold {n}-row panels")
        self._other_stride = n_pad
        rows = self._fill_layout(member_rows, cs)
        budget, num_chunks = _budgets(chunks, g, vs.device)
        lrs = torch.as_tensor(lrs, dtype=torch.float32, device=vs.device)
        full = torch.zeros((g, n_pad, k), dtype=torch.float32,
                           device=vs.device)
        full[:, :n] = vs
        start = self.shard * r
        spmm = (es_ops.edge_spmm_rows_nb if self.kind == "kernel"
                else lambda rw, x, a, b, v_self: es_ref.edge_spmm_rows(
                    rw.row_ptr, rw.other, rw.weight, x, a, b, v_self))

        def owned(full):
            # (G, n_pad, k) replicated -> (G, R, k) final owned rows of
            # every member's (I - c_i L_i)
            return spmm(rows, full.reshape(g * n_pad, k), -1.0, 1.0,
                        v_self=full[:, start:start + r].reshape(g * r, k)
                        ).reshape(g, r, k)

        def embed(ys):
            z = torch.zeros((g, n_pad, k), dtype=ys.dtype, device=ys.device)
            z[:, start:start + r] = ys
            return z

        def dilated_local(full):
            # degree - 1 factors with plain row assembly; the last
            # factor's rows stay local, for the caller's reduction
            for _ in range(self.schedule.degree - 1):
                full = _psum(embed(owned(full)), self.group)
            return owned(full)

        def assembled(full):
            return _psum(embed(dilated_local(full)), self.group)

        zero = torch.zeros((), dtype=torch.int32, device=vs.device)

        def mu_eg_all(full):
            av_loc = dilated_local(full)
            grams = torch.stack([
                solvers.panel_gram2k(full[i, start:start + r], av_loc[i])
                for i in range(g)])
            # THE fused collective: row assembly + gram reduction
            av_full, grams = _psum((embed(av_loc), grams), self.group)
            return torch.stack([
                apply_solver_step(self.step_fn,
                                  solvers.SolverState(v=full[i], step=zero),
                                  av_full[i], lrs[i], gram=grams[i]).v
                for i in range(g)])

        if self.schedule.method == "mu_eg":
            step_all = mu_eg_all
        else:
            def step_all(full):
                return _step_all(self.step_fn, full, assembled(full), lrs)
        for _ in range(num_chunks):
            full, budget = _group_chunk(step_all, full, budget,
                                        self.schedule.steps)
        return full[:, :n].contiguous(), _group_residuals(assembled, full)


def build_tick_model_sharded(schedule: StepSchedule, mesh,
                             model_axes=("model",),
                             device=None) -> ModelShardedTickProgram:
    """Panel-sharded tick (the JAX package's ``build_tick_model_sharded``):
    each rank owns a row range of every member's panel, one rectangular
    K2 launch per dilation factor on its owned rows, and per mu-EG step
    ``degree - 1`` plain all_reduces plus ONE fused rows + gram all_reduce
    (see :class:`ModelShardedTickProgram`).  The port's layout is a row
    CSR, so there are no blocking statics to pass."""
    return ModelShardedTickProgram(schedule, mesh, model_axes, device)


def build_tick_program(schedule: StepSchedule, device=None, *, mesh=None,
                       edge_axes=("data",), model_axes=None) -> TickProgram:
    """One batched tick program for a session group on ``device``
    (``None`` = the card): the kernel tick on CUDA, the segment tick on
    the CPU (``schedule.backend="auto"``).  The streaming service keeps
    one per (capacity class, degree, occupancy bucket); per-session c,
    lr and chunk budgets are inputs, so the adaptive layer moves under
    one program.  ``mesh`` makes it edge-sharded over ``edge_axes``
    (one all_reduce per dilation factor), or with ``model_axes``
    panel-sharded over those axes (:func:`build_tick_model_sharded`), which
    needs a mesh."""
    if model_axes is not None:
        if mesh is None:
            raise ValueError("model_axes (a panel-sharded tick) needs a mesh")
        return build_tick_model_sharded(schedule, mesh, model_axes, device)
    if mesh is not None:
        return TickProgram(schedule, device,
                           group=parallel.edge_group(mesh, edge_axes))
    return TickProgram(schedule, device)


# ---------------------------------------------------------------------------
# residual-decay forecasting (the adaptive scheduler's math)
# ---------------------------------------------------------------------------

def contraction_rate(res_prev: float, res: float,
                     steps: int) -> float | None:
    """Measured per-step residual decay ratio, or None when the pair of
    observations carries no usable contraction signal (non-finite,
    non-positive, zero steps, or not actually decaying)."""
    if steps <= 0 or not (math.isfinite(res_prev) and math.isfinite(res)):
        return None
    if not (0.0 < res < res_prev):
        return None
    return (res / res_prev) ** (1.0 / steps)


def predicted_residual(res: float, rate: float, steps: int) -> float:
    """Forecast the panel residual after ``steps`` more solver steps."""
    return res * rate ** steps


def predicted_steps_to_tol(res: float, rate: float | None,
                           tol: float) -> int:
    """Predicted-contraction stopping: solver steps until the residual
    is forecast to reach ``tol`` (0 when already there; a large sentinel
    when the rate predicts no convergence)."""
    if res <= tol:
        return 0
    if rate is None or not (0.0 < rate < 1.0):
        return 1 << 30
    return int(math.ceil(math.log(tol / res) / math.log(rate)))
