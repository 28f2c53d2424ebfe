"""Multi-tenant streaming clustering service.

Owns many mutable graphs (:mod:`~repro_torch.stream.graph_store`), each
with a live eigenvector panel, and advances them with BATCHED ticks
built by :mod:`repro_torch.core.program`:

  * Sessions are grouped by CAPACITY CLASS - (node_cap, edge_cap) - plus
    their scheduled dilation DEGREE, and every group tick is ONE
    :class:`~repro_torch.core.program.TickProgram` invocation over the
    group's block-diagonal layout (``program.group_edge_rows``, filled
    by copies from the members' cached row CSRs, member i's weights
    pre-scaled by its dilation scale c_i) and stacked panels.  Shapes never depend on a session's live edge count or real
    node count, so a program serves every later tick of its group; on
    the card it replays the CUDA graphs captured at its first call.
    Groups are padded to power-of-two occupancy of their ACTIVE
    (unconverged) members with replicas of the first member, each in a
    block of rows of its own whose outputs are dropped, so the program
    set stays logarithmic while converged sessions cost ZERO device
    work per tick.  The program owns the layout and refills it only
    when a slot's store or c changed since its last call.
  * The per-session operator is the dilated reversed Laplacian
    (I - c L)^degree, scheduled from a real
    :class:`~repro_torch.spectral.plan.DilationPlan`: admission and
    re-solve probes (SLQ lambda_max and bottom-edge gap) feed
    ``plan_dilation``, which picks the per-session strength, the
    per-CLASS degree (the max over the class, on the planner's snapped
    grid) and the per-session lr.  c and lr are per-session inputs of
    the program: different graphs, one program.
  * Per-session convergence is the ground-truth-free panel residual;
    converged sessions leave the tick rotation, get their eigen
    estimate anchored (:mod:`~repro_torch.stream.updates`) and serve
    labels until edge updates arrive.  Updates take the first-order
    eigen-update path and re-enter the rotation when drift triggers the
    fallback, warm-started per :mod:`~repro_torch.stream.warm`'s
    restart test.
  * The RESIDUAL-DECAY TICK SCHEDULER (``tick_schedule=
    "residual_decay"``, the default): each session's measured decay
    rate forecasts its remaining solver steps
    (``program.predicted_steps_to_tol``), and a session forecast to stay
    far above tolerance rides a MULTIPLIED tick, its own chunk budget
    inside the shared program (members past their budget freeze under
    a mask).  A group mixing plain and stretched members sub-batches
    into two invocations when that costs fewer slot-steps
    (:func:`_split_by_multiplier`).  ``"round_robin"`` keeps fixed-size
    ticks.

Node padding invariant: panels keep EXACT zeros on rows >= the session's
real node count.  No edge touches a padding node, and every solver
operation maps zero rows to zero rows.

Random draws (admission panels, probe vectors, cold restarts, k-means)
come from ``torch.Generator`` s seeded from
``SeedSequence([seed + offset, index])``; they differ from the JAX
package's ``jax.random`` draws, and ``resume_panel`` starts both
packages from one panel.

EDGE-SHARDED serving (``ServiceConfig(mesh=...)``, :mod:`.sharded`):
every rank of the mesh runs this service on the same inputs, with the
same stores, panels and decisions; each group tick runs on the rank's
shard of every member's edge buffer with one all_reduce per dilation
factor, and admission probes run through the same sharded matvec.

PANEL-SHARDED serving (``ServiceConfig(mesh=..., model_axes=...)``):
every rank owns a row range of every session's panel instead; a group
tick runs one rectangular K2 launch per dilation factor on the rank's
owned rows (``graph_store.model_shard_rows``) and ships each mu-EG
step's row assembly and gram in one fused all_reduce
(``program.ModelShardedTickProgram``); admission probes run through the
same owned-rows matvec (``probes.probe_model_sharded``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import kmeans as km
from repro_torch.core import metrics, operators, program, solvers
from repro_torch.core.laplacian import EdgeList
from repro_torch.data.pipeline import mixed_seed
from repro_torch.device import resolve_device
from repro_torch.kernels.edge_spmm import ops as es_ops
from repro_torch.spectral import plan as plan_mod
from repro_torch.spectral import probes as spectral_probes
from repro_torch.stream import graph_store as gs
from repro_torch.stream import sharded as sharded_mod
from repro_torch.stream import tracking, updates

_next_pow2 = es_ops.next_pow2

# Families the tick programs can execute: the (I - c L)^degree form only
# (identity rides as degree 1 with c = 1/lambda*); cheb recurrences need
# the series evaluator, so the planner weakens tau into the budget
# instead of switching family.
_TICK_FAMILIES = ("identity", "limit_neg_exp")

# offsets of the seed per kind of draw, the JAX package's PRNGKey(seed + i)
_PANEL_SEED, _RESTART_SEED, _KMEANS_SEED, _PROBE_SEED = 0, 1, 2, 7


def _generator(device, seed: int, index: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from SeedSequence([seed, index])."""
    return torch.Generator(device=device).manual_seed(mixed_seed(seed, index))


def node_capacity_class(num_nodes: int) -> int:
    """Node-count capacity class (power of two >= num_nodes)."""
    return max(_next_pow2(num_nodes), 64)


def _split_by_multiplier(members: list, mults: np.ndarray) -> list:
    """Sub-batch a tick group so short-budget members don't ride a long
    invocation.  The program's device cost is occupancy x the LARGEST
    member budget (frozen slots still step), so members bucket by pow2
    of their multiplier, then adjacent buckets re-merge whenever pow2
    occupancy padding makes the joint invocation no dearer in
    slot-steps.  Singleton and uniform-multiplier groups never split."""
    buckets: dict[int, list[int]] = {}
    for i, m in enumerate(mults):
        buckets.setdefault((int(m) - 1).bit_length(), []).append(i)
    if len(buckets) == 1:
        return [(members, mults)]
    subs = [idx for _, idx in sorted(buckets.items())]
    merged = [subs[0]]
    for idx in subs[1:]:
        prev = merged[-1]
        cost_split = (_next_pow2(len(prev)) * int(mults[prev].max())
                      + _next_pow2(len(idx)) * int(mults[idx].max()))
        cost_joint = (_next_pow2(len(prev) + len(idx))
                      * int(mults[idx].max()))
        if cost_joint <= cost_split:
            merged[-1] = prev + idx
        else:
            merged.append(idx)
    return [([members[i] for i in s], mults[s]) for s in merged]


class UnknownSessionError(KeyError):
    """An operation referenced a session id that was never admitted or
    was already evicted.  A ``KeyError`` subclass, so callers guarding
    dict lookups keep working; the serving layer maps it to 404."""

    def __init__(self, sid: str):
        super().__init__(sid)
        self.sid = sid

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes the arg
        return f"unknown or evicted session {self.sid!r}"


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    k: int = 6  # eigenvectors tracked per session
    num_clusters: int = 4  # default clusters served per session
    method: str = "mu_eg"  # solver step: "mu_eg" | "oja"
    lr: float = 0.3  # base step size (per-session values ride over it)
    degree: int = 15  # odd; BUDGET for the planned per-class degree
    dilation_strength: float = 8.0  # ceiling on the planned tau
    steps_per_tick: int = 20  # solver steps per session per tick
    tol: float = 2e-3  # panel-residual convergence target
    restart_residual: float = 0.6  # warm.py restart test
    fallback_ratio: float = 0.5  # updates.py drift fallback
    min_batch_pad: int = 16  # update batches pad to pow2 >= this
    drop_trivial: bool = True  # skip the all-ones nullvector in embeddings
    kmeans_restarts: int = 8
    seed: int = 0
    # SLQ probes on admission and drift re-solves: a tight lambda_max in
    # place of the Gershgorin bound (which stays as the cap and as the
    # fallback with probing off).
    probe_spectrum: bool = True
    probe_vectors: int = 2  # SLQ probe vectors per (re-)probe
    probe_steps: int = 16  # Lanczos steps per probe vector
    # repro_torch.core.backend: "auto" = kernel on the card, segment on
    # the CPU.
    backend: str = "auto"
    # The JAX package's node-block rows per tick; the port's group layout
    # is a row CSR with no node blocks, so only the default is accepted.
    tick_block_n: int = 512
    # EDGE-SHARDED serving: a torch.distributed DeviceMesh (every rank
    # runs the service); group ticks and admission probes shard the edge
    # buffers over `edge_axes` with one all_reduce per dilation matvec,
    # and admission/growth round edge capacities up to a multiple of the
    # shard count.  None = one-device ticks.
    mesh: object | None = None
    edge_axes: tuple = ("data",)
    # PANEL sharding (with a mesh): every rank owns the rows [s R, (s+1) R)
    # of every session's panel and the half-edges destined there
    # (graph_store.model_shard_rows); group ticks run one K2 launch per
    # factor on the owned rows and ship each mu-EG step's rows and gram
    # in ONE fused all_reduce, and admission probes run over the same
    # owned-rows matvec.  None = replicated panels.
    model_axes: tuple | None = None
    # "residual_decay" gives each session its own chunk budget when it is
    # forecast to stay above `eval_payoff * steps_per_tick` steps from
    # tolerance; "round_robin" = fixed-size ticks for every group.
    tick_schedule: str = "residual_decay"
    max_tick_multiplier: int = 8  # cap on the scheduled multiplier
    eval_payoff: float = 2.0  # multiply only past this many plain ticks
    # Sessions within this factor of tol cap their multiplier at 4: the
    # measured rate plateaus near convergence, so forecasts there are
    # unreliable in both directions.
    stretch_residual_floor: float = 4.0

    def __post_init__(self):
        if self.degree % 2 == 0:
            raise ValueError("degree must be odd (limit_neg_exp series)")
        if self.backend not in backend_mod.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.tick_schedule not in ("round_robin", "residual_decay"):
            raise ValueError(
                f"unknown tick_schedule {self.tick_schedule!r}")
        if self.tick_block_n != 512:
            raise ValueError(
                "tick_block_n: the port's tick layout has no node blocks "
                "(a row CSR); leave it at 512")
        if self.mesh is not None:
            names = getattr(self.mesh, "mesh_dim_names", None) or ()
            axes = tuple(self.edge_axes) + tuple(self.model_axes or ())
            missing = [a for a in axes if a not in names]
            if missing:
                raise ValueError(f"mesh axes {missing} not in mesh axes "
                                 f"{tuple(names)}")
        elif self.model_axes is not None:
            raise ValueError("model_axes requires a mesh")


@dataclasses.dataclass
class _Session:
    sid: str
    n: int  # real node count (<= store.num_nodes == node capacity)
    num_clusters: int
    store: gs.GraphStore
    v: torch.Tensor  # (node_cap, k) panel, zero rows >= n
    plan: plan_mod.DilationPlan  # the session's dilation schedule source
    rho_ub: float  # Gershgorin bound at the time plan.rho was set
    lr: float  # per-session step size (an input of the tick program)
    plan_degree: int  # the session's own planned degree suggestion
    tracker: tracking.LabelTracker
    group_key: tuple | None = None  # last tick-group key (introspection)
    est: updates.EigenEstimate | None = None
    converged: bool = False
    residual: float = float("inf")
    rate: float | None = None  # measured per-step residual decay ratio
    ticks: int = 0
    solves: int = 0  # full (re-)solve episodes entered
    incremental_updates: int = 0
    fallbacks: int = 0

    @property
    def rho(self) -> float:
        return self.plan.rho

    @property
    def tau(self) -> float:
        return self.plan.tau


def panel_labels(panel: torch.Tensor, num_clusters: int, *,
                 drop_trivial: bool = True, seed: int = 0,
                 kmeans_restarts: int = 8) -> np.ndarray:
    """Raw k-means labelling of an (n, k) embedding panel - the
    tracker-free labelling primitive shared by
    :meth:`StreamingService.labels` and the serve layer's results store.
    k-means draws from a generator on the panel's device seeded from
    ``seed``."""
    start = 1 if drop_trivial else 0
    emb = panel[:, start: start + num_clusters]
    norms = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    emb = emb / torch.clamp(norms, min=1e-12)
    res = km.kmeans(_generator(panel.device, seed + _KMEANS_SEED), emb,
                    num_clusters, restarts=kmeans_restarts)
    return res.labels.cpu().numpy()


def _init_panel(generator: torch.Generator, node_cap: int, n: int,
                k: int) -> torch.Tensor:
    """Random orthonormal panel supported on the first n rows."""
    dev = generator.device
    v = torch.randn((node_cap, k), generator=generator, dtype=torch.float32,
                    device=dev)
    v = v * (torch.arange(node_cap, device=dev) < n)[:, None]
    q, _ = torch.linalg.qr(v)
    return q.contiguous()


class StreamingService:
    """Session manager: admission, streaming updates, batched ticking,
    label serving, eviction.  Sessions live on ``device`` (``None`` =
    the CUDA card)."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._backend = backend_mod.resolve_backend(cfg.backend, self.device)
        self._mesh = cfg.mesh
        # panel sharding re-buckets half-edges by destination itself, so
        # the edge-balance contract (_num_shards) stays on edge_axes
        self._model_axes = (tuple(cfg.model_axes) if cfg.mesh is not None
                            and cfg.model_axes is not None else None)
        self._num_shards = (sharded_mod.num_edge_shards(cfg.mesh, cfg.edge_axes)
                            if cfg.mesh is not None else 1)
        self._sessions: dict[str, _Session] = {}
        self._compiled: dict[tuple, program.TickProgram] = {}
        self._admitted = 0
        self._probes_run = 0
        # scheduler/work accounting: program invocations and the
        # device-work slots they spent (occupancy x solver steps)
        self._tick_invocations = 0
        self._device_work = 0
        self._multiplied_ticks = 0  # invocations the scheduler stretched
        # per-class degree map memo, invalidated on admission, eviction
        # and re-plans
        self._class_degree_cache: dict[tuple, int] | None = None

    def _get(self, sid: str) -> _Session:
        try:
            return self._sessions[sid]
        except KeyError:
            raise UnknownSessionError(sid) from None

    def has_session(self, sid: str) -> bool:
        return sid in self._sessions

    def session_ids(self) -> list[str]:
        return list(self._sessions)

    def _balanced(self, capacity: int) -> int:
        """Edge capacity rounded up to a shard-balanced size."""
        return sharded_mod.balanced_capacity(capacity, self._num_shards)

    def _tick_rows(self, store: gs.GraphStore) -> es_ops.EdgeRows:
        """The row CSR a group tick reads for a member: the store's own,
        on a mesh this rank's shard of it, or with model axes this rank's
        owned panel rows."""
        if self._model_axes is not None:
            return gs.model_shard_rows(store, self._mesh, self._model_axes,
                                       block_n=self.cfg.tick_block_n)
        if self._mesh is None:
            return gs.edge_rows(store)
        return gs.shard_edge_rows(store, self._mesh, self.cfg.edge_axes)

    def _fused(self, store: gs.GraphStore) -> backend_mod.FusedStep:
        """The store's fused step on the service's backend, over its
        cached row CSR on the kernel path."""
        return gs.fused_step(store, self._backend)

    # ------------------------------------------------------------------
    # spectral probing + dilation planning
    # ------------------------------------------------------------------

    def _rho_estimate(self, store: gs.GraphStore, n: int) -> tuple:
        """(refreshed store, rho, rho_ub, lam_k, lam_k1) - plan anchors.

        rho is the SLQ lambda_max estimate capped by the Gershgorin
        bound; with probing off, or a degenerate probe, it IS the bound.
        The probe's Lanczos steps run over the store's fused step (K1/K2
        on its cached row CSR on the card).
        """
        cfg = self.cfg
        store, rho_ub = gs.spectral_radius_upper_bound(store)
        rho_ub = float(rho_ub)
        rho = rho_ub
        lam_k = lam_k1 = None
        if cfg.probe_spectrum and n > 1:
            self._probes_run += 1
            gen = _generator(self.device, cfg.seed + _PROBE_SEED,
                             self._probes_run)
            if self._model_axes is not None:
                # the panel-sharded tick's decomposition: the rank's owned
                # rows (cached on the store for its ticks), one all_reduce
                # assembling them per Lanczos matvec
                probe = spectral_probes.probe_model_sharded(
                    self._mesh, self._tick_rows(store), n,
                    num_nodes=store.num_nodes, model_axes=self._model_axes,
                    num_probes=cfg.probe_vectors, num_steps=cfg.probe_steps,
                    generator=gen, backend=self._backend)
            elif self._mesh is not None:
                # the tick's decomposition: the rank's slice, one
                # all_reduce per Lanczos matvec
                probe = spectral_probes.probe_sharded_edge_arrays(
                    self._mesh, store.src, store.dst, store.weight, gen, n,
                    num_nodes=store.num_nodes, edge_axes=cfg.edge_axes,
                    num_probes=cfg.probe_vectors, num_steps=cfg.probe_steps,
                    backend=self._backend)
            else:
                fused = self._fused(store)
                probe = spectral_probes.slq_probe(
                    lambda v: fused(v, 1.0, 0.0), store.num_nodes, gen,
                    num_probes=cfg.probe_vectors, num_steps=cfg.probe_steps,
                    n_real=n)
            est = float(probe.lambda_max)
            if np.isfinite(est) and est > 0.0:
                rho = min(est, rho_ub)
                lam_k, lam_k1 = spectral_probes.bottom_edge(probe, cfg.k)
        return store, rho, rho_ub, lam_k, lam_k1

    def _plan_session(self, sess: _Session, rho: float, rho_ub: float,
                      lam_k: float | None = None,
                      lam_k1: float | None = None) -> None:
        """Re-run the dilation planner on fresh probe anchors: strength,
        degree suggestion and the per-session lr (normalized to the
        plan's wanted-direction scale, ``program.session_lr``)."""
        cfg = self.cfg
        sess.plan = plan_mod.plan_dilation(
            None, k=cfg.k, budget=cfg.degree,
            rho_fallback=rho_ub,
            rho=rho if rho > 0.0 else None,
            lam_k=lam_k, lam_k1=lam_k1,
            tau_cap=cfg.dilation_strength,
            families=_TICK_FAMILIES,
            source="slq" if lam_k is not None else "fallback")
        sess.rho_ub = rho_ub
        sess.plan_degree = (1 if sess.plan.family == "identity"
                            else sess.plan.degree)
        sess.lr = program.session_lr(sess.plan, cfg.lr)
        sess.rate = None  # operator changed: stale decay forecast
        self._class_degree_cache = None  # degree suggestion may move

    def _shift_rho(self, sess: _Session, rho_new: float,
                   rho_ub_new: float) -> None:
        """Ordinary-batch rescale: move the plan's rho anchor without
        re-probing.  Degenerate plans (edgeless admission, rho == 0)
        re-plan from the fresh bound instead."""
        if sess.plan.rho <= 0.0 or not math.isfinite(sess.plan.rho):
            self._plan_session(sess, rho_new, rho_ub_new)
            return
        repl = {"rho": rho_new}
        if sess.plan.family == "identity":
            repl["lambda_star"] = plan_mod.identity_lambda_star(rho_new)
        sess.plan = dataclasses.replace(sess.plan, **repl)
        sess.rho_ub = rho_ub_new
        sess.lr = program.session_lr(sess.plan, self.cfg.lr)

    # ------------------------------------------------------------------
    # admission / eviction
    # ------------------------------------------------------------------

    def add_graph(self, sid: str, g: EdgeList, num_clusters: int | None = None,
                  edge_capacity: int | None = None,
                  resume_panel=None) -> None:
        """Admit a graph (moved to the service's device) into its
        capacity class.

        ``resume_panel`` ((n, k), numpy or tensor) warm-starts the
        session from a previously evicted panel (the ``panel`` entry of
        :meth:`evict`'s summary), re-orthonormalized through
        ``solvers.init_from_panel`` onto the class's node padding.
        """
        if sid in self._sessions:
            raise ValueError(f"session {sid!r} already exists")
        cfg = self.cfg
        clusters = num_clusters or cfg.num_clusters
        need = clusters + (1 if cfg.drop_trivial else 0)
        if need > cfg.k:
            raise ValueError(
                f"num_clusters={clusters} needs {need} tracked "
                f"eigenvectors (drop_trivial={cfg.drop_trivial}) but "
                f"ServiceConfig.k={cfg.k}")
        g = EdgeList(g.src.to(self.device), g.dst.to(self.device),
                     g.weight.to(self.device), g.num_nodes)
        node_cap = node_capacity_class(g.num_nodes)
        cap = (gs.capacity_class(g.num_edges) if edge_capacity is None
               else edge_capacity)
        store = gs.from_edge_list(g, capacity=self._balanced(cap),
                                  num_nodes=node_cap)
        store, rho, rho_ub, lam_k, lam_k1 = self._rho_estimate(
            store, g.num_nodes)
        index = self._admitted
        self._admitted += 1
        if resume_panel is not None:
            rp = (resume_panel if isinstance(resume_panel, torch.Tensor)
                  else torch.from_numpy(np.array(resume_panel, np.float32)))
            rp = rp.to(device=self.device, dtype=torch.float32)
            if tuple(rp.shape) != (g.num_nodes, cfg.k):
                raise ValueError(
                    f"resume_panel shape {tuple(rp.shape)} != "
                    f"({g.num_nodes}, {cfg.k})")
            v = torch.zeros((node_cap, cfg.k), dtype=torch.float32,
                            device=self.device)
            v[: g.num_nodes] = rp
            v = solvers.init_from_panel(v).v
        else:
            v = _init_panel(_generator(self.device, cfg.seed + _PANEL_SEED,
                                       index), node_cap, g.num_nodes, cfg.k)
        sess = _Session(
            sid=sid,
            n=g.num_nodes,
            num_clusters=clusters,
            store=store,
            v=v,
            plan=plan_mod.plan_dilation(None, k=cfg.k, budget=cfg.degree),
            rho_ub=rho_ub,
            lr=cfg.lr,
            plan_degree=1,
            tracker=tracking.LabelTracker(clusters),
        )
        self._plan_session(sess, rho, rho_ub, lam_k, lam_k1)
        sess.solves = 1  # the admission (cold or resumed) solve
        self._sessions[sid] = sess
        self._class_degree_cache = None  # fleet membership changed

    def evict(self, sid: str) -> dict:
        """Remove a session; returns its summary, including the live
        eigenvector ``panel`` (real rows, numpy) for a later
        ``add_graph(resume_panel=...)``.  Raises
        :class:`UnknownSessionError` on an unknown or already-evicted
        sid."""
        sess = self._get(sid)
        summary = self._summary(sess)
        summary["panel"] = sess.v[: sess.n].cpu().numpy()
        del self._sessions[sid]
        self._class_degree_cache = None  # fleet membership changed
        return summary

    def evict_converged(self) -> dict[str, dict]:
        """Drop every converged session (label consumers are done)."""
        done = [s for s in self._sessions.values() if s.converged]
        return {s.sid: self.evict(s.sid) for s in done}

    # ------------------------------------------------------------------
    # streaming updates
    # ------------------------------------------------------------------

    def apply_updates(self, sid: str, edges, weights,
                      mode: str = "set",
                      pad_to: int | None = None) -> gs.BatchStats:
        """Apply an edge batch; converged sessions take the first-order
        eigen-update path, falling back to a warm re-solve on drift.

        ``pad_to`` pins one batch pad for a caller draining many sessions
        of a class at once."""
        cfg = self.cfg
        sess = self._get(sid)
        pad = max(_next_pow2(len(np.atleast_1d(weights))),
                  cfg.min_batch_pad)
        if pad_to is not None:
            pad = max(pad, _next_pow2(pad_to))
        batch = gs.coalesce_batch(edges, weights, mode=mode, pad_to=pad,
                                  device=self.device)
        store, dw, stats = gs.apply_edge_batch(sess.store, batch, mode=mode)
        base = sess.store
        while int(stats.dropped) > 0:
            # buffer overflow: grow the ORIGINAL store (apply is
            # functional) and re-apply the whole batch, growing again
            # until nothing drops; the session changes capacity class.
            # Sharded serving keeps the capacity a multiple of the shards.
            base = gs.grow(base)
            if base.capacity != self._balanced(base.capacity):
                base = gs.grow(base, self._balanced(base.capacity))
            store, dw, stats = gs.apply_edge_batch(base, batch, mode=mode)
        # Ordinary batches rescale cheaply: track the probed estimate by
        # the Gershgorin bound's relative change, capped by the fresh
        # bound.  Full re-probes happen on admission and drift re-solves.
        store, rho_ub = gs.spectral_radius_upper_bound(store)
        rho_ub_new = float(rho_ub)
        sess.store = store
        sess.rate = None  # operator changed
        self._class_degree_cache = None  # the class may have grown
        if sess.rho_ub > 0.0:
            rho_new = min(rho_ub_new,
                          sess.plan.rho * rho_ub_new / sess.rho_ub)
        else:
            # degenerate (edgeless) admission: re-anchor on the bound
            rho_new = rho_ub_new
        self._shift_rho(sess, rho_new, rho_ub_new)
        if sess.est is not None:
            prev_v = sess.est.v
            est, drift_flag = updates.update_or_flag(
                sess.est, batch.src, batch.dst, dw,
                updates.UpdateConfig(fallback_ratio=cfg.fallback_ratio))
            sess.v = est.v
            sess.incremental_updates += 1
            if not drift_flag:
                sess.est = est  # cheap path: drift bound still safe
                # The drift bound guards first-order VALIDITY, not the
                # residual target: verify a real change with one
                # operator application and re-enter the tick rotation
                # when the panel misses tolerance; a realized no-op
                # (dw == 0) keeps convergence verbatim.
                if sess.converged and bool((dw != 0.0).any()):
                    res = self._residual(sess)
                    sess.residual = res
                    if res > cfg.tol:
                        sess.converged = False
                        sess.est = None  # ticking owns the panel again
                return stats
            # The drift bound is conservative: before a re-solve, verify
            # whether the updated panel still meets tolerance.
            res = self._residual(sess)
            sess.residual = res
            if res <= 2.0 * cfg.tol:
                sess.est = updates.anchor_estimate(self._fused(sess.store),
                                                   sess.v)
                return stats
            # Full re-solve: re-probe, re-plan, and seed from whichever of
            # the updated and the stale panel has the lower residual under
            # the new operator; go cold past the restart test.
            sess.fallbacks += 1
            sess.est = None
            sess.converged = False
            st2, rho2, rho_ub2, lam_k2, lam_k12 = self._rho_estimate(
                sess.store, sess.n)
            sess.store = st2
            self._plan_session(sess, rho2, rho_ub2, lam_k2, lam_k12)
            res = self._residual(sess)  # est.v under the re-probed op
            sess.v = prev_v
            res_prev = self._residual(sess)
            if res <= res_prev:
                sess.v, best = est.v, res
            else:
                best = res_prev
            if best > cfg.restart_residual:
                sess.v = _init_panel(
                    _generator(self.device, cfg.seed + _RESTART_SEED,
                               sess.solves),
                    sess.store.num_nodes, sess.n, cfg.k)
            sess.residual = best
            sess.solves += 1
        return stats

    # ------------------------------------------------------------------
    # batched ticking
    # ------------------------------------------------------------------

    def _class_key(self, sess: _Session) -> tuple[int, int]:
        return (sess.store.num_nodes, sess.store.capacity)

    def _class_degrees(self) -> dict[tuple, int]:
        """Per-capacity-class dilation degree: the max over the class's
        resident exp-family sessions' planned suggestions.  Identity
        sessions tick in their own degree-1 groups.  Memoized until
        admission, eviction or a re-plan invalidates it."""
        if self._class_degree_cache is None:
            degs: dict[tuple, int] = {}
            for s in self._sessions.values():
                if s.plan.family == "identity":
                    continue
                ck = self._class_key(s)
                degs[ck] = max(degs.get(ck, 0), s.plan_degree)
            self._class_degree_cache = degs
        return self._class_degree_cache

    def _session_degree(self, sess: _Session,
                        degrees: dict | None = None) -> int:
        if sess.plan.family == "identity":
            return 1
        degrees = self._class_degrees() if degrees is None else degrees
        return degrees.get(self._class_key(sess), sess.plan_degree)

    def _group_key(self, sess: _Session, degrees: dict | None = None
                   ) -> tuple:
        """Sessions sharing a group share one tick program: capacity
        class + scheduled degree (the layout's shapes depend only on the
        capacities; a panel-sharded layout is a row CSR too, with no
        chunk statics to key on)."""
        key = (self._class_key(sess), self._session_degree(sess, degrees))
        sess.group_key = key
        return key

    def _get_step(self, key: tuple, occupancy: int) -> program.TickProgram:
        prog = self._compiled.get((key, occupancy))
        if prog is None:
            schedule = program.StepSchedule(
                method=self.cfg.method, degree=key[1],
                steps=self.cfg.steps_per_tick, backend=self._backend)
            prog = program.build_tick_program(
                schedule, self.device, mesh=self._mesh,
                edge_axes=self.cfg.edge_axes, model_axes=self._model_axes)
            self._compiled[(key, occupancy)] = prog
        return prog

    @property
    def compile_count(self) -> int:
        """Tick programs built: one per (capacity class, degree) x pow2
        occupancy bucket, so the count stays logarithmic in fleet size.
        On the card each captures its CUDA graphs once, at its first
        call, so this is also the capture count (edge- and panel-sharded
        programs capture none).  The scheduler's
        multipliers, per-session c and lr, updates and membership
        changes add none."""
        return len(self._compiled)

    @property
    def layout_fills(self) -> int:
        """Group layouts filled so far (all programs): one per invocation
        whose slots' stores or c differ from its program's last call, as
        after an update, a re-plan, a change of membership, or between two
        sub-batches of one occupancy in a tick."""
        return sum(p.layout_fills for p in self._compiled.values())

    @property
    def tick_invocations(self) -> int:
        """Tick-program invocations so far (all groups)."""
        return self._tick_invocations

    @property
    def device_work(self) -> int:
        """Accumulated device work in session-slot solver steps
        (occupancy x steps per invocation); converged sessions add
        none."""
        return self._device_work

    @property
    def multiplied_ticks(self) -> int:
        """Invocations the residual-decay scheduler stretched past one
        plain tick."""
        return self._multiplied_ticks

    def _tick_multipliers(self, members: list[_Session]) -> np.ndarray:
        """Residual-decay scheduling: PER-SESSION steps multipliers.  A
        member forecast to stay above tolerance for more than
        ``eval_payoff`` plain ticks stretches to ``min(predicted plain
        ticks, max_tick_multiplier)``; a member near convergence (or with
        no usable forecast yet) keeps 1."""
        cfg = self.cfg
        mults = np.ones(len(members), np.int64)
        if (cfg.tick_schedule != "residual_decay"
                or cfg.max_tick_multiplier <= 1):
            return mults
        for i, m in enumerate(members):
            if m.rate is None or not (0.0 < m.rate < 1.0):
                continue
            need = program.predicted_steps_to_tol(m.residual, m.rate,
                                                  cfg.tol)
            if need <= cfg.eval_payoff * cfg.steps_per_tick:
                continue
            mult = max(1, min(need // cfg.steps_per_tick,
                              cfg.max_tick_multiplier))
            if m.residual <= cfg.stretch_residual_floor * cfg.tol:
                mult = min(mult, 4)  # endgame cap (see config)
            mults[i] = mult
        return mults

    def tick(self) -> dict[str, float]:
        """Advance every unconverged session one scheduled tick - one
        program invocation per (capacity class, degree) group, or two
        when the scheduler sub-batches plain members away from stretched
        ones.  Converged sessions are not grouped at all."""
        cfg = self.cfg
        degrees = self._class_degrees()
        groups: dict[tuple, list[_Session]] = defaultdict(list)
        for sess in self._sessions.values():
            if not sess.converged:
                groups[self._group_key(sess, degrees)].append(sess)
        out: dict[str, float] = {}
        for gkey, g_members in groups.items():
            deg = gkey[1]
            g_mults = self._tick_multipliers(g_members)
            for members, mults in _split_by_multiplier(g_members, g_mults):
                # occupancy follows the ACTIVE member count, pow2-padded
                # with replicas of the first member (own rows, outputs
                # dropped)
                occ = _next_pow2(len(members))
                max_mult = int(mults.max())
                step = self._get_step(gkey, occ)
                idx = list(range(len(members))) + [0] * (occ - len(members))
                slots = [members[i] for i in idx]
                vs, res = step(
                    [self._tick_rows(s.store) for s in slots],
                    [program.dilation_scale(s.plan, deg) for s in slots],
                    torch.stack([s.v for s in slots]),
                    [s.lr for s in slots], mults[np.asarray(idx)])
                self._tick_invocations += 1
                # every slot rides the longest member's chunk budget
                self._device_work += occ * cfg.steps_per_tick * max_mult
                if max_mult > 1:
                    self._multiplied_ticks += 1
                res = res.cpu().numpy()
                for i, sess in enumerate(members):
                    prev = sess.residual
                    sess.v = vs[i]
                    sess.residual = float(res[i])
                    # decay over the member's OWN executed step count; a
                    # non-contracting observation resets the forecast
                    sess.rate = program.contraction_rate(
                        prev, sess.residual,
                        cfg.steps_per_tick * int(mults[i]))
                    sess.ticks += 1
                    out[sess.sid] = sess.residual
                    if sess.residual <= cfg.tol:
                        sess.converged = True
                        sess.est = updates.anchor_estimate(
                            self._fused(sess.store), sess.v)
        return out

    @property
    def all_converged(self) -> bool:
        return all(s.converged for s in self._sessions.values())

    def run_until_converged(self, max_ticks: int = 500) -> int:
        """Tick until every session converges; returns ticks used (check
        `all_converged` afterwards: the budget may run out first)."""
        used = 0
        while not self.all_converged and used < max_ticks:
            self.tick()
            used += 1
        return used

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def _residual(self, sess: _Session) -> float:
        """Panel residual under the session's dilated operator, one eager
        application over the store's fused step (its cached row CSR)."""
        deg = self._session_degree(sess)
        op = operators.dilated_step_operator(
            self._fused(sess.store), program.dilation_scale(sess.plan, deg),
            deg)
        return float(metrics.operator_residual(op, sess.v))

    def live_edges(self, sid: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight) of the session's live edges, numpy."""
        st = self._get(sid).store
        w = st.weight.cpu().numpy()
        live = w != 0
        return (st.src.cpu().numpy()[live], st.dst.cpu().numpy()[live],
                w[live])

    def panel(self, sid: str) -> torch.Tensor:
        """The session's live eigenvector panel (real rows only): a view
        of the session's current panel tensor, not a copy.  No code path
        of the service writes into a panel tensor it has handed out (a
        tick, an update or a re-solve binds the session to a new
        tensor), but the view stops being the session's panel after the
        next tick or update; a reader that must keep one state, as the
        serving layer's committed versions do, clones it."""
        sess = self._get(sid)
        return sess.v[: sess.n]

    def labels(self, sid: str) -> np.ndarray:
        """Current cluster assignment with STABLE ids (tracking.py)."""
        cfg = self.cfg
        sess = self._get(sid)
        raw = panel_labels(
            sess.v[: sess.n], sess.num_clusters,
            drop_trivial=cfg.drop_trivial, seed=cfg.seed,
            kmeans_restarts=cfg.kmeans_restarts)
        return sess.tracker.update(torch.from_numpy(raw)).cpu().numpy()

    def capacity_class(self, sid: str) -> tuple[int, int]:
        """(node capacity, edge capacity) of the session's class."""
        return self._class_key(self._get(sid))

    def session_info(self, sid: str) -> dict:
        return self._summary(self._get(sid))

    def _summary(self, sess: _Session) -> dict:
        return {
            "n": sess.n,
            "node_capacity": sess.store.num_nodes,
            "edge_capacity": sess.store.capacity,
            "num_edges": int(gs.num_edges(sess.store)),
            "converged": sess.converged,
            "residual": sess.residual,
            "rho": sess.rho,
            "rho_ub": sess.rho_ub,
            "tau": sess.tau,
            "family": sess.plan.family,
            "degree": self._session_degree(sess),
            "lr": sess.lr,
            "rate": sess.rate,
            "ticks": sess.ticks,
            "solves": sess.solves,
            "incremental_updates": sess.incremental_updates,
            "fallbacks": sess.fallbacks,
        }
