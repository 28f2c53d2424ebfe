"""The port's partition rules and cell report against the JAX package's,
on the CPU with no ranks.

Meshes are abstract on both sides: ``jax.sharding.AbstractMesh`` (built
without devices) and the port's ``launch.mesh.AbstractMesh``, at
(1, 1), (2, 2), the pod (16, 16) and the multi-pod (2, 16, 16).  The JAX
package's shapes come from ``jax.eval_shape`` of ``model.init`` and
``init_caches``; the port's from meta tensors (``dryrun.meta_model``,
stacked by ``shardings.stacked_param_shapes`` / ``stacked_cache_shapes``).
Every spec is held to the JAX package's ``PartitionSpec`` entry for
entry, for all ten full-size archs, and ``run_cell``'s argument bytes
exactly, as integers, to a numpy reckoning from the JAX package's own
spec trees and shapes.  ``repro.launch.dryrun`` is imported only inside
the one test that reads its skip record, after JAX's backend is up, with
``XLA_FLAGS`` restored (its import asks for 512 host devices).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jcfg
from repro.launch import shardings as jshr
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import sharding as jsharding
from repro.models.frontends import frontend_spec as jfrontend_spec
from repro.train import optimizer as jopt
from repro_torch import configs as tcfg
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as shr
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding

ARCHS = sorted(jcfg.ARCHS)
SHAPES = sorted(jcfg.SHAPES)
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}
PRODUCTION = ("pod", "multipod")


def _meshes(name):
    sizes, names = MESHES[name]
    return JMesh(sizes, names), tmesh.AbstractMesh(sizes, names)


def _is_spec(x):
    return isinstance(x, P)


def _flat_specs(tree) -> dict:
    """{path: spec entries} of a JAX spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)
    return {jax.tree_util.keystr(path): tuple(spec) for path, spec in leaves}


def _flat_port(tree, prefix="") -> dict:
    """{path: spec} of the port's nested-dict spec tree, keyed as
    ``jax.tree_util.keystr`` keys a dict tree."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_flat_port(v, key))
        else:
            out[key] = tuple(v) if isinstance(v, tuple) else v
    return out


@pytest.fixture(scope="module")
def jax_params():
    return {a: jax.eval_shape(functools.partial(jmodel.init, cfg=jcfg.get_arch(a)),
                              jax.random.PRNGKey(0)) for a in ARCHS}


@pytest.fixture(scope="module")
def port_params():
    return {a: shr.stacked_param_shapes(dryrun.meta_model(tcfg.get_arch(a)))
            for a in ARCHS}


@pytest.fixture(scope="module")
def jax_caches():
    out = {}
    for a in ARCHS:
        cfg = jcfg.get_arch(a)
        for name in SHAPES:
            sh = jcfg.SHAPES[name]
            if sh["kind"] == "decode" and jcfg.shape_applicable(cfg, name):
                out[a, name] = jax.eval_shape(functools.partial(
                    jmodel.init_caches, cfg, sh["global_batch"], sh["seq_len"]))
    return out


# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------

LOGICAL_CASES = [("dp",), ("tp",), ("sp",), (None,), ("dp", None, "tp"),
                 ("dp", "sp", None, None), ("data",), ("model", "dp"),
                 ("pod",), ("unknown",), ()]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolve_spec_and_shardable_match(mesh_name):
    jm, tm = _meshes(mesh_name)
    with jax.sharding.use_abstract_mesh(jm):
        want = [tuple(jsharding.resolve_spec(*c)) for c in LOGICAL_CASES]
        want_sh = {(d, ax): jsharding.shardable(d, ax)
                   for d in (1, 2, 3, 6, 16, 48, 256, 512, 1000)
                   for ax in ("dp", "tp", "sp", "data", "model", "pod",
                              "unknown")}
    with sharding.set_mesh(tm):
        got = [sharding.resolve_spec(*c) for c in LOGICAL_CASES]
        got_sh = {key: sharding.shardable(*key) for key in want_sh}
    assert got == want
    assert got_sh == want_sh
    assert sharding.current_mesh() is None


def test_no_mesh_resolves_to_nothing():
    assert tuple(jsharding.resolve_spec("dp", "tp")) == sharding.resolve_spec(
        "dp", "tp") == ()
    assert jsharding.shardable(16, "tp") is sharding.shardable(16, "tp") is False


@pytest.mark.parametrize("batch", [1, 2, 3, 6, 24, 48, 100, 128, 256, 512])
def test_dispatch_groups_halve_as_the_reference(batch):
    for name in MESHES:
        jm, tm = _meshes(name)
        with jax.sharding.use_abstract_mesh(jm):
            want = jmoe._num_groups(batch)
        assert tmoe._num_groups(batch, tm) == want, name
    assert tmoe._num_groups(batch, None) == 1


def test_production_meshes():
    for mp, name in ((False, "pod"), (True, "multipod")):
        m = tmesh.make_production_mesh(multi_pod=mp)
        sizes, names = MESHES[name]
        assert (m.axis_sizes, m.axis_names) == (sizes, names)
        assert m.shape == dict(zip(names, sizes))
        assert sharding.mesh_shape(m) == m.shape
        assert m.size == math.prod(sizes)


# ---------------------------------------------------------------------------
# parameter, moment, batch and cache rules
# ---------------------------------------------------------------------------

def _shapes(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): tuple(l.shape) for p, l in leaves}


def _port_shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}[{k!r}]"
        out.update(_port_shapes(v, key) if isinstance(v, dict)
                   else {key: tuple(v.shape)})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_param_shapes_match(arch, jax_params, port_params):
    assert _port_shapes(port_params[arch]) == _shapes(jax_params[arch])
    assert all(t.device.type == "meta" for t in shr._leaves(port_params[arch]))


@pytest.mark.parametrize("mesh_name", PRODUCTION + ("2x2",))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_match(arch, mesh_name, jax_params,
                                      port_params):
    jm, tm = _meshes(mesh_name)
    cfg_j, cfg_t = jcfg.get_arch(arch), tcfg.get_arch(arch)
    for fsdp in (None, True, False):
        want = jshr.param_specs(cfg_j, jax_params[arch], jm, fsdp=fsdp)
        got = shr.param_specs(cfg_t, port_params[arch], tm, fsdp=fsdp)
        assert _flat_port(got) == _flat_specs(want), fsdp
        want_m = jshr.moment_specs(want, jax_params[arch], jm)
        got_m = shr.moment_specs(got, port_params[arch], tm)
        assert _flat_port(got_m) == _flat_specs(want_m), fsdp


@pytest.mark.parametrize("mesh_name", PRODUCTION)
def test_mamba2_moments_split_the_layer_axis(mesh_name, jax_params,
                                             port_params):
    """mamba2-2.7b's 64 layers divide by the dp extent (16, or 32 on the
    multi-pod), its parameters are not FSDP-sharded, so every moment of a
    stacked leaf is split by layers, not by width."""
    jm, tm = _meshes(mesh_name)
    arch = "mamba2-2.7b"
    specs = shr.param_specs(tcfg.get_arch(arch), port_params[arch], tm)
    moments = shr.moment_specs(specs, port_params[arch], tm)
    dp = "data" if mesh_name == "pod" else ("pod", "data")
    assert tuple(port_params[arch]["layers"]["pre_norm"]["scale"].shape) == (
        64, 2560)
    assert specs["layers"]["pre_norm"]["scale"] == (None, None)
    assert moments["layers"]["pre_norm"]["scale"] == (dp, None)
    assert moments["layers"]["ssm"]["w_zx"][0] == dp
    want = jshr.moment_specs(jshr.param_specs(
        jcfg.get_arch(arch), jax_params[arch], jm), jax_params[arch], jm)
    assert tuple(want["layers"]["pre_norm"]["scale"]) == (dp, None)


def _jax_batch(cfg, kind, b, s):
    sds = jax.ShapeDtypeStruct
    if kind == "decode":
        return {"tokens": sds((b, 1), jnp.int32)}
    out = {"tokens": sds((b, s), jnp.int32), "labels": sds((b, s), jnp.int32)}
    for name, (shape, dtype) in jfrontend_spec(cfg, b).items():
        out[name] = sds(shape, dtype)
    if kind == "prefill":
        out.pop("labels")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match(arch):
    for shape in SHAPES:
        sh = jcfg.SHAPES[shape]
        want_tree = _jax_batch(jcfg.get_arch(arch), sh["kind"],
                               sh["global_batch"], sh["seq_len"])
        got_tree, kind = dryrun.input_specs(tcfg.get_arch(arch), shape)
        assert kind == sh["kind"]
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got_tree.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want_tree.items()}
        for name in PRODUCTION:
            jm, tm = _meshes(name)
            want = jshr.batch_specs(jm, want_tree)
            got = shr.batch_specs(tm, got_tree)
            assert {k: got[k] for k in want} == {
                k: tuple(v) for k, v in want.items()}


def _cache_fields(node):
    if node is None:
        return None
    if isinstance(node, tuple) and not hasattr(node, "_fields"):
        return [tuple(x) if isinstance(x, P) else tuple(x.shape) for x in node]
    return {f: getattr(node, f) for f in node._fields}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_and_specs_match(arch, jax_caches):
    cfg_j, cfg_t = jcfg.get_arch(arch), tcfg.get_arch(arch)
    for (a, shape), jstate in jax_caches.items():
        if a != arch:
            continue
        sh = jcfg.SHAPES[shape]
        state = shr.stacked_cache_shapes(dryrun.cache_shapes(
            cfg_t, sh["global_batch"], sh["seq_len"]))
        for field in ("caches", "cross_kv", "attn_caches"):
            jnode, tnode = getattr(jstate, field), getattr(state, field)
            assert (jnode is None) == (tnode is None), field
            if jnode is None:
                continue
            for name in jnode._fields:
                jl, tl = getattr(jnode, name), getattr(tnode, name)
                if jl is None:
                    assert tl is None, (field, name)
                    continue
                assert tuple(tl.shape) == tuple(jl.shape), (field, name)
                assert str(tl.dtype).split(".")[-1] == str(jl.dtype), name
        for mesh_name in PRODUCTION + ("2x2",):
            jm, tm = _meshes(mesh_name)
            want = jshr.cache_specs(cfg_j, jm, jstate)
            got = shr.cache_specs(cfg_t, tm, state)
            for field in ("caches", "cross_kv", "attn_caches"):
                jnode, tnode = getattr(want, field), getattr(got, field)
                if jnode is None:
                    assert tnode is None
                    continue
                for name in jnode._fields:
                    js = getattr(jnode, name)
                    assert getattr(tnode, name) == (
                        None if js is None else tuple(js)), (mesh_name, name)


def test_cache_specs_of_cross_kv_match():
    """whisper's cross K/V (the JAX package's cache_specs takes a bare
    (k, v) tuple; ``init_caches`` leaves it None)."""
    cfg_j, cfg_t = (jcfg.get_arch("whisper-small"),
                    tcfg.get_arch("whisper-small"))
    shape = (12, 128, 1500, 12, 64)
    jstate = jmodel.ServeState(caches=None, cross_kv=tuple(
        jax.ShapeDtypeStruct(shape, jnp.bfloat16) for _ in range(2)),
        attn_caches=None)
    tstate = dryrun.meta_model(cfg_t).init_caches(1, 8)._replace(
        caches=[], cross_kv=[(torch.empty(shape[1:], device="meta"),) * 2] * 12)
    stacked = shr.stacked_cache_shapes(tstate)
    assert tuple(stacked.cross_kv[0].shape) == shape
    for name in PRODUCTION:
        jm, tm = _meshes(name)
        want = jshr.cache_specs(cfg_j, jm, jstate)
        got = shr.cache_specs(cfg_t, tm, stacked)
        assert got.cross_kv == tuple(tuple(s) for s in want.cross_kv)


def test_local_shape():
    _, tm = _meshes("multipod")
    assert shr.local_shape((64, 2560), (("pod", "data"), None), tm) == (2, 2560)
    assert shr.local_shape((48, 1024, 512), ("model", None), tm) == (
        3, 1024, 512)
    with pytest.raises(ValueError):
        shr.local_shape((24,), ("model",), tm)


# ---------------------------------------------------------------------------
# the cell report: argument bytes to a reckoning from the JAX package's specs
# ---------------------------------------------------------------------------

def _leaf_bytes(spec, leaf, sizes) -> int:
    entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
    local = 1
    for size, e in zip(leaf.shape, entries):
        ext = 1
        for a in ((e,) if isinstance(e, str) else (e or ())):
            ext *= sizes[a]
        assert size % ext == 0
        local *= size // ext
    return local * np.dtype(leaf.dtype).itemsize


def _tree_bytes(specs, shapes, sizes) -> int:
    return sum(jax.tree.leaves(jax.tree.map(
        lambda s, l: _leaf_bytes(s, l, sizes), specs, shapes,
        is_leaf=_is_spec)))


def _jax_reckoning(arch, shape, jax_params, jax_caches, mesh_name="pod",
                   opt_cfg=None) -> dict:
    cfg = jcfg.get_arch(arch)
    jm, _ = _meshes(mesh_name)
    sizes = dict(zip(jm.axis_names, jm.axis_sizes))
    sh = jcfg.SHAPES[shape]
    kind, b, s = sh["kind"], sh["global_batch"], sh["seq_len"]
    params = jax_params[arch]
    if kind != "train":
        params = jax.tree.map(lambda l: jax.ShapeDtypeStruct(
            l.shape, jnp.bfloat16), params)
        p_specs = jshr.param_specs(cfg, params, jm, fsdp=False)
    else:
        p_specs = jshr.param_specs(cfg, params, jm)
    batch = _jax_batch(cfg, kind, b, s)
    out = {"params_bytes": _tree_bytes(p_specs, params, sizes),
           "batch_bytes": _tree_bytes(jshr.batch_specs(jm, batch), batch,
                                      sizes),
           "optimizer_bytes": 0, "cache_bytes": 0}
    if kind == "train":
        opt_cfg = opt_cfg or jopt.OptConfig()
        state = jax.eval_shape(functools.partial(jopt.init, opt_cfg), params)
        m_specs = jshr.moment_specs(p_specs, params, jm)
        specs = jopt.OptState(step=P(), mu=m_specs, nu=m_specs,
                              error=None if state.error is None else p_specs)
        out["optimizer_bytes"] = _tree_bytes(specs, state, sizes)
    elif kind == "decode":
        caches = jax_caches[arch, shape]
        out["cache_bytes"] = _tree_bytes(jshr.cache_specs(cfg, jm, caches),
                                         caches, sizes)
    out["argument_bytes"] = sum(out.values())
    return out


CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if jcfg.shape_applicable(jcfg.get_arch(a), s)]
SKIPPED = [(a, s) for a in ARCHS for s in SHAPES
           if not jcfg.shape_applicable(jcfg.get_arch(a), s)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_argument_bytes_exact(arch, shape, jax_params, jax_caches):
    rec = dryrun.run_cell(arch, shape, False, budget_bytes=80 * 10 ** 9)
    want = _jax_reckoning(arch, shape, jax_params, jax_caches)
    got = {k: rec["memory"][k] for k in want}
    assert got == want
    assert rec["status"] == "ok" and rec["mesh"] == "pod"
    assert rec["devices"] == 256 and rec["kind"] == jcfg.SHAPES[shape]["kind"]
    cfg = jcfg.get_arch(arch)
    assert rec["params"] == cfg.param_count()
    assert rec["active_params"] == cfg.active_param_count()
    assert rec["remat"] == cfg.remat_policy
    assert rec["memory"]["fits"] == (want["argument_bytes"] <= 80 * 10 ** 9)
    assert rec["flops"] is None and rec["collectives"] is None


@pytest.mark.parametrize("arch,shape,overrides", [
    ("mamba2-2.7b", "train_4k", None),
    ("deepseek-v2-236b", "train_4k", {"moment_dtype": "bfloat16"}),
    ("granite-moe-1b-a400m", "train_4k", {"compress_grads": True}),
    ("zamba2-1.2b", "long_500k", None),
])
def test_run_cell_multipod_and_options(arch, shape, overrides, jax_params):
    jc = jcfg.get_arch(arch)
    caches = {}
    sh = jcfg.SHAPES[shape]
    if sh["kind"] == "decode":
        caches[arch, shape] = jax.eval_shape(functools.partial(
            jmodel.init_caches, jc, sh["global_batch"], sh["seq_len"]))
    rec = dryrun.run_cell(arch, shape, True, opt_overrides=overrides,
                          budget_bytes=1)
    want = _jax_reckoning(arch, shape, jax_params, caches, "multipod",
                          jopt.OptConfig(**(overrides or {})))
    assert {k: rec["memory"][k] for k in want} == want
    assert rec["devices"] == 512 and rec["memory"]["fits"] is False


def test_skipped_records_match(monkeypatch):
    jax.devices()  # the backend is up: the import below cannot change it
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    from repro.launch import dryrun as jdryrun

    for arch, shape in SKIPPED:
        for mp in (False, True):
            assert dryrun.run_cell(arch, shape, mp) == jdryrun.run_cell(
                arch, shape, mp)
