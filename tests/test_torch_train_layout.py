"""The training layout alone (``launch.shardings.train_layout``), on meta
tensors: every arch of the registry at full size on the (2, 2), (2, 1)
and production (16, 16) ``AbstractMesh`` es, at every coordinate.  The
partition rules themselves are held to the JAX package's in
tests/test_torch_lm_shardings.py; here each rank's slices are held to
those rules: their shapes to ``shardings.local_shape`` of
``param_specs``, their bytes to ``dryrun.reckon``'s ``params_bytes``,
and the coordinates' slices tile each tensor ``replicas`` times over.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.launch import dryrun, shardings
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import moe
from repro_torch.models.model import computes_sliced

MESHES = {"2x2": (2, 2), "2x1": (2, 1), "16x16": (16, 16)}


def _mesh(name):
    return AbstractMesh(MESHES[name], ("data", "model"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_slices_are_the_specs_at_every_coordinate(arch, mesh_name):
    cfg = get_arch(arch)
    mesh = _mesh(mesh_name)
    lay = shardings.train_layout(cfg, mesh, index=(0, 0))
    shapes = shardings.stacked_param_shapes(dryrun.meta_model(cfg))
    specs = shardings.param_specs(cfg, shapes, mesh)
    assert lay.fsdp == shardings.fsdp_default(shapes, mesh)
    # each stacked leaf's local shape, as meta tensors unstacked by name
    local = convert.lm_named_from_tree(shardings._map_dict(
        lambda path, t: torch.empty(shardings.local_shape(
            t.shape, _spec(specs, path), mesh), device="meta"), shapes))
    for name in lay.splits:
        assert tuple(n for _, n in lay.bounds(name)) == tuple(
            local[name].shape), name
    want_bytes = dryrun.reckon(cfg, "train", 16, 128, mesh)["params_bytes"]
    dp, tp = MESHES[mesh_name]
    seen = {name: {} for name in lay.splits}
    for d in range(dp):
        for t in range(tp):
            total = 0
            for name in lay.splits:
                b = lay.bounds(name, (d, t))
                total += math.prod(n for _, n in b) * 4
                seen[name][b] = seen[name].get(b, 0) + 1
            assert total == want_bytes, (d, t)
    for name, sp in lay.splits.items():
        # the distinct slices tile the tensor, each held by `replicas` ranks
        assert set(seen[name].values()) == {lay.replicas(name)}, name
        assert sum(math.prod(n for _, n in b) for b in seen[name]) == \
            math.prod(sp.shape), name


def _spec(specs, path):
    for k in path:
        specs = specs[k]
    return specs


@pytest.mark.parametrize("arch, mesh_name, fsdp", [
    ("granite-moe-1b-a400m", "2x1", True),
    ("qwen3-4b", "2x2", True),
    ("granite-moe-1b-a400m", "16x16", False),
])
def test_fsdp_none_follows_the_threshold(arch, mesh_name, fsdp):
    lay = shardings.train_layout(get_arch(arch), _mesh(mesh_name),
                                 index=(0, 0))
    assert lay.fsdp is fsdp
    data_split = any(sp.data is not None for sp in lay.splits.values())
    assert data_split is fsdp


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-236b",
                                  "mamba2-2.7b", "whisper-small"])
def test_sliced_compute_where_the_heads_divide(arch):
    """On (16, 16): attention computes on its heads only where they
    divide by 16 (deepseek-v2's MLA: 128 heads; not qwen3-4b's 8 KV heads
    nor whisper's 12), the MLP and the vocabulary always, the Mamba2
    mixer on its heads (mamba2-2.7b's 80)."""
    cfg = get_arch(arch)
    lay = shardings.train_layout(cfg, _mesh("16x16"), index=(0, 0))
    for name, sp in lay.splits.items():
        if sp.model is None:
            continue
        assert sp.sliced == computes_sliced(cfg, name, 16), name
        if ".ssm." in name:
            assert sp.sliced, name
        if name.endswith("table") or ".mlp." in name:
            assert sp.sliced, name
        if ".attn." in name or ".cross." in name:
            assert sp.sliced == (arch == "deepseek-v2-236b"), name


@pytest.mark.parametrize("arch, overrides, tp, sliced", [
    ("mamba2-2.7b", None, 2, True),  # 16 smoke heads
    ("zamba2-1.2b", None, 2, True),
    ("mamba2-2.7b", {"ssm_expand": 3, "ssm_headdim": 128}, 2, False),  # 3
    ("mamba2-2.7b", None, 3, False),
])
def test_ssm_computes_sliced_where_its_heads_divide(arch, overrides, tp,
                                                    sliced):
    """The Mamba2 mixer's four split leaves compute on the rank's heads
    where the heads divide by the model extent, else in the gather form;
    its replicated leaves are never split, whatever ``computes_sliced``
    says of them."""
    cfg = dataclasses.replace(smoke_config(get_arch(arch)),
                              **(overrides or {}))
    prefix = "ssm_layers.0.ssm" if cfg.family == "hybrid" else "layers.0.ssm"
    for leaf in ("w_zx", "conv_w_x", "conv_b_x", "w_out"):
        assert computes_sliced(cfg, f"{prefix}.{leaf}", tp) is sliced, leaf
    if tp == 2:
        lay = shardings.train_layout(cfg, _mesh("2x2"), fsdp=False,
                                     index=(0, 1))
        split = {k.rsplit(".", 1)[1] for k, sp in lay.splits.items()
                 if ".ssm." in k and sp.model is not None}
        assert split == {"w_zx", "conv_w_x", "conv_b_x", "w_out"}
        assert all(sp.sliced is sliced for k, sp in lay.splits.items()
                   if ".ssm." in k and sp.model is not None)


def test_moe_slices_where_experts_divide():
    cfg = get_arch("deepseek-v2-236b")
    assert computes_sliced(cfg, "layers.0.moe.w_up", 16) == \
        moe.expert_sharded(cfg, 16)
    assert not computes_sliced(cfg, "layers.0.moe.w_up", 3)


def test_layout_bytes_of_qwen3_full_depth_on_2x2():
    """The card's full-depth build (chip_smoke's lm_train_tp): qwen3-4b on
    the (2, 2) mesh with fsdp=None, a quarter of each FSDP'd parameter a
    rank."""
    cfg = get_arch("qwen3-4b")
    mesh = _mesh("2x2")
    lay = shardings.train_layout(cfg, mesh, index=(1, 1))
    whole = sum(p.numel() * 4 for p in dryrun.meta_model(cfg).parameters())
    got = sum(math.prod(n for _, n in lay.bounds(k)) * 4 for k in lay.splits)
    assert got == dryrun.reckon(cfg, "train", 4, 1024, mesh)["params_bytes"]
    assert whole / 4 <= got < whole / 3
