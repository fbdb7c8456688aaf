"""The sharding rules of ``repro_torch.distributed.sharding`` against
``repro.distributed.sharding``, leaf for leaf: param specs of the twelve
registry configs at full width (the reference's shapes from
``jax.eval_shape``, the port's from ``launch.specs`` meta params), cache
and batch specs of every admitted (arch, input shape) pair, the activation
rules and data axes, on duck-typed meshes at (16, 16), (2, 16, 16), (2, 4),
(4, 1) and (1, 1); the per-device argument bytes of the dry-run's 16x16 and
2x16x16 rows against the same count from the reference's specs; and the
DTensor placements of a spec.  Each rank's block at (2, 2) against
``NamedSharding`` is in ``test_torch_distributed.py``, where the ranks run."""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget
from repro.distributed import sharding as jshd
from repro.launch import specs as JS
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 list_configs, shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                         "model")),
          ((2, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 1), ("data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
PAIRS = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES
         if shape_applicable(get_config(a), INPUT_SHAPES[s])[0]]


class FakeMesh:
    """Just enough of a jax Mesh for the reference's spec construction."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def meshes(i):
    shape, names = MESHES[i]
    return FakeMesh(shape, names), shd.MeshSpec(names, shape)


def _key(path) -> str:
    """A jax key path as ``io.flatten`` keys the port's leaf."""
    return "|".join(f"k:{p.key}" if hasattr(p, "key") else f"i:{p.idx}"
                    for p in path)


def ref_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {_key(path): tuple(spec) for path, spec in flat}


@functools.lru_cache(maxsize=None)
def ref_params(name):
    return JS.abstract_params(jget(name))


@functools.lru_cache(maxsize=None)
def port_params(name):
    return S.abstract_params(get_config(name))


@functools.lru_cache(maxsize=None)
def inputs(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    jcfg = JS.resolved_config(jget(arch), shape)
    cfg = S.resolved_config(get_config(arch), shape)
    return (jcfg, JS.input_specs(jcfg, shape)), (cfg, S.input_specs(cfg,
                                                                    shape))


def test_registry_is_the_references():
    assert len(list_configs()) == 12
    assert sorted(list_configs()) == sorted(
        __import__("repro.configs", fromlist=["x"]).list_configs())


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("name", sorted(list_configs()))
def test_param_specs_match_reference(name, mesh):
    jmesh, tmesh = meshes(mesh)
    want = ref_flat(jshd.param_specs(jmesh, ref_params(name)))
    got = shd.param_specs(tmesh, port_params(name))
    assert got == want


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_cache_and_batch_specs_match_reference(arch, shape):
    """Decode: the caches' specs (long_500k's b = 1 spreads the sequence
    over (data, model)) and the token's; train and prefill: the batch's
    (positions_3d on axis 1)."""
    (jcfg, jin), (_, tin) = inputs(arch, shape)
    b = INPUT_SHAPES[shape].global_batch
    for i in range(len(MESHES)):
        jmesh, tmesh = meshes(i)
        if "caches" in jin:
            want = ref_flat(jshd.cache_specs(jmesh, jin["caches"]))
            assert shd.cache_specs(tmesh, tin["caches"]) == want
            da = jshd.data_axes(jmesh)
            assert shd.batch_specs(tmesh, {"token": tin["token"]}) == {
                "token": tuple(P(jshd._fit(jmesh, b, da), None))}
        else:
            want = {k: tuple(v) for k, v in
                    jshd.batch_specs(jmesh, jin["batch"]).items()}
            assert shd.batch_specs(tmesh, tin["batch"]) == want


@pytest.mark.parametrize("mesh", [0, 1], ids=MESH_IDS[:2])
def test_batch_one_caches_spread_the_sequence(mesh):
    """b = 1: an MLA latent's sequence, and a K/V leaf's whose heads
    divide over model, spread over the data axes and model; a K/V leaf
    whose heads do not divide keeps its sequence on model (the reference's
    rules, on synthetic leaves)."""
    import torch
    jmesh, tmesh = meshes(mesh)
    shapes = {"c_kv": (2, 1, 4096, 64), "k_rope": (2, 1, 4096, 32),
              "k": (2, 1, 1, 4096, 128), "v": (2, 1, 16, 4096, 128),
              "conv": (2, 1, 3, 64), "ssm": (2, 1, 32, 16, 64)}
    jtree = {"0": {k: jax.ShapeDtypeStruct(s, np.float32)
                   for k, s in shapes.items()}}
    ttree = {"0": {k: torch.empty(s, device="meta")
                   for k, s in shapes.items()}}
    got = shd.cache_specs(tmesh, ttree)
    assert got == ref_flat(jshd.cache_specs(jmesh, jtree))
    da = shd.data_axes(tmesh)
    assert got["k:0|k:c_kv"][2] == shd._with_model(da)
    assert got["k:0|k:k"][3] == "model"
    assert got["k:0|k:v"][2:4] == (None, shd._with_model(da))


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_activation_rules_and_data_axes_match_reference(mesh):
    jmesh, tmesh = meshes(mesh)
    assert shd.activation_rules(tmesh) == jshd.activation_rules(jmesh)
    assert shd.data_axes(tmesh) == jshd.data_axes(jmesh)
    for axes in (None, "data", "model", ("data", "model")):
        assert shd.axis_size(tmesh, axes) == jshd.axis_size(jmesh, axes)


def _ref_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree.leaves(tree)
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(flat)
    total = 0
    for leaf, spec in zip(leaves, flat, strict=True):
        split = int(np.prod([jshd.axis_size(mesh, e) for e in spec]))
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // split
    return total


def reference_argument_bytes(arch, shape_name, jmesh) -> int:
    """What one device holds of the step's arguments under the reference's
    specs: params, AdamW state (train), batch or token and caches."""
    shape = INPUT_SHAPES[shape_name]
    (jcfg, jin), _ = inputs(arch, shape_name)
    params = JS.abstract_params(jcfg)
    pspecs = jshd.param_specs(jmesh, params)
    total = _ref_bytes(params, pspecs, jmesh)
    if shape.mode == "train":
        opt = JS.abstract_opt_state(params)
        total += (_ref_bytes(opt.mu, pspecs, jmesh)
                  + _ref_bytes(opt.nu, pspecs, jmesh)
                  + opt.step.dtype.itemsize)
    if "caches" in jin:
        da = jshd.data_axes(jmesh)
        total += _ref_bytes(jin["token"], P(jshd._fit(
            jmesh, shape.global_batch, da), None), jmesh)
        total += _ref_bytes(jin["caches"], jshd.cache_specs(
            jmesh, jin["caches"]), jmesh)
    else:
        total += _ref_bytes(jin["batch"], jshd.batch_specs(
            jmesh, jin["batch"]), jmesh)
    return total


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_mesh_rows_carry_the_specs_argument_bytes(arch, shape):
    for mesh, i, n in (("16x16", 0, 256), ("2x16x16", 1, 512)):
        row = D.plan(arch, shape, mesh=mesh)
        assert row["status"] == "ok" and row["mesh"] == mesh
        assert row["num_devices"] == n
        assert row["memory_analysis"]["argument_size_in_bytes"] == \
            reference_argument_bytes(arch, shape, meshes(i)[0])


def test_mesh_row_fields_are_the_references():
    """The reference's field names, per-device counts below the one-card
    plan's, and collectives only where a mesh has them."""
    one = D.plan("internlm2-1.8b", "train_4k")
    row = D.plan("internlm2-1.8b", "train_4k", mesh="16x16")
    assert set(row) == set(one)
    assert set(row["collectives"]) == {"bytes_per_op", "total_bytes",
                                       "op_counts"}
    assert set(row["collectives"]["bytes_per_op"]) == {
        "all-gather", "reduce-scatter", "all-reduce"}
    assert row["collectives"]["total_bytes"] > 0
    assert one["collectives"]["total_bytes"] == 0
    assert row["hlo_flops_per_device"] < one["hlo_flops_per_device"]
    assert row["roofline"]["collective_s"] > 0
    prefill = D.plan("internlm2-1.8b", "prefill_32k", mesh="2x16x16")
    assert "reduce-scatter" not in prefill["collectives"]["bytes_per_op"]


def test_unit_mesh_row_is_the_one_card_plan():
    """On a (1, 1) mesh nothing is split: the per-device FLOPs and bytes
    are the one-card plan's and there are no collectives."""
    from repro_torch.launch import step_cost as C
    for arch, shape_name in (("internlm2-1.8b", "train_4k"),
                             ("gemma2-2b", "decode_32k")):
        shape = INPUT_SHAPES[shape_name]
        cfg = S.resolved_config(get_config(arch), shape)
        params = S.abstract_params(cfg)
        ins = S.input_specs(cfg, shape)
        ana = C.analyze_mesh(cfg, shape, shd.MeshSpec(("data", "model"),
                                                      (1, 1)), params, ins)
        one = D.plan(arch, shape_name)
        assert ana["flops"] == one["hlo_flops_per_device"]
        assert ana["hbm_bytes"] == one["hlo_hbm_bytes_per_device"]
        assert ana["collective_total_bytes"] == 0.0
        assert ana["num_devices"] == 1


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shd.MeshSpec(("data", "model"), (2, 2))
    assert shd.placements(mesh, ("data", None)) == [Shard(0), Replicate()]
    assert shd.placements(mesh, (None, "model")) == [Replicate(), Shard(1)]
    assert shd.placements(mesh, (None, ("data", "model"))) == [Shard(1),
                                                               Shard(1)]
    assert shd.placements(mesh, (None, None)) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements(mesh, (("model", "data"),))
    with pytest.raises(ValueError, match="twice"):
        shd.placements(mesh, ("data", "data"))


def test_local_block_of_an_axis_tuple():
    """A dim over ("pod", "data") is cut pod-major, as NamedSharding cuts
    it: the device at (pod 1, data 0) holds the third of four blocks."""
    mesh = shd.MeshSpec(("pod", "data", "model"), (2, 2, 2))
    assert shd.local_block(mesh, (("pod", "data"), "model"), (8, 4),
                           (1, 0, 1)) == (slice(4, 6), slice(2, 4))
    assert shd.local_block(mesh, (None,), (8,), (1, 1, 1)) == (slice(0, 8),)
    assert shd.split(mesh, (("pod", "data"), "model")) == 8
