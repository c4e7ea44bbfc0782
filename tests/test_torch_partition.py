"""The port's partition specs (``repro_torch.parallel.partition``) against
the JAX package's, entry for entry.

All ten architectures at their full configs, under ``tp_fsdp``,
``fsdp_only``, ``dp_fsdp`` and ``tp_fsdp`` with ``seq_shard``, on the
meshes 16 x 16, 2 x 16 x 16, (1, 1) and (4, 2): every parameter's spec,
every activation kind at a batch that divides the data axes and at ones
that do not, the batch specs of every shape cell and the cache specs over
each arch's abstract decode cache. The reference runs on a ``FakeMesh``
(names and sizes, as ``tests/test_system.py`` builds one) with its
``NamedSharding`` replaced by the bare spec, since no 256-device mesh
exists here; the port builds its own logical mesh. A spec is compared as
the tuple of its entries (a one-name tuple is the name in both).
"""
import math

import pytest
import torch

import repro.parallel.partition as jpart
from repro.configs import get_config as jget_config
from repro.launch.specs import input_specs as jinput_specs
from repro.models.transformer import abstract_cache as jabstract_cache
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import _mesh, make_mesh_for_devices
from repro_torch.launch.specs import SHAPES, input_specs
from repro_torch.models import abstract_cache, abstract_params
from repro_torch.models.init import flatten_tree
from repro_torch.parallel.partition import (
    NamedSharding,
    P,
    ShardingStrategy,
    place_tree,
)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
STRATEGIES = {
    "tp_fsdp": dict(strategy="tp_fsdp"),
    "fsdp_only": dict(strategy="fsdp_only"),
    "dp_fsdp": dict(strategy="dp_fsdp"),
    "seq_shard": dict(strategy="tp_fsdp", seq_shard=True),
}
KINDS = ("act", "partial_out", "logits", "heads4d", "kv4d", "other")
BATCHES = (256, 3, None)  # divides every mesh's data axes, none, unset


def _fake_mesh(name):
    sizes, axes = MESHES[name]
    mesh = type("FakeMesh", (), {})()
    mesh.axis_names, mesh.shape = axes, dict(zip(axes, sizes))
    return mesh


def _entries(spec):
    return None if spec is None else tuple(spec)


@pytest.fixture
def bare_jax_specs(monkeypatch):
    """The reference's batch and cache specs as bare ``PartitionSpec``s."""
    monkeypatch.setattr(jpart, "NamedSharding", lambda mesh, spec: spec)


def _jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def _jax_named(tree):
    """{path: spec entries} of a JAX tree of specs, paths named as the
    reference's ``cache_specs`` names them."""
    import jax

    pairs, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(spec) for path, spec in pairs}


def _port_specs(tree):
    return [s.spec if isinstance(s, NamedSharding) else s
            for _, s in flatten_tree(tree)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch, strategy, mesh, bare_jax_specs):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    kw = STRATEGIES[strategy]
    port_mesh = _mesh(*MESHES[mesh])
    for batch in BATCHES:
        js = jpart.ShardingStrategy(jcfg, _fake_mesh(mesh), batch_size=batch,
                                    **kw)
        ts = ShardingStrategy(tcfg, port_mesh, batch_size=batch, **kw)
        assert ts.rules == js.rules
        if batch == BATCHES[0]:
            want = dict(_flat_dict(js.param_specs()))
            got = dict(_flat_dict(ts.param_specs()))
            assert got.keys() == want.keys()
            for path, spec in want.items():
                assert tuple(got[path]) == tuple(spec), path
        for kind in KINDS:
            for ndim in (3, 4):
                assert (_entries(ts.act_spec(kind, ndim))
                        == _entries(js.act_spec(kind, ndim))), (kind, batch)
    # batch specs of every cell, cache specs of the decode cells
    for shape, info in SHAPES.items():
        js = jpart.ShardingStrategy(jcfg, _fake_mesh(mesh),
                                    batch_size=info["batch"], **kw)
        ts = ShardingStrategy(tcfg, port_mesh, batch_size=info["batch"], **kw)
        jin, tin = jinput_specs(jcfg, shape), input_specs(tcfg, shape)
        if info["kind"] == "decode":
            jin, tin = jin["batch"], tin["batch"]
        want = [tuple(s) for s in _jax_leaves(js.batch_specs(jin))]
        assert [tuple(s) for s in _port_specs(ts.batch_specs(tin))] == want
    for b, s in ((128, 32768), (1, 4096)):
        want = _jax_named(js.cache_specs(jabstract_cache(jcfg, b, s), b))
        got = {"/".join(map(str, p)): tuple(sh.spec) for p, sh
               in flatten_tree(ts.cache_specs(abstract_cache(tcfg, b, s), b))}
        # the port's RWKV cache counts its tokens on the host, where the
        # reference's has no length at all: a scalar, replicated
        if tcfg.rwkv is not None:
            assert got.pop("rwkv/len") == ()
        assert got == want, (b, s)


def _flat_dict(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_dict(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_sharding_rules_specs():
    """``tests/test_system.py::test_sharding_rules_specs`` on the port."""

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}

    cfg = get_config("qwen1-5-110b")
    strat = ShardingStrategy(cfg, FakeMesh(), batch_size=256)
    specs = strat.param_specs()
    assert specs["embed"] == P("model", "data")
    assert specs["layers"]["blk0_attn"]["w1"] == P(None, "data", "model")
    assert specs["layers"]["blk0_attn"]["wo"] == P(None, "model", None)
    # llava: 56 heads not divisible by 16 -> heads4d constraint replicates
    cfg2 = get_config("llava-next-34b")
    strat2 = ShardingStrategy(cfg2, FakeMesh(), batch_size=256)
    assert strat2.act_spec("heads4d", 4) == P(("data",), None, None, None)
    assert strat2.act_spec("kv4d", 4) == P(("data",), None, None, None)
    # but flat projections still TP-shard (stacked over layers)
    assert strat2.param_specs()["layers"]["blk0_attn"]["wq"] == P(
        None, "data", "model"
    )


def test_spec_quirks_kept():
    """The reference's quirks, kept: dp_fsdp's embed rule is the (data,
    model) pair, a mesh axis is used once per spec (the first use wins)
    and a non-dividing dimension falls back to replication."""
    mesh = _mesh((16, 16), ("data", "model"))
    cfg7 = get_config("deepseek-7b")
    dp = ShardingStrategy(cfg7, mesh, strategy="dp_fsdp", batch_size=256)
    assert dp.rules["embed"] == ("data", "model")
    assert dp.rules["vocab"] is None  # no tensor parallelism
    assert dp.param_specs()["embed"] == P(None, ("data", "model"))
    tp = ShardingStrategy(cfg7, mesh, batch_size=256)
    assert tp._spec_for_axes(("heads", "kv"), (4096, 4096)) == P("model",
                                                                 None)
    assert tp._spec_for_axes(("heads",), (40,)) == P(None)


def test_shard_shape_and_placement():
    big = _mesh((16, 16), ("data", "model"))
    sh = NamedSharding(big, P("model", ("data",), None))
    assert sh.shard_shape((64, 32, 5)) == (4, 2, 5)
    assert sh.num_devices == 256
    with pytest.raises(ValueError, match="does not split"):
        sh.shard_shape((64, 31, 5))
    t = torch.zeros(64, 32, 5)
    with pytest.raises(ValueError, match="runs on one card"):
        sh.place(t)
    one = make_mesh_for_devices(1)
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    assert NamedSharding(one, P("data", "model")).place(t) is t
    # every leaf of a full config placed on a one-device mesh, none copied
    cfg = get_config("deepseek-7b")
    params = abstract_params(cfg)
    strat = ShardingStrategy(cfg, one, batch_size=8)
    placed = place_tree(params, strat.param_shardings())
    assert all(a is b for (_, a), (_, b)
               in zip(flatten_tree(params), flatten_tree(placed)))
    assert strat.make_constrain()(t, "act") is t
    with pytest.raises(ValueError, match="one card"):
        ShardingStrategy(cfg, big, batch_size=8).make_constrain()
    with pytest.raises(ValueError, match="runs on one card"):
        place_tree(params, ShardingStrategy(cfg, big).param_shardings())


def test_per_device_shard_shapes():
    """Each parameter's shard under tp_fsdp on 16 x 16 has its global
    shape divided by the mesh axes of its spec."""
    mesh = _mesh((16, 16), ("data", "model"))
    cfg = get_config("qwen1-5-110b")
    strat = ShardingStrategy(cfg, mesh, batch_size=256)
    params = dict((p, t) for p, t in flatten_tree(abstract_params(cfg)))
    for path, sh in flatten_tree(strat.param_shardings()):
        shape = tuple(params[path].shape)
        shard = sh.shard_shape(shape)
        div = [math.prod(mesh.shape[a] for a in (
            () if e is None else (e,) if isinstance(e, str) else e))
            for e in list(sh.spec) + [None] * (len(shape) - len(sh.spec))]
        assert shard == tuple(d // k for d, k in zip(shape, div)), path
    emb = strat.param_shardings()["embed"].shard_shape(params[("embed",)].shape)
    assert emb == (cfg.vocab // 16, cfg.d_model // 16)
