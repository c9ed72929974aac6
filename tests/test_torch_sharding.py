"""The port's logical sharding rules against the JAX package's
(``repro/distributed/sharding.py``), specs only: nothing is drawn.

For every registry arch at its published width, on abstract (2, 4),
(16, 16) and (2, 16, 16) meshes (``jax.sharding.AbstractMesh`` against the
port's :class:`~repro_torch.distributed.sharding.AbstractMesh`):

- each parameter's spec, its ZeRO-1 spec and its per-device shape equal
  JAX's ``logical_to_spec`` / ``zero1_shardings`` /
  ``NamedSharding.shard_shape``.  The port keeps a list of layers where
  JAX stacks a period's layers, so port layer ``l`` is JAX's stacked
  tensor's slice ``l // period`` (its spec less the leading ``layers``
  entry, which no rule shards) or its unrolled tail layer;
- ``input_shardings`` of the cell's batch specs equal JAX's;
- ``axes_tree`` equals JAX's (less ``layers``) and ``count_params`` JAX's.

The :class:`Sharding` placements and ``constrain`` are checked on their
own; ``param_bytes_per_device`` against the sum of the shard shapes.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import make_batch_specs as j_batch_specs  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.layers.param import axes_tree as j_axes_tree  # noqa: E402
from repro.layers.param import count_params as j_count  # noqa: E402
from repro.layers.param import is_spec as j_is_spec  # noqa: E402
from repro.models.lm import _period_split  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.data.pipeline import make_batch_specs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.layers.param import axes_tree, count_params  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return JMesh(sizes, names), shd.AbstractMesh(sizes, names)


def _jax_leaf(jspec, cfg, path):
    """The JAX ParamSpec behind the port's tensor at ``path`` and whether
    it is stacked (a leading ``layers`` dim the port's tensor lacks)."""
    if path[0] == "encoder":
        if path[1] == "norm":
            node, rest, stacked = jspec["encoder"]["norm"], path[2:], False
        else:
            node = jspec["encoder"]["blocks"]["pos0"]
            rest, stacked = path[3:], True
    elif path[0] == "layers":
        n_scan, period, _ = _period_split(cfg)
        layer = path[1]
        if layer < n_scan * len(period):
            node = jspec["scan"][f"pos{layer % len(period)}"]
            stacked = True
        else:
            node = jspec["tail"][f"layer{layer - n_scan * len(period)}"]
            stacked = False
        rest = path[2:]
    else:
        node, rest, stacked = jspec[path[0]], path[1:], False
    for k in rest:
        node = node[k]
    return node, stacked


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _port_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _port_leaves(t, path + (i,))
    else:
        yield path, tree


def _unstack(spec, stacked):
    if stacked:
        assert spec[0] is None            # "layers" is never sharded
        return spec[1:]
    return spec


def _pad(spec, rank):
    return tuple(spec) + (None,) * (rank - len(tuple(spec)))


_SPECS = {}


def _specs(arch):
    """(port spec tree, JAX spec tree, JAX cfg), built once a process."""
    if arch not in _SPECS:
        jcfg = jget(arch)
        _SPECS[arch] = (build_model(get_config(arch), device="meta").spec(),
                        jbuild(jcfg).spec(), jcfg)
    return _SPECS[arch]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    tspec, jspec, jcfg = _specs(arch)
    pshard = shd.param_shardings(tmesh, tspec)
    zshard = shd.zero1_shardings(tmesh, tspec)
    j_zero = jshd.zero1_shardings(jmesh, jspec)
    n = 0
    for (path, s), (_, ps), (_, zs) in zip(_port_leaves(tspec),
                                           _port_leaves(pshard),
                                           _port_leaves(zshard)):
        js, stacked = _jax_leaf(jspec, jcfg, path)
        want = _unstack(_pad(jshd.logical_to_spec(jmesh, js.shape, js.axes),
                             len(js.shape)), stacked)
        assert _pad(ps.spec, len(s.shape)) == want, (path, ps.spec, want)
        jz, _ = _jax_leaf(j_zero, jcfg, path)
        zwant = _pad(tuple(jz.spec), len(js.shape))
        if stacked:
            # ZeRO-1 may put the data axes on the stacked dim, which the
            # port's per-layer tensor lacks: compare where JAX did not
            if zwant[0] is None:
                assert _pad(zs.spec, len(s.shape)) == zwant[1:], path
        else:
            assert _pad(zs.spec, len(s.shape)) == zwant, path
        jshape = NamedSharding(jmesh, jshd.logical_to_spec(
            jmesh, js.shape, js.axes)).shard_shape(js.shape)
        assert ps.shard_shape(s.shape) == tuple(jshape[1:] if stacked
                                                else jshape), path
        n += 1
    # as many port tensors as JAX's, each stacked one once a layer
    assert n == sum(
        math.prod(leaf.shape[:1]) if leaf.axes[:1] == ("layers",) else 1
        for leaf in jax.tree.leaves(jspec, is_leaf=j_is_spec))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_shardings_match_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = jget(arch), get_config(arch)
    for shape in SHAPES:
        jb = j_batch_specs(jcfg, J_SHAPES[shape])
        tb = make_batch_specs(tcfg, SHAPES[shape])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tb.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
        assert all(v.device.type == "meta" for v in tb.values())
        js = jshd.input_shardings(jmesh, jb)
        ts = shd.input_shardings(tmesh, tb)
        for k in jb:
            assert _pad(ts[k].spec, tb[k].ndim) == \
                _pad(tuple(js[k].spec), tb[k].ndim), (k, shape)
            assert ts[k].shard_shape(tb[k].shape) == \
                tuple(js[k].shard_shape(jb[k].shape))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_axes_tree_and_count_match_jax(arch):
    tspec, jspec, jcfg = _specs(arch)
    assert count_params(tspec) == j_count(jspec)
    for path, ax in _port_leaves(axes_tree(tspec)):
        js, stacked = _jax_leaf(jspec, jcfg, path)
        want = js.axes[1:] if stacked else js.axes
        if stacked:
            assert js.axes[0] == "layers"
        assert tuple(ax) == tuple(want), path
    assert len(jax.tree.leaves(j_axes_tree(jspec),
                               is_leaf=lambda a: isinstance(a, tuple))) \
        == len(jax.tree.leaves(jspec, is_leaf=j_is_spec))


def test_paligemma_kv1_replicated_vocab_mlp_sharded():
    """JAX's ``test_logical_rules_drop_indivisible`` on the port's specs:
    kv = 1 tensors replicate on a 4-way model axis, vocab and mlp shard."""
    tmesh = shd.AbstractMesh((2, 4), ("data", "model"))
    sh = shd.param_shardings(tmesh, _specs("paligemma-3b")[0])
    assert "model" in sh["embed"]["table"].spec
    assert "model" in sh["layers"][0]["ffn"]["w_up"]["w"].spec
    assert "model" not in sh["layers"][0]["attn"]["wk"]["w"].spec


def test_placements_shard_shape_and_bytes():
    from torch.distributed.tensor import Replicate, Shard
    m3 = make_production_mesh(multi_pod=True)
    s = shd.Sharding(m3, (("pod", "data"), None, "model"))
    assert s.placements == [Shard(0), Shard(0), Shard(2)]
    assert s.shard_shape((64, 3, 32)) == (2, 3, 2)
    assert shd.Sharding(m3, (None,)).placements == [Replicate()] * 3
    with pytest.raises(ValueError):
        s.shard_shape((63, 3, 32))
    tspec = _specs("deepseek-7b")[0]
    m = make_production_mesh()
    total = sum(math.prod(sh.shard_shape(sp.shape)) * sp.dtype.itemsize
                for (_, sp), (_, sh) in zip(
                    _port_leaves(tspec),
                    _port_leaves(shd.param_shardings(m, tspec))))
    assert shd.param_bytes_per_device(m, tspec) == total
    assert total < count_params(tspec) * 2 / 8      # vocab / mlp / heads


def test_constrain_checks_rank_and_names():
    m = shd.AbstractMesh((2, 4), ("data", "model"))
    x = torch.zeros(3, 5)
    assert shd.constrain(x, m, "q_chunks", "batch") is x
    assert shd.constrain(x, None, "anything") is x
    assert shd.constrain(x, m, "batch") is x
    with pytest.raises(ValueError):
        shd.constrain(x, m, "batch", None, None)
    with pytest.raises(ValueError):
        shd.constrain(x, m, "batch", "no_such_axis")
    assert shd.act_spec(m, "q_chunks", "batch") == ("model", "data")
    assert shd.act_spec(m, "batch", None, "kv_heads", None) == \
        tuple(jshd.act_spec(JMesh((2, 4), ("data", "model")),
                            "batch", None, "kv_heads", None))
    assert np.array_equal(
        shd.shard_batch(m, {"tokens": torch.arange(8).reshape(4, 2)})
        ["tokens"].numpy(), np.array([[0, 1], [2, 3]]))
