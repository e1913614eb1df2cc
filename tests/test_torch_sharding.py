"""The port's sharding rules (``repro_torch.distributed.sharding``) and
parameter templates (``model_zoo.template``/``axes``) against the
reference's ``repro.distributed.sharding``, without devices.

For every config, at full size and reduced, and for the meshes (1,1),
(2,4), (4,2), (8,1) and (16,16): the parameter and ZeRO-1 specs
(``specs_for_template`` with ``param_rules``/``zero_rules`` and
``_rules_for_cfg``, as ``param_shardings`` and ``train_state_shardings``
build them) equal the reference's, each reference spec mapped onto the
port's parameter name and layout through ``convert.model_params_from_numpy``
(a stand-in tree whose leaves carry their index and dims of sizes 2, 3, 5:
the port tensor's values name the reference leaf, its shape the
permutation); ``batch_shardings`` of a decoder's, a ``vision_stub``'s and an
encoder's batch at B = 1, 2, 6, 8, 32; ``decode_shardings`` of the cache at
batch 1, 2 and 32. The reference side runs on ``jax.sharding.AbstractMesh``.
Rules that send two dims of a matrix to one mesh axis give it to the first
dim in the reference's order, also where the port stores the matrix
transposed. On meshes of sizes without process groups, ``Sharding.local``
cuts the block a tiled ``device_put`` places on each position (block i of
``prod(sizes)`` along the dim, the first axis of a tuple major).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ALL_ARCHS
from repro.configs import get_config as ref_config
from repro.distributed import sharding as rsh
from repro.models import model_zoo as rz
from repro.models.common import Leaf as RefLeaf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import SOLO, Axis
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import ModelMesh
from repro_torch.models import model_zoo as pz
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainConfig

MESHES = [(1, 1), (2, 4), (4, 2), (8, 1), (16, 16)]
DECODERS = [a for a in ALL_ARCHS if not get_config(a).is_encoder]  # an encoder has no cache
SIZES = (2, 3, 5, 7)


def _meshes(shape):
    ref = AbstractMesh(shape, ("data", "model"))
    port = ModelMesh((("data", Axis(None, shape[0], 0)), ("model", Axis(None, shape[1], 0))))
    return ref, port


def _cfgs(arch, reduced):
    rc, pc = ref_config(arch), get_config(arch)
    return (rc.reduced(), pc.reduced()) if reduced else (rc, pc)


_MAPS: dict = {}


def _is_leaf(x) -> bool:
    return isinstance(x, RefLeaf)


def _ref_to_port(arch, reduced):
    """{port name: (reference leaf index, stacked, permutation)} through ``convert``:
    a stand-in reference tree whose leaf k holds the value k in dims of
    sizes 2, 3, 5 (after a stacked leaf's layer axis)."""
    key = (arch, reduced)
    if key not in _MAPS:
        rcfg, pcfg = _cfgs(arch, reduced)
        flat, treedef = jax.tree.flatten(rz.template(rcfg), is_leaf=_is_leaf)
        fake, dims_of = [], []
        for k, leaf in enumerate(flat):
            stacked = leaf.axes[:1] == ("layers",)
            dims = SIZES[:len(leaf.axes) - stacked]
            fake.append(np.full(((leaf.shape[0],) if stacked else ()) + dims, float(k),
                                np.float32))
            dims_of.append((stacked, dims))
        sd = convert.model_params_from_numpy(pcfg, jax.tree.unflatten(treedef, fake),
                                             dtype=torch.float32)
        out = {}
        for name, t in sd.items():
            k = int(t.flatten()[0])
            stacked, dims = dims_of[k]
            out[name] = (k, stacked, tuple(dims.index(s) for s in t.shape))
        _MAPS[key] = (out, flat)
    return _MAPS[key]


def _ref_specs(flat_specs, mapping):
    """The reference's spec tree (flattened in template order) on the port's names."""
    out = {}
    for name, (k, stacked, perm) in mapping.items():
        spec = tuple(flat_specs[k])
        spec = spec + (None,) * (len(perm) + stacked - len(spec))
        if stacked:
            assert spec[0] is None, name  # "layers" never takes a mesh axis
            spec = spec[1:]
        out[name] = tuple(spec[d] for d in perm)
    return out


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_template_axes_match_reference(arch, reduced):
    """``model_zoo.template`` names every port parameter once, with the
    reference leaf's shape and axes (layer axis dropped), and ``axes``
    permutes them to the port's layout."""
    rcfg, pcfg = _cfgs(arch, reduced)
    mapping, flat = _ref_to_port(arch, reduced)
    tmpl = pz.template(pcfg)
    assert set(tmpl) == set(mapping)
    port_axes = pz.axes(pcfg)
    for name, leaf in tmpl.items():
        k, stacked, perm = mapping[name]
        ref_leaf = flat[k]
        assert leaf.axes == ref_leaf.axes[stacked:], name
        assert leaf.shape == tuple(ref_leaf.shape[stacked:]), name
        assert leaf.perm == perm, name
        assert port_axes[name] == tuple(leaf.axes[d] for d in perm)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_zero_specs_match_reference(arch, reduced):
    rcfg, pcfg = _cfgs(arch, reduced)
    mapping, _ = _ref_to_port(arch, reduced)
    tmpl_r, tmpl_p = rz.template(rcfg), pz.template(pcfg)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for shape in MESHES:
        rmesh, pmesh = _meshes(shape)
        for rules in ("param_rules", "zero_rules"):
            rr = rsh._rules_for_cfg(rcfg, getattr(rsh, rules)(rmesh))
            pr = psh._rules_for_cfg(pcfg, getattr(psh, rules)(pmesh))
            assert rr == pr
            want = _ref_specs(jax.tree.leaves(rsh.specs_for_template(tmpl_r, rr, rmesh),
                                              is_leaf=is_p), mapping)
            got = psh.specs_for_template(tmpl_p, pr, pmesh)
            assert set(got) == set(want)
            for name in want:
                assert tuple(got[name]) == want[name], (shape, rules, name)
        # the state's shardings: params by the parameter rules, moments by ZeRO or not
        for zero in (True, False):
            for comp in (False, True):
                tcfg = TrainConfig(opt=OptConfig(zero_sharding=zero), grad_compression=comp)
                sh = psh.train_state_shardings(pcfg, pmesh, tcfg)
                rules = psh.zero_rules if zero else psh.param_rules
                m = psh.specs_for_template(tmpl_p, psh._rules_for_cfg(pcfg, rules(pmesh)),
                                           pmesh)
                assert {n: s.spec for n, s in sh["opt"]["m"].items()} == m
                assert {n: s.spec for n, s in sh["opt"]["v"].items()} == m
                assert ("err" in sh) == comp
                assert sh["opt"]["step"].spec == () and sh["router_state"].spec == ()
        ps = psh.param_shardings(pcfg, pmesh)
        assert {n: s.spec for n, s in ps.items()} == psh.specs_for_template(
            tmpl_p, psh._rules_for_cfg(pcfg, psh.param_rules(pmesh)), pmesh)


@pytest.mark.parametrize("arch", ["stablelm_3b", "mamba2_1_3b", "granite_moe_1b"])
def test_one_mesh_axis_for_two_dims_goes_to_the_reference_order_first(arch):
    """Rules that send both dims of a matrix to "data": the first dim in the
    reference's (in, out) order takes it, also where the port stores the
    matrix transposed (built in the port's order, the other dim would)."""
    rcfg, pcfg = _cfgs(arch, True)
    mapping, _ = _ref_to_port(arch, True)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    rmesh, pmesh = _meshes((4, 2))
    rules = dict(rsh.param_rules(rmesh), embed="data", ff="data", heads="data", kv="data",
                 vocab="data")
    want = _ref_specs(jax.tree.leaves(rsh.specs_for_template(rz.template(rcfg), rules, rmesh),
                                      is_leaf=is_p), mapping)
    got = psh.specs_for_template(pz.template(pcfg), rules, pmesh)
    assert {n: tuple(s) for n, s in got.items()} == want
    assert any(leaf.perm == (1, 0) and tuple(got[n]) == (None, "data")
               for n, leaf in pz.template(pcfg).items())


def _batch(cfg, B, S=16):
    if cfg.is_encoder:
        return {"embeddings": (B, S, cfg.d_model), "labels": (B, S)}
    if cfg.frontend == "vision_stub":
        return {"patches": (B, 4, cfg.d_model), "tokens": (B, S - 4), "labels": (B, S)}
    return {"tokens": (B, S), "labels": (B, S)}


@pytest.mark.parametrize("arch", ["stablelm_3b", "internvl2_1b", "hubert_xlarge"])
def test_batch_shardings_match_reference(arch):
    cfg = get_config(arch)
    for shape in MESHES:
        rmesh, pmesh = _meshes(shape)
        for B in (1, 2, 6, 8, 32):
            shapes = _batch(cfg, B)
            want = rsh.batch_shardings(
                {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}, rmesh)
            got = psh.batch_shardings({k: torch.empty(s, device="meta")
                                       for k, s in shapes.items()}, pmesh)
            assert {k: tuple(v.spec) for k, v in want.items()} == {
                k: tuple(v.spec) for k, v in got.items()}, (shape, B)
            assert psh._batch_dim_spec(pmesh, B) == rsh._batch_dim_spec(rmesh, B)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_shardings_match_reference(arch, reduced):
    rcfg, pcfg = _cfgs(arch, reduced)
    for shape in MESHES:
        rmesh, pmesh = _meshes(shape)
        for batch in (1, 2, 32):
            rcache = rz.cache_spec(rcfg, batch, 64)
            pcache = pz.cache_spec(pcfg, batch, 64)
            assert {k: tuple(v.shape) for k, v in rcache.items()} == {
                k: tuple(v[0]) for k, v in pcache.items()}
            want = rsh.decode_shardings(rcfg, rcache, rmesh, batch)
            got = psh.decode_shardings(pcfg, pcache, pmesh, batch)
            assert {k: tuple(v.spec) for k, v in want.items()} == {
                k: tuple(v.spec) for k, v in got.items()}, (shape, batch)


def test_pod_axis_batch_rule():
    """A "pod" axis (no mesh of the port has one yet) joins "data" in the
    batch axes, as in the reference."""
    rmesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    pmesh = ModelMesh((("pod", Axis(None, 2, 0)), ("data", Axis(None, 4, 0)),
                       ("model", Axis(None, 2, 0))))
    assert psh.batch_axes(pmesh) == rsh.batch_axes(rmesh) == ("pod", "data")
    for B in (1, 2, 4, 6, 8, 16):
        assert psh._batch_dim_spec(pmesh, B) == rsh._batch_dim_spec(rmesh, B)


@pytest.mark.parametrize("spec", [("data", None), (None, "data"), (("data", "model"), None),
                                  ("model", "data"), (None, None)])
def test_local_cuts_the_tiled_block(spec):
    """``local`` on every position of a 4x2 mesh cuts the block a tiled
    ``device_put`` places there (the first axis of a tuple major); the
    blocks of the positions that differ along the cut axes tile the tensor."""
    t = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    blocks = set()
    for i in range(4):
        for j in range(2):
            mesh = ModelMesh((("data", Axis(None, 4, i)), ("model", Axis(None, 2, j))))
            blk = psh.Sharding(mesh, psh.PartitionSpec(*spec)).local(t)
            want = t
            for d, e in enumerate(spec):
                n, idx = 1, 0
                for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
                    size, pos = {"data": (4, i), "model": (2, j)}[a]
                    n, idx = n * size, idx * size + pos
                k = t.shape[d] // n
                want = want.narrow(d, idx * k, k)
            assert torch.equal(blk, want)
            blocks.add(tuple(blk.flatten().tolist()))
    assert sum(len(b) for b in blocks) == t.numel()
    # a one-rank mesh holds the whole tensor, and gathers nothing
    one = psh.Sharding(ModelMesh((("data", SOLO), ("model", SOLO))), psh.PartitionSpec(*spec))
    assert one.replicated and one.local(t) is t and one.gather(t) is t
