"""The port's sharding rules (``repro_torch.distributed.sharding``), the
models' ``spec_*`` functions, ``opt_state_specs`` and ``launch.mesh``
against the reference's, in this process (no process group).

* The spec trees of ``spec_lm``/``spec_encoder`` and ``opt_state_specs``
  (AdamW and Adafactor) equal the reference's, ``PartitionSpec`` read as a
  tuple, for every configuration in ``ARCH_NAMES``; each leaf of a port
  model (``param_leaves``) carries its reference leaf's spec.
* The reference's sanitizer tests (``tests/test_distributed.py``'s
  fallbacks, ``tests/test_distributed_properties.py``'s property with the
  same example count), on the reference tests' fake mesh (axes as a
  mapping) and on one shaped like a ``DeviceMesh`` (named dimensions, a
  tuple shape), each example also equal to the reference's answer.
* ``named``'s placements, and its refusal of a layout no DTensor has;
  ``batch_spec``, ``translate_specs``, ``sanitize_tree`` and ``use_mesh``
  as the reference's; no mesh, no constraint.
* ``mesh_for_devices``/``make_production_mesh`` raise without a process
  group.

The multi-rank behaviour (real meshes, DTensors) is in
``test_torch_distributed.py`` and ``test_torch_elastic.py``.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.distributed import sharding as jsh
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import spec_encoder as jax_spec_encoder
from repro.models.lm import spec_lm as jax_spec_lm
from repro.optim import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.distributed.sharding import (
    DP_AXES, P, batch_spec, constrain, constrain_tree, get_dp_axes, get_drop_axes, get_mesh,
    named, sanitize_spec, sanitize_tree, translate_specs, use_mesh)
from repro_torch.launch.mesh import make_production_mesh, mesh_for_devices
from repro_torch.models.lm import init_lm, param_leaves, spec_encoder, spec_lm
from repro_torch.optim import opt_state_specs


class _FakeMesh:
    """The reference tests' fake mesh: axis -> size."""

    def __init__(self, shape):
        self.shape = shape


class _NamedMesh:
    """Shaped like a ``DeviceMesh``: named dimensions and a tuple shape."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def _as_tuples(tree):
    """A reference spec tree with each ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, PartitionSpec))


def _is_spec(s) -> bool:
    return isinstance(s, PartitionSpec)


def test_arch_names_are_the_references():
    assert ARCH_NAMES == JAX_ARCH_NAMES


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_trees_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    got, want = spec_lm(cfg), _as_tuples(jax_spec_lm(jcfg))
    assert got == want
    assert all(isinstance(s, P) for s in jax.tree.leaves(got, is_leaf=lambda s: isinstance(s, P)))
    if cfg.is_encdec:
        assert spec_encoder(cfg) == _as_tuples(jax_spec_encoder(jcfg))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_specs_are_the_references(arch, optimizer):
    """The port's per-leaf lists against the reference's trees flattened up
    to the parameter leaves (the port's ``OptState`` layout)."""
    jcfg = jax_config(arch)
    pspec = jax_spec_lm(jcfg)
    shapes = jax.eval_shape(lambda: jax_init_lm(jax.random.PRNGKey(0), jcfg))
    want = jax_opt_state_specs(pspec, shapes, optimizer)
    specs, tdef = jax.tree.flatten(pspec, is_leaf=_is_spec)
    leaf_shapes = [tuple(s.shape) for s in jax.tree.leaves(shapes)]
    got = opt_state_specs([P(*s) for s in specs], leaf_shapes, optimizer)
    assert got.step == tuple(want.step) == ()
    assert got.mu == [tuple(s) for s in tdef.flatten_up_to(want.mu)]
    assert got.nu == [_as_tuples(v) for v in tdef.flatten_up_to(want.nu)]
    if optimizer == "adafactor":
        assert any(isinstance(v, dict) for v in got.nu)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_each_leaf_carries_its_reference_spec(arch):
    cfg = get_smoke_config(arch)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.leaves(_as_tuples(jax_spec_lm(jax_smoke(arch))),
                           is_leaf=lambda s: isinstance(s, tuple))
    assert [lf.spec for lf in param_leaves(model)] == want


# ---------------------------------------------------------------------------
# the reference's sanitizer tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_cls", [_FakeMesh, _NamedMesh])
def test_sanitize_drops_non_dividing_axes(mesh_cls):
    mesh = mesh_cls({"data": 16, "model": 16})
    # batch=1 cannot shard over data -> replicated
    assert sanitize_spec(P(("pod", "data"), None), (1, 128), mesh) == P(None, None)
    # 'pod' absent on single-pod mesh -> silently dropped
    assert sanitize_spec(P(("pod", "data"), None), (32, 128), mesh) == P("data", None)
    # divisible dims keep their axes, missing trailing dims pad with None
    assert sanitize_spec(P("model"), (32, 64, 7), mesh) == P("model", None, None)
    assert sanitize_spec(P(None, "model"), (3, 48), mesh) == P(None, "model")
    assert sanitize_spec(P("model"), (4,), None) == P()


@given(
    dims=st.lists(st.integers(1, 64), min_size=1, max_size=4),
    axes=st.lists(st.sampled_from([None, "data", "model", ("pod", "data")]),
                  min_size=1, max_size=4),
    named_dims=st.booleans(),
)
@settings(max_examples=100, deadline=None)
def test_sanitize_never_produces_invalid_spec(dims, axes, named_dims):
    shape = {"data": 4, "model": 2}
    mesh = (_NamedMesh if named_dims else _FakeMesh)(shape)
    spec = sanitize_spec(P(*axes[: len(dims)]), tuple(dims), mesh)
    for size, ax in zip(dims, list(spec)):
        if ax is None:
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            assert a in shape
            n *= shape[a]
        assert size % n == 0
    want = jsh.sanitize_spec(PartitionSpec(*axes[: len(dims)]), tuple(dims), _FakeMesh(shape))
    assert spec == tuple(want)


# ---------------------------------------------------------------------------
# placements and the other rules
# ---------------------------------------------------------------------------

def test_named_gives_one_placement_per_mesh_dimension():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _NamedMesh({"pod": 2, "data": 4, "model": 2})
    assert named(P("data", "model", None), (8, 4, 3), mesh) == (Replicate(), Shard(0), Shard(1))
    assert named(P(("pod", "data"), None), (16, 4), mesh) == (Shard(0), Shard(0), Replicate())
    # batch=4 over ('pod','data')=8 degrades to 'pod'; 'model' misses 3
    assert named(P(("pod", "data"), "model"), (4, 3), mesh) == (Shard(0), Replicate(),
                                                                Replicate())
    assert named(P("data"), (4,), None) is None


def test_named_refuses_a_layout_no_dtensor_has():
    mesh = _NamedMesh({"data": 4, "model": 2})
    with pytest.raises(ValueError, match="mesh's axis order"):
        named(P(("model", "data")), (8,), mesh)
    with pytest.raises(ValueError, match="two dimensions"):
        named(P("data", "data"), (8, 8), mesh)
    with pytest.raises(ValueError, match="named dimensions"):
        named(P("data"), (8,), type("Unnamed", (), {"shape": (4,)})())


def test_batch_spec_follows_the_policy():
    assert batch_spec(None) == P(DP_AXES, None) == tuple(jsh.batch_spec(None))
    mesh = _NamedMesh({"data": 4, "model": 2})
    with use_mesh(mesh, dp_axes=("data", "model"), drop_axes={"model"}):
        assert get_mesh() is mesh and get_drop_axes() == frozenset({"model"})
        spec = batch_spec(None, "model")
        assert spec == P(("data", "model"), None, "model")
        with use_mesh(None):
            assert get_mesh() is None and get_dp_axes() == DP_AXES
        assert get_dp_axes() == ("data", "model")
        from torch.distributed.tensor import Shard

        assert named(batch_spec(None), (8, 3), mesh) == (Shard(0), Shard(0))
        assert named(spec, (4, 3, 2), mesh) == (Shard(0), Shard(2))  # 'model' left dim 0
    assert get_mesh() is None and get_dp_axes() == DP_AXES and get_drop_axes() == frozenset()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_translate_specs_and_sanitize_tree_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for drop in (("model",), ("data", "pod")):
        assert translate_specs(spec_lm(cfg), drop=drop) == \
            _as_tuples(jsh.translate_specs(jax_spec_lm(jcfg), drop=drop))
    mesh = {"data": 16, "model": 16}
    shapes = jax.eval_shape(lambda: jax_init_lm(jax.random.PRNGKey(0), jcfg))
    jshapes = jax.tree.map(lambda s: tuple(s.shape), shapes)
    got = sanitize_tree(spec_lm(cfg), jshapes, _NamedMesh(mesh))
    specs = jax.tree.leaves(jax_spec_lm(jcfg), is_leaf=_is_spec)
    for pl, spec, shape in zip(jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)),
                               specs, jax.tree.leaves(jshapes,
                                                      is_leaf=lambda x: isinstance(x, tuple))):
        want = jsh.sanitize_spec(spec, shape, _FakeMesh(mesh))
        assert pl == named(P(*want), shape, _NamedMesh(mesh))


def test_sanitize_tree_places_an_optimizer_state():
    """``sanitize_tree`` over ``opt_state_specs``'s ``OptState`` and a
    state of that layout (Adafactor: factored ``row``/``col`` dicts)."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), optimizer="adafactor")
    leaves = param_leaves(init_lm(cfg, generator=torch.Generator().manual_seed(0),
                                  device="cpu", dtype="float32"))
    from repro_torch.optim import adafactor_init

    opt = adafactor_init(leaves)
    specs = opt_state_specs([lf.spec for lf in leaves], [lf.shape for lf in leaves],
                            "adafactor")
    mesh = _NamedMesh({"data": 4, "model": 2})
    placed = sanitize_tree(specs, opt, mesh)
    assert placed.step == named(P(), (), mesh)
    for pl, spec, v in zip(placed.nu, specs.nu, opt.nu):
        if isinstance(v, dict):
            assert pl == {k: named(spec[k], v[k].shape, mesh) for k in ("row", "col")}
        else:
            assert pl == named(spec, v.shape, mesh)


def test_no_mesh_no_constraint():
    x = torch.arange(6.0)
    assert constrain(x, "data") is x
    tree = [x, {"a": x}]
    assert constrain_tree(tree, [P("data"), {"a": P()}]) is tree
    assert sanitize_tree({"a": P("data")}, {"a": (4,)}, None) == {"a": None}


def test_meshes_need_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_for_devices(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="model axis of 3"):
        mesh_for_devices(8, model=3, device="cpu")
