"""The port's cell specs (``repro_torch.launch.specs``) against the
reference's ``repro/launch/specs.py``.

* ``input_specs`` — meta tensors — have the reference's shapes and dtypes
  for every (arch, cell) (``tests/test_specs.py``'s check, run on both
  packages); the 40 cells; ``long_500k`` applies to exactly mamba2-370m and
  jamba-1.5-large-398b, and the skip reasons are the reference's.
* ``policy_for`` and ``default_hparams`` equal the reference's for every
  configuration.
* Every cache spec equals the reference's ``_cache_specs`` with the period
  axis dropped, at batch 128 and batch 1, pure-DP or not, on the reference
  tests' fake 16 x 16 mesh, for every configuration's cache tree.
* ``build_cell`` on 8 gloo ranks (a 4 x 2 ``data`` x ``model`` mesh) for
  qwen3-0.6b and jamba-1.5-large-398b SMOKE (float32 compute), with
  ``train_4k`` and ``decode_32k`` cut to seq 64, batch 8 (the reference
  test's own cut): one step with real CPU tensors, against the port's
  single-device cell (``build_cell(..., mesh=None)``: the same weights and
  inputs) at ``test_torch_distributed.py``'s limits: loss rtol 1e-6, parameters rtol 1e-5 / atol
  1e-6, logits rtol 1e-5 / atol 1e-6.  The placements it reports are those
  of the DTensors it builds.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from test_torch_distributed import run_group

import repro.launch.specs as jspecs
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models.lm import init_caches as jax_init_caches
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.launch import specs
from repro_torch.launch.specs import (SHAPE_CELLS, _cache_specs, cell_applicable,
                                      default_hparams, input_specs, policy_for)

CUT = {"train_4k": dict(seq=64, batch=8, kind="train"),
       "decode_32k": dict(seq=64, batch=8, kind="decode")}
LOSS_RTOL, PARAM_TOL, LOGIT_TOL = 1e-6, dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-5, atol=1e-6)


class _FakeMesh:
    """The reference tests' fake mesh: axis -> size."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
def test_input_specs_match_the_reference(arch, cell):
    cfg, jcfg = get_config(arch), jax_config(arch)
    ok, why = cell_applicable(cfg, cell)
    assert (ok, why) == jspecs.cell_applicable(jcfg, cell)
    if not ok:
        return
    got, want = input_specs(cfg, cell), jspecs.input_specs(jcfg, cell)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape)
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype)


def test_cells_and_long_context_applicability():
    assert SHAPE_CELLS == jspecs.SHAPE_CELLS
    assert len(ARCH_NAMES) * len(SHAPE_CELLS) == 40
    eligible = {a for a in ARCH_NAMES if cell_applicable(get_config(a), "long_500k")[0]}
    assert eligible == {"mamba2-370m", "jamba-1.5-large-398b"}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_policy_and_hparams_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for c in SHAPE_CELLS:
        got, want = policy_for(cfg, c), jspecs.policy_for(jcfg, c)
        assert tuple(got["dp_axes"]) == tuple(want["dp_axes"])
        assert set(got["drop_axes"]) == set(want["drop_axes"])
    for dp in ("tp", "dp"):  # the pure-DP policy too (no configuration uses it)
        got = policy_for(dataclasses.replace(cfg, parallelism=dp), "train_4k")
        want = jspecs.policy_for(dataclasses.replace(jcfg, parallelism=dp), "train_4k")
        assert tuple(got["dp_axes"]) == tuple(want["dp_axes"])
        assert set(got["drop_axes"]) == set(want["drop_axes"])
    assert dataclasses.asdict(default_hparams(cfg)) == \
        dataclasses.asdict(jspecs.default_hparams(jcfg))


def _ref_cache_specs(arch: str, batch: int, pure_dp: bool) -> dict:
    cfg = jax_smoke(arch)
    src = cfg.n_context_tokens if (cfg.family == "vlm" or cfg.is_encdec) else 0
    cache = jax.eval_shape(lambda: jax_init_caches(cfg, batch, 64, src))
    specs_tree = jspecs._cache_specs(cache, batch, _FakeMesh({"data": 16, "model": 16}),
                                     pure_dp=pure_dp)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs_tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]:
        name = [getattr(k, "name", getattr(k, "key", None)) for k in path][-1]
        assert spec[0] is None  # the period axis
        out.setdefault(name, set()).add(tuple(spec)[1:])
    return out


def _port_cache_specs(arch: str, batch: int, pure_dp: bool) -> dict:
    from repro_torch.models.lm import init_caches

    cfg = get_smoke_config(arch)
    src = cfg.n_context_tokens if (cfg.family == "vlm" or cfg.is_encdec) else 0
    caches = init_caches(cfg, batch, 64, device="meta", src_len=src)
    tree = _cache_specs(caches, batch, _FakeMesh({"data": 16, "model": 16}), pure_dp=pure_dp)
    out = {}

    def walk(node, name=None):
        if isinstance(node, specs.P):
            out.setdefault(name, set()).add(tuple(node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f.name)

    walk(tree)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("pure_dp", [False, True])
def test_cache_specs_match_the_reference_without_the_period_axis(arch, batch, pure_dp):
    got, want = _port_cache_specs(arch, batch, pure_dp), _ref_cache_specs(arch, batch, pure_dp)
    assert got == want and got


# ---------------------------------------------------------------------------
# build_cell on a 4 x 2 gloo mesh, one step, against the single-device cell
# ---------------------------------------------------------------------------

def _cfg(arch: str):
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")


def _run(cfg, cell: str, mesh):
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import lm_to_numpy

    with use_mesh(mesh, **policy_for(cfg, cell)):
        c = specs.build_cell(cfg, cell, mesh, device="cpu")
        placed = [tuple(getattr(p, "placements", ())) for p in
                  (part for leaf in specs.param_leaves(c.args[0]) for part in leaf.parts)]
        out = c.step(*c.args)
    if c.kind == "train":
        model, _, metrics = out
        return {"loss": float(metrics["loss"]),
                "params": jax.tree.leaves(lm_to_numpy(model)),
                "in_shardings": c.in_shardings[0], "placed": placed,
                "leaves": [(tuple(lf.spec), lf.shape, lf.stacked) for lf in
                           specs.param_leaves(model)]}
    logits, _ = out
    return {"logits": logits.float().numpy(), "in_shardings": c.in_shardings[0],
            "placed": placed,
            "leaves": [(tuple(lf.spec), lf.shape, lf.stacked)
                       for lf in specs.param_leaves(c.args[0])]}


def _group_cells(rank: int, world: int) -> dict:
    from repro_torch.launch.mesh import mesh_for_devices

    specs.SHAPE_CELLS = CUT
    mesh = mesh_for_devices(model=2, device="cpu")
    res = {}
    for arch in ("qwen3-0.6b", "jamba-1.5-large-398b"):
        for cell in CUT:
            cfg = _cfg(arch)
            res[(arch, cell)] = {"mesh": _run(cfg, cell, mesh), "single": _run(cfg, cell, None)}
    return res if rank == 0 else None


@pytest.fixture(scope="module")
def cells():
    return run_group(8, _group_cells)[0]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_build_cell_train_step_on_a_mesh_matches_one_device(cells, arch):
    got, want = cells[(arch, "train_4k")]["mesh"], cells[(arch, "train_4k")]["single"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_build_cell_decode_step_on_a_mesh_matches_one_device(cells, arch):
    got, want = cells[(arch, "decode_32k")]["mesh"], cells[(arch, "decode_32k")]["single"]
    assert got["logits"].shape == want["logits"].shape
    assert np.isfinite(got["logits"]).all()
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("cell", list(CUT))
def test_build_cell_places_the_parameters_as_it_reports(cells, cell):
    """A stacked leaf's reported placements shard the dim after the period
    axis that its parts' DTensors shard; serving drops FSDP (``data``)."""
    from torch.distributed.tensor import Shard

    got = cells[("qwen3-0.6b", cell)]["mesh"]
    parts = iter(got["placed"])
    for (spec, shape, stacked), reported in zip(got["leaves"], got["in_shardings"]):
        n = shape[0] if stacked else 1
        for _ in range(n):
            part = next(parts)
            want = tuple(Shard(p.dim - 1) if stacked and isinstance(p, Shard) else p
                         for p in reported)
            assert part == want, (spec, shape)
        if cell == "decode_32k":
            assert "data" not in str(spec)
    assert cells[("qwen3-0.6b", cell)]["single"]["in_shardings"] == [None] * len(got["leaves"])
