"""The port's dry run (``repro_torch.launch.dryrun``) on a fake world, in a
fresh interpreter so its fake default process group cannot leak into other
tests.

* ``qwen3-0.6b train_4k single``, ``mamba2-370m long_500k single`` and
  ``olmoe-1b-7b decode_32k multi`` at the full configuration end ``ok`` on
  256 / 512 fake ranks, with collectives counted by kind, FlopCounterMode
  FLOPs and the ``no_counterpart`` fields listed, not invented; the skipped
  ``qwen3-0.6b long_500k`` gives the reference's reason.
* Per-rank argument bytes: parameters, moments and batch (decode: token and
  position) equal the sum, over the reference's leaves (shapes from
  ``jax.eval_shape``), of each leaf's elements divided by the axis sizes the
  reference's ``sanitize_spec`` keeps on its tests' fake mesh
  (``{"data": 16, "model": 16}``, or 2 x 16 x 16), times the port's element
  size: float32 training parameters and moments; the serving model's own
  dtype per leaf (the port's serving model holds its matrices in the
  compute dtype, bfloat16, and the rest in float32; the reference's are all
  float32).
* On a SMOKE qwen3 ``train_4k`` cut (seq 64, batch 8), the dry run's
  collective counts by kind on a fake (4, 2) world equal those the same
  dispatch mode reads from one real step on 8 gloo ranks.
* The CLI writes its records under ``--out`` and exits 1 on an error
  record.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from test_torch_distributed import run_group

from repro.configs import get_config as jax_config
from repro.distributed.sharding import DP_AXES, sanitize_spec, translate_specs
from repro.launch.specs import input_specs as jax_input_specs
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import spec_lm as jax_spec_lm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import opt_state_specs as jax_opt_state_specs

REPO = Path(__file__).resolve().parents[1]
CELLS = [("qwen3-0.6b", "train_4k", "single"), ("mamba2-370m", "long_500k", "single"),
         ("olmoe-1b-7b", "decode_32k", "multi")]
SKIPPED = ("qwen3-0.6b", "long_500k", "single")
CUT = {"train_4k": dict(seq=64, batch=8, kind="train")}

_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import run_cell
    cells = json.loads(sys.argv[1])
    out = {}
    for arch, cell, mesh in cells:
        out[f"{arch} {cell} {mesh}"] = run_cell(arch, cell, mesh)
    out["smoke"] = run_cell("qwen3-0.6b", "train_4k", "single",
                            cfg=get_smoke_config("qwen3-0.6b"), cells=json.loads(sys.argv[2]),
                            mesh_shape=((4, 2), ("data", "model")))
    json.dump(out, open(sys.argv[3], "w"))
""")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "records.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps([*CELLS, SKIPPED]),
                          json.dumps(CUT), str(path)], capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(path.read_text())


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _local(shape, spec, mesh) -> int:
    """A leaf's elements on one rank: its size over the axes the
    reference's sanitizer keeps."""
    kept = sanitize_spec(spec, shape, mesh)
    div = 1
    for axes in kept:
        for a in (() if axes is None else (axes,) if isinstance(axes, str) else axes):
            div *= mesh.shape[a]
    return math.prod(shape) // div


def _tree_local(specs, shapes, mesh, itemsize=None) -> int:
    """Bytes on one rank over the leaves of ``shapes``: float32, or each
    leaf's ``itemsize[path]``."""
    leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return sum(_local(tuple(x.shape), s, mesh) *
               (4 if itemsize is None else itemsize[tuple(k.key for k in path)])
               for s, (path, x) in zip(leaves, paths))


def _serving_itemsize(arch: str) -> dict:
    """The port's serving model's element size per reference leaf path: its
    matrices in the compute dtype, the rest float32."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm, param_leaves

    model = init_lm(get_config(arch), device="meta")
    return {lf.path: lf.parts[0].element_size() for lf in param_leaves(model)}


def _expected_bytes(arch: str, cell: str, mesh_kind: str) -> dict:
    cfg = jax_config(arch)
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16} if mesh_kind == "multi"
                     else {"data": 16, "model": 16})
    params = jax.eval_shape(lambda k: jax_init_lm(k, cfg), jax.random.PRNGKey(0))
    pspecs = jax_spec_lm(cfg)
    ins = jax_input_specs(cfg, cell)
    if cell == "train_4k":
        opt = jax.eval_shape(jax_make_optimizer(cfg.optimizer)[0], params)
        ospecs = jax_opt_state_specs(pspecs, params, cfg.optimizer)
        return {"params": _tree_local(pspecs, params, mesh),
                "opt_state": _tree_local(ospecs, opt, mesh),
                "batch": 4 * _local(ins["tokens"].shape, jax.sharding.PartitionSpec(DP_AXES),
                                    mesh)}
    pspecs = translate_specs(pspecs, drop=("data", "pod"))
    return {"params": _tree_local(pspecs, params, mesh, _serving_itemsize(arch)),
            "token": 4 * _local(ins["token"].shape, jax.sharding.PartitionSpec(DP_AXES), mesh),
            "position": 4}


@pytest.mark.parametrize("arch,cell,mesh", CELLS)
def test_full_size_cells_end_ok(records, arch, cell, mesh):
    rec = records[f"{arch} {cell} {mesh}"]
    assert rec["status"] == "ok", rec.get("trace", rec)
    assert rec["n_devices"] == (512 if mesh == "multi" else 256)
    assert rec["flops"] > 0 and rec["flops_source"].endswith("FlopCounterMode")
    assert rec["no_counterpart"] == ["temp_size_in_bytes", "alias_size_in_bytes",
                                     "generated_code_size_in_bytes", "bytes_accessed",
                                     "loop_aware", "hlo_lines"]
    for name in rec["no_counterpart"]:
        assert name not in rec and name not in rec["memory"]
    coll = rec["collectives"]
    assert set(coll["counts"]) == set(coll["bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"}
    assert coll["counts"]["all-gather"] > 0  # the parameters' gathers
    if cell == "train_4k":
        assert coll["counts"]["reduce-scatter"] > 0  # the gradients'
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(mem["arguments"].values())
    assert mem["output_size_in_bytes"] > 0


def test_skipped_cell_gives_the_reference_reason(records):
    from repro.launch.specs import cell_applicable

    rec = records[" ".join(SKIPPED)]
    assert rec["status"] == "skipped"
    assert rec["reason"] == cell_applicable(jax_config("qwen3-0.6b"), "long_500k")[1]


@pytest.mark.parametrize("arch,cell,mesh", CELLS)
def test_argument_bytes_follow_the_reference_specs(records, arch, cell, mesh):
    got = records[f"{arch} {cell} {mesh}"]["memory"]["arguments"]
    want = _expected_bytes(arch, cell, mesh)
    assert {k: got[k] for k in want} == want


def _real_step_counts(rank: int, world: int, cut: dict) -> dict | None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.mesh import mesh_for_devices

    specs.SHAPE_CELLS = cut
    cfg = get_smoke_config("qwen3-0.6b")
    mesh = mesh_for_devices(model=2, device="cpu")
    with use_mesh(mesh, **specs.policy_for(cfg, "train_4k")):
        c = specs.build_cell(cfg, "train_4k", mesh, device="cpu")
        with CollectiveCounter() as coll:
            _, _, metrics = c.step(*c.args)
    assert np.isfinite(float(metrics["loss"]))
    return coll.record() if rank == 0 else None


def test_fake_world_counts_equal_a_real_gloo_step(records):
    fake = records["smoke"]
    assert fake["status"] == "ok", fake.get("trace", fake)
    real = run_group(8, _real_step_counts, CUT)[0]
    assert fake["collectives"]["counts"] == real["counts"]
    assert fake["collectives"]["bytes"] == real["bytes"]
    assert sum(real["counts"].values()) > 0


def test_the_cli_writes_records_and_exits_1_on_an_error(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen3-0.6b", "--cell", "long_500k", "--mesh", "both", "--out",
                          str(tmp_path)], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for mk in ("single", "multi"):
        rec = json.loads((tmp_path / f"qwen3-0.6b__long_500k__{mk}.json").read_text())
        assert rec["status"] == "skipped"
    # a cell that raises: an error record, exit 1
    (tmp_path / "bad").mkdir()
    script = textwrap.dedent("""
        import sys
        import repro_torch.launch.dryrun as d
        def broken(*a, **k):
            raise RuntimeError("a broken cell")
        d.build_cell = broken
        sys.exit(d.main(sys.argv[1:]))
    """)
    res = subprocess.run([sys.executable, "-c", script, "--arch", "mamba2-370m", "--cell",
                          "decode_32k", "--mesh", "single", "--out", str(tmp_path / "bad")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 1, res.stderr[-3000:]
    rec = json.loads((tmp_path / "bad" / "mamba2-370m__decode_32k__single.json").read_text())
    assert rec["status"] == "error" and "a broken cell" in rec["error"]
