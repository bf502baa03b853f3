"""The port's multi-port path against the reference package's.

* ``repro_torch.distributed.compression``: ``quantize_int8`` /
  ``dequantize_int8`` bit-exact against the reference's, in float32 and on
  inputs cast from float64; the ``halo_quantize`` hook quantizes each
  gathered piece with its own scale — ``copy_in`` per tile and the whole
  sweep bit-exact against the reference's;
* ``repro_torch.distributed.sharding``: ``port_mesh`` / ``shard_facets``
  (ports fold ``p mod n_ports``; placement on one device is the identity);
* ``kernels.stencil.execute_tiles_sharded`` (TPU kernel 1s) and
  ``kernels.facet_fetch.fetch_interior_halos_sharded`` (2s): on CPU tensors
  the plain versions per shard, equal to the unsharded call and the
  reference's;
* ``CFAPipeline._sweep_wavefront_sharded`` (the ``sharded`` backend): bit-
  exact against the reference's ``_sweep_wavefront_sharded`` and the port's
  ``_sweep`` in float64 on all 7 programs at 2 ports, padded waves at 3
  ports, the kernel path against the reference's interpret-mode kernel path
  within 1e-12, irredundant storage against redundant;
* the front door: ``distribute`` lowers an over-budget space to
  ``sharded`` bit-exact, ``select_backend`` picks it for ``n_ports > 1``,
  ``report()`` repartitions as the reference's does, and the trace
  attributes every transfer to its shard's port.

Inputs are made with numpy from a seed; facets cross over as numpy.
"""
import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp

from repro import cfa as jcfa
from repro.core.cfa import CFAPipeline as JaxPipeline
from repro.core.cfa import IterSpace as JaxSpace
from repro.core.cfa import Tiling as JaxTiling
from repro.core.cfa import assign_ports as jax_assign_ports
from repro.core.cfa import get_program as jax_program
from repro.distributed.compression import dequantize_int8 as jax_dequantize
from repro.distributed.compression import quantize_int8 as jax_quantize
from repro.kernels.facet_fetch import fetch_interior_halos_sharded as jax_fetch_sharded
from repro_torch import cfa
from repro_torch.core.cfa import CFAPipeline, IterSpace, Tiling, assign_ports, get_program
from repro_torch.core.cfa.passes import estimate_facet_bytes
from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.distributed.sharding import PortMesh, port_mesh, shard_facets
from repro_torch.interop import facets_from_numpy, facets_to_numpy
from repro_torch.kernels.facet_fetch import (fetch_interior_halos, fetch_interior_halos_ref,
                                             fetch_interior_halos_sharded)
from repro_torch.kernels.stencil import (execute_tiles, execute_tiles_ref,
                                         execute_tiles_sharded)

CASES = [
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p-gol", (8, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
    ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4)),
    ("heat1d", (8, 8), (4, 4)),
    ("heat3d", (4, 4, 4, 4), (2, 2, 2, 2)),
]
IDS = [c[0] for c in CASES]
CASE = {c[0]: c for c in CASES}


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)  # torch's default


def _inputs(name, space, seed=0):
    w0 = get_program(name).widths[0]
    return np.random.default_rng(seed).normal(size=(w0, *space[1:]))


def _pipes(name, space=None, tile=None, **kw):
    _, s, t = CASE[name]
    space, tile = space or s, tile or t
    ref = JaxPipeline(jax_program(name), JaxSpace(space), JaxTiling(tile), **kw)
    mine = CFAPipeline(get_program(name), IterSpace(space), Tiling(tile), device="cpu", **kw)
    return ref, mine


def _np(facets):
    return {int(k): np.asarray(v) for k, v in facets.items()}


def _assert_facets_equal(got, want):
    got = facets_to_numpy(got) if isinstance(next(iter(got.values())), torch.Tensor) else got
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, f"facet {k}"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"facet {k}")


@functools.lru_cache(maxsize=None)
def _jax_run(name, method, **kw):
    ref, _ = _pipes(name)
    x = jnp.asarray(_inputs(name, CASE[name][1]))
    return _np(getattr(ref, method)(x, dtype=jnp.float64, **kw))


# -- compression -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scale", [1e-30, 1e-6, 1.0, 1e6, 0.0], ids=str)
@pytest.mark.parametrize("shape", [(1,), (7,), (5, 9, 3)], ids=str)
def test_quantize_dequantize_bit_exact_against_reference(shape, scale, dtype):
    """Scale, codes and the round trip (cast back to the input's dtype) are
    the reference's bit for bit; an all-zero input takes the 1e-12 floor."""
    x = (np.random.default_rng(len(shape)).normal(size=shape) * scale).astype(dtype)
    jq, js = jax_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    want = np.asarray(jax_dequantize(jq, js).astype(jnp.asarray(x).dtype))
    got = dequantize_int8(q, s).to(torch.from_numpy(x).dtype).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_quantize_rounds_half_to_even():
    # max |x| = 127 gives scale 1: the codes are x rounded half to even
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 127.0])
    q, s = quantize_int8(x)
    assert float(s) == 1.0 and q.tolist() == [0, 2, 2, 0, -2, 127]


@pytest.mark.parametrize("name", IDS)
def test_copy_in_quantizes_each_piece_like_the_reference(name):
    """Every tile's quantized halo equals the reference's bit for bit: each
    gathered piece (one per facet, the virtual live-in row apart) has its
    own scale — one scale over the concatenation would differ."""
    ref, mine = _pipes(name, halo_quantize=True)
    _, space, _ = CASE[name]
    facets = _jax_run(name, "_sweep")
    jf = {k: jnp.asarray(v) for k, v in facets.items()}
    tf = facets_from_numpy(facets, "cpu")
    for tile in np.ndindex(*mine.num_tiles):
        want = np.asarray(ref.copy_in(jf, tile))
        got = mine.copy_in(tf, tile).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"tile {tile}")
        # and into a caller's buffer, as the dataflow sweep gathers
        buf = torch.full(got.shape, 7.0, dtype=torch.float64)
        assert mine.copy_in(tf, tile, out=buf) is buf
        np.testing.assert_array_equal(buf.numpy(), want)


@pytest.mark.parametrize("name", IDS)
def test_halo_quantize_sweep_bit_exact_against_reference(name):
    """compile(halo_quantize=True) on the port's sweep and sharded backends
    lands the reference's quantized sweep bit for bit (lossy against the
    exact sweep)."""
    _, space, tile = CASE[name]
    x = _inputs(name, space)
    want = _np(jcfa.compile(name, space, layout=tile, backend="sweep",
                            halo_quantize=True)(jnp.asarray(x), dtype=jnp.float64))
    for backend, n_ports in (("sweep", 1), ("sharded", 2)):
        compiled = cfa.compile(name, space, layout=tile, backend=backend, n_ports=n_ports,
                               halo_quantize=True, device="cpu")
        assert compiled.pipeline.halo_quantize
        _assert_facets_equal(compiled(x, dtype=torch.float64), want)
    exact = _jax_run(name, "_sweep")
    assert any((exact[k] != want[k]).any() for k in exact), "quantization should be lossy"


def test_halo_quantize_covers_every_storage():
    """The irredundant pipelines inherit ``copy_in``: quantized irredundant
    and compressed sweeps equal the reference's."""
    name, space, tile = CASE["jacobi2d5p"]
    x = _inputs(name, space)
    for storage in ("irredundant", "compressed"):
        want = _np(jcfa.compile(name, space, layout=tile, backend="sweep", storage=storage,
                                halo_quantize=True)(jnp.asarray(x), dtype=jnp.float64))
        got = cfa.compile(name, space, layout=tile, n_ports=2, storage=storage,
                          halo_quantize=True, device="cpu")(x, dtype=torch.float64)
        _assert_facets_equal(got, want)


# -- port placement -----------------------------------------------------------------


def test_port_mesh_and_shard_facets():
    mesh = port_mesh(3, "cpu")
    assert isinstance(mesh, PortMesh) and mesh.n_ports == 3 and mesh.streams == ()
    assert mesh.device == torch.device("cpu") and mesh.axis == "port"
    assert mesh.port_device(2) == torch.device("cpu")
    with pytest.raises(IndexError, match="outside"):
        mesh.port_device(3)
    with pytest.raises(ValueError, match="positive"):
        port_mesh(0, "cpu")
    facets = {k: torch.arange(4.0) + k for k in range(3)}
    # port 4 folds back onto port 1; every port shares the device, so
    # placement keeps each tensor as it is
    placed = shard_facets(facets, {0: 0, 1: 4, 2: 2}, mesh)
    assert all(placed[k] is facets[k] for k in facets)
    # a facet on another device moves to its port's device
    meta = PortMesh(2, torch.device("meta"))
    assert shard_facets(facets, {0: 3}, meta)[0].device == torch.device("meta")
    order = []
    mesh.run(order.append)
    assert order == [0, 1, 2]  # the CPU runs the ports in port order


def test_port_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card behaviour")
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_mesh(2)


# -- TPU kernel 1s: execute_tiles_sharded ----------------------------------------


def _halos(name, tile, batch, seed):
    w = get_program(name).widths
    shape = (batch, *(wa + ta for wa, ta in zip(w, tile)))
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape))


@pytest.mark.parametrize("n_ports", [1, 2, 3, 4])
@pytest.mark.parametrize("name", IDS)
def test_execute_tiles_sharded_equals_one_launch(name, n_ports):
    """On CPU tensors each port's shard runs the plain version: the result
    is the unsharded call's, bit for bit; nothing counts as a launch."""
    _, _, tile = CASE[name]
    halos = _halos(name, tile, 3 * n_ports, seed=n_ports)
    before = execute_tiles_sharded.launches, execute_tiles.launches
    got = execute_tiles_sharded(name, halos, tile, port_mesh(n_ports, "cpu"))
    assert torch.equal(got, execute_tiles_ref(name, halos, tile))
    assert torch.equal(got, execute_tiles(name, halos, tile))
    assert (execute_tiles_sharded.launches, execute_tiles.launches) == before


def test_execute_tiles_sharded_rejects_an_unpadded_batch():
    name, _, tile = CASE["jacobi2d5p"]
    with pytest.raises(ValueError, match="multiple of the mesh axis size"):
        execute_tiles_sharded(name, _halos(name, tile, 5, 0), tile, port_mesh(2, "cpu"))
    out = torch.empty(2, 4, 4, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="out must be"):
        execute_tiles(name, _halos(name, tile, 2, 0), tile, out=out)


# -- TPU kernel 2s: fetch_interior_halos_sharded ---------------------------------


@pytest.mark.parametrize("storage", ["redundant", "irredundant"])
def test_sharded_fetch_matches_plain_fetch_and_reference(storage):
    """Port-resident facets feed the read engine unchanged: the sharded
    fetch equals the plain fetch and the reference's sharded fetch."""
    name, space, tile = "jacobi2d5p", (12, 12, 12), (4, 4, 4)
    ref, mine = _pipes(name, space, tile)
    x = _inputs(name, space, seed=3)
    facets = _np(ref._sweep(jnp.asarray(x), dtype=jnp.float64))
    if storage == "irredundant":
        facets = facets_to_numpy(cfa.dedup_facets(facets_from_numpy(facets, "cpu"),
                                                  cfa.build_storage_map(mine.specs)))
    pa = assign_ports(IterSpace(space), get_program(name).deps, Tiling(tile), 2)
    jpa = jax_assign_ports(JaxSpace(space), jax_program(name).deps, JaxTiling(tile), 2)
    assert pa.facet_to_port == jpa.facet_to_port
    tf = facets_from_numpy(facets, "cpu")
    before = fetch_interior_halos_sharded.launches
    got = fetch_interior_halos_sharded(name, tf, space, tile, pa, storage=storage)
    assert fetch_interior_halos_sharded.launches == before
    assert torch.equal(got, fetch_interior_halos(name, tf, space, tile, storage=storage))
    assert torch.equal(got, fetch_interior_halos_ref(name, tf, space, tile, storage=storage))
    want = jax_fetch_sharded(name, {k: jnp.asarray(v) for k, v in facets.items()},
                             space, tile, jpa, storage=storage)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the sharded sweep -----------------------------------------------------------------


@pytest.mark.parametrize("name", IDS)
def test_sweep_wavefront_sharded_bit_exact(name):
    """Every program at 2 ports: the facets equal the reference's sharded
    sweep and the port's single-port ``_sweep``, bit for bit."""
    _, mine = _pipes(name)
    x = _inputs(name, CASE[name][1])
    got = mine._sweep_wavefront_sharded(torch.from_numpy(x), dtype=torch.float64, n_ports=2)
    _assert_facets_equal(got, _jax_run(name, "_sweep_wavefront_sharded", n_ports=2))
    _assert_facets_equal(got, facets_to_numpy(mine._sweep(torch.from_numpy(x),
                                                          dtype=torch.float64)))


@pytest.mark.parametrize("n_ports", [3, 4])
def test_sweep_wavefront_sharded_pads_odd_waves(n_ports):
    """Waves of 1, 3, 3 and 1 tiles over 3 and 4 ports (the padding path)."""
    name, space, tile = CASE["jacobi2d5p"]
    ref, mine = _pipes(name)
    x = np.random.default_rng(1).normal(size=(1, 8, 8))
    assert [len(w) for w in mine.wavefronts()] == [1, 3, 3, 1]
    got = mine._sweep_wavefront_sharded(torch.from_numpy(x), dtype=torch.float64,
                                        n_ports=n_ports)
    _assert_facets_equal(got, _np(ref._sweep(jnp.asarray(x), dtype=jnp.float64)))


def test_sweep_wavefront_sharded_kernel_path():
    """The kernel path (per-port ``execute_tiles_sharded``; the plain
    version on CPU tensors) equals the port's sweep bit for bit and the
    reference's interpret-mode Pallas path within 1e-12."""
    name, space, tile = CASE["jacobi2d5p"]
    ref, mine = _pipes(name)
    x = np.random.default_rng(2).normal(size=(1, 8, 8))
    got = mine._sweep_wavefront_sharded(torch.from_numpy(x), dtype=torch.float64,
                                        n_ports=2, use_kernel=True)
    _assert_facets_equal(got, facets_to_numpy(mine._sweep(torch.from_numpy(x),
                                                          dtype=torch.float64)))
    want = ref._sweep_wavefront_sharded(jnp.asarray(x), dtype=jnp.float64, n_ports=2,
                                        use_kernel=True)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12, atol=1e-12)


def _irredundant_params():
    out = []
    for name, _, _ in CASES:
        out.append(pytest.param(name, False, id=f"{name}-host"))
    out.append(pytest.param("jacobi2d5p", True, id="jacobi2d5p-kernel"))
    return out


@pytest.mark.parametrize("name,use_kernel", _irredundant_params())
def test_irredundant_sharded_bit_exact_vs_redundant(name, use_kernel):
    """The sharded backend under irredundant storage: the payload is the
    redundant payload with non-owned slots zeroed, and rehydrates to it."""
    _, space, tile = CASE[name]
    x = _inputs(name, space)
    red = cfa.compile(name, space, layout=tile, n_ports=2, device="cpu")
    irr = cfa.compile(name, space, layout=tile, n_ports=2, storage="irredundant",
                      device="cpu")
    assert red.backend == irr.backend == "sharded"
    assert irr.pipeline.storage == "irredundant"
    want = red(x, dtype=torch.float64, use_kernel=use_kernel)
    got = irr(x, dtype=torch.float64, use_kernel=use_kernel)
    dd = cfa.dedup_facets(want, irr.pipeline.storage_map)
    rh = irr.rehydrate(got)
    for k in want:
        assert torch.equal(got[k], dd[k]), f"facet {k}"
        assert torch.equal(rh[k], want[k]), f"facet {k}"


# -- the front door -------------------------------------------------------------------


def _budget_for_shards(name, space, shards):
    """A per-host byte budget that forces exactly ``shards`` shards."""
    est = estimate_facet_bytes(get_program(name), IterSpace(space),
                               elem_bytes=cfa.get_target("axi-zc706").model.elem_bytes)
    return -(-est // shards)


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_distribute_lowers_to_sharded_bit_exact(shards):
    """An over-budget space is split over the port mesh and lowers to the
    sharded backend, as in the reference; the facets are the reference
    sweep's bit for bit."""
    name, space, tile = CASE["jacobi2d5p"]
    budget = _budget_for_shards(name, space, shards)
    dist = cfa.compile(name, space, layout=tile, host_budget=budget, device="cpu")
    jdist = jcfa.compile(name, space, layout=tile, host_budget=budget)
    assert dist.distributed and dist.n_ports == jdist.n_ports == shards
    assert dist.backend == jdist.backend == "sharded"
    assert dist.pipeline.port_assignment.facet_to_port == jdist.pipeline.port_assignment.facet_to_port
    _assert_facets_equal(dist(_inputs(name, space), dtype=torch.float64),
                         _jax_run(name, "_sweep"))
    changed = dict({t.name: t for t in dist.trace()}["distribute"].changed)
    assert changed.keys() >= {"n_ports", "distributed"}
    assert dataclasses.asdict(dist.report()) == dataclasses.asdict(jdist.report())


@pytest.mark.parametrize("n_ports", [2, 3, 4])
def test_compile_n_ports_selects_sharded_and_matches_reference(n_ports):
    name, space, tile = CASE["jacobi2d5p"]
    mine = cfa.compile(name, space, layout=tile, n_ports=n_ports, device="cpu")
    ref = jcfa.compile(name, space, layout=tile, n_ports=n_ports)
    assert mine.backend == ref.backend == "sharded"
    assert cfa.select_backend(mine.program, mine.space, n_ports) == "sharded"
    # report() repartitions the plan over the ports, as the reference's
    assert dataclasses.asdict(mine.report()) == dataclasses.asdict(ref.report())
    assert f"x{n_ports} ports" in mine.describe()
    _assert_facets_equal(mine(_inputs(name, space), dtype=torch.float64),
                         _jax_run(name, "_sweep"))


def test_sharded_options_and_mesh():
    name, space, tile = CASE["jacobi2d5p"]
    x = _inputs(name, space)
    compiled = cfa.compile(name, space, layout=tile, n_ports=2, device="cpu")
    want = _jax_run(name, "_sweep")
    # a caller's mesh and assignment (3 ports: more shards than the
    # compile-time port count)
    pa = assign_ports(IterSpace(space), get_program(name).deps, Tiling(tile), 3)
    _assert_facets_equal(compiled(x, dtype=torch.float64, mesh=port_mesh(3, "cpu"),
                                  assignment=pa), want)
    with pytest.raises(ValueError, match="mesh axis"):
        compiled(x, dtype=torch.float64, mesh=port_mesh(2, "cpu", axis="x"))
    with pytest.raises(ValueError, match="port mesh is on"):
        compiled(x, dtype=torch.float64, mesh=PortMesh(2, torch.device("meta")))
    with pytest.raises(TypeError, match="does not accept"):
        compiled(x, dtype=torch.float64, interpret=True)
    with pytest.raises(ValueError, match="port"):
        cfa.compile(name, space, layout=tile, n_ports=5, device="cpu")  # budget is 4
    caps = cfa.EXECUTORS["sharded"].caps
    assert caps.multiport and not caps.overlap
    assert caps.storages == ("redundant", "irredundant", "compressed")
    assert [n for n, ex in cfa.EXECUTORS.items() if ex.caps.multiport] == ["sharded"]


def test_sharded_attributes_ports():
    """Every transfer is attributed to its shard's port (the port's mesh has
    ``n_ports`` shards on every device); the trace reconciles exactly."""
    name, space, tile = CASE["jacobi2d5p"]
    compiled = cfa.compile(name, space, layout=tile, n_ports=2, trace=True, device="cpu")
    compiled(_inputs(name, space), dtype=torch.float64)
    rec = compiled.last_trace()
    assert rec.reconcile(compiled.pipeline)["ok"]
    waves = rec.find("execute_wave")
    assert len(waves) == 4 and {s.arg("n_ports") for s in waves} == {2}
    assert [s.arg("n_tiles") for s in waves] == [1, 3, 3, 1]
    assert {s.arg("port") for s in rec.find("copy_in")} == {0, 1}
    assert {s.track for s in rec.find("copy_in")} == {"port0/fetch", "port1/fetch"}
    assert {s.track for s in rec.find("copy_out")} == {"port0/commit", "port1/commit"}
    assert rec.counters["waves"] == 4 and rec.counters["tiles"] == 8


@pytest.mark.cuda
def test_cuda_sharded_paths_launch_per_port():
    """On a card each port launches the tile kernel on its own stream; the
    sharded sweep and fetch equal their plain versions bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    name, space, tile = CASE["jacobi2d5p"]
    halos = _halos(name, tile, 6, 0).cuda()
    before = execute_tiles_sharded.launches
    got = execute_tiles_sharded(name, halos, tile, port_mesh(3))
    torch.cuda.synchronize()
    assert execute_tiles_sharded.launches == before + 3
    assert torch.equal(got, execute_tiles_ref(name, halos, tile))
    x = _inputs(name, space)
    card = cfa.compile(name, space, layout=tile, n_ports=2)(x, dtype=torch.float64,
                                                           use_kernel=True)
    _assert_facets_equal(card, _jax_run(name, "_sweep"))
