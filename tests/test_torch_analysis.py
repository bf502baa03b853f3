"""The port's static verifier (repro_torch.core.cfa.analysis) against the
reference package's (repro.core.cfa.analysis) on the CPU.

* ``compile(..., verify=True)``: over the Table I programs plus
  heat1d/heat3d x the three storages x 1 and 2 ports, both packages compile
  the same program with the same explicit layout and the same pinned
  backend (``wavefront`` at 1 port, ``sharded`` at 2: the reference's auto
  backend is ``pallas``, the port's ``cuda``), and the two
  ``AnalysisReport``s are equal — codes, severities, messages, locations,
  fixits, ``cost_s`` (exact: both are numpy) and the analyses;
* the pure checkers (``check_facet_family``, ``check_overlap_schedule``,
  ``lint_plan`` on the baseline plans) give the same diagnostics;
* the mutation cases of ``tests/test_analysis.py`` (a corrupted plan, wave
  schedule or contract via ``dataclasses.replace``) give the same ERROR
  codes, and ``VerificationError`` / ``verify(strict=True)`` raise alike;
* port only: the port's auto backend (``cuda`` on 3-D redundant and
  irredundant storage, ``wavefront`` under compressed) draws no CFA401,
  and a forced ``backend="cuda"`` under compressed storage is rejected with
  a ``BackendError`` before the analyses run.
"""
import dataclasses
import itertools

import pytest
torch = pytest.importorskip("torch")

from repro import cfa as jcfa
from repro.core.cfa import analysis as jan
from repro.core.cfa import bandwidth as jbw
from repro.core.cfa import plans as jplans
from repro.core.cfa.executors import get_executor as jget_executor
from repro.core.cfa.spaces import IterSpace as JSpace, Tiling as JTiling
from repro_torch import cfa
from repro_torch.core.cfa import analysis as an
from repro_torch.core.cfa import bandwidth as bw
from repro_torch.core.cfa import plans
from repro_torch.core.cfa.executors import get_executor
from repro_torch.core.cfa.spaces import IterSpace, Tiling

CASES = [
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p-gol", (8, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
    ("smith-waterman-3seq", (9, 8, 8), (3, 4, 4)),
    ("heat1d", (8, 8), (4, 4)),
    ("heat3d", (4, 4, 4, 4), (2, 2, 2, 2)),
]
CASE = {c[0]: c for c in CASES}
IDS = [c[0] for c in CASES]
STORAGES = ("redundant", "irredundant", "compressed")
THREE_D = [c[0] for c in CASES if len(c[1]) == 3]


def _both(name, storage="redundant", n_ports=1, **kw):
    """(port, reference) compiled stencils at the case's explicit tile with
    the same pinned backend."""
    _, space, tile = CASE[name]
    kw.setdefault("backend", "sharded" if n_ports > 1 else "wavefront")
    mine = cfa.compile(name, space, layout=tile, storage=storage,
                       n_ports=n_ports, device="cpu", **kw)
    ref = jcfa.compile(name, space, layout=tile, storage=storage,
                       n_ports=n_ports, **kw)
    return mine, ref


def _dicts(diags):
    return [d.to_dict() for d in diags]


def _report_equal(mine, ref):
    assert mine.to_dict() == ref.to_dict()
    assert mine.analyses == ref.analyses
    assert mine.codes == ref.codes and mine.max_severity == ref.max_severity
    assert mine.summary() == ref.summary()


# ---------------------------------------------------------------------------
# compile(verify=True): the program x storage x ports matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_ports", [1, 2])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("name", IDS)
def test_verify_report_equals_reference(name, storage, n_ports):
    mine, ref = _both(name, storage, n_ports, verify=True)
    assert mine.backend == ref.backend
    assert mine.analysis is not None and mine.diagnostics() is mine.analysis
    _report_equal(mine.diagnostics(), ref.diagnostics())
    assert mine.diagnostics().ok
    # the analysis passes run inside the lowering, after lower_backend
    assert [t.name for t in mine.trace()] == [t.name for t in ref.trace()]


@pytest.mark.parametrize("name", IDS)
def test_diagnostics_on_demand_equals_reference(name):
    mine, ref = _both(name)
    assert mine.analysis is None
    _report_equal(mine.diagnostics(), ref.diagnostics())


# ---------------------------------------------------------------------------
# the pure checkers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("name", IDS)
def test_facet_family_and_overlap_checks_equal_reference(name, storage):
    _, space, tile = CASE[name]
    deps, jdeps = cfa.get_program(name).deps, jcfa.get_program(name).deps
    got = an.check_facet_family(IterSpace(space), deps, Tiling(tile), storage=storage)
    want = jan.check_facet_family(JSpace(space), jdeps, JTiling(tile), storage=storage)
    assert _dicts(got) == _dicts(want)
    got = an.check_overlap_schedule(IterSpace(space), deps, Tiling(tile))
    want = jan.check_overlap_schedule(JSpace(space), jdeps, JTiling(tile))
    assert _dicts(got) == _dicts(want) == []


#: the port's H100 preset, rebuilt as a reference BurstModel so the reference
#: lint can price the same plans under it
def _jax_model(model):
    return jbw.BurstModel(**dataclasses.asdict(model))


@pytest.mark.parametrize("n_ports", [1, 2])
@pytest.mark.parametrize("name", IDS)
def test_lint_plan_on_baselines_equals_reference(name, n_ports):
    _, space, tile = CASE[name]
    deps, jdeps = cfa.get_program(name).deps, jcfa.get_program(name).deps
    sp, til, jsp, jtil = IterSpace(space), Tiling(tile), JSpace(space), JTiling(tile)
    mine = [plans.original_layout_plan(sp, deps, til), plans.bounding_box_plan(sp, deps, til),
            plans.data_tiling_plan(sp, deps, til), plans.cfa_plan(sp, deps, til),
            plans.cfa_plan(sp, deps, til, storage="irredundant")]
    ref = [jplans.original_layout_plan(jsp, jdeps, jtil),
           jplans.bounding_box_plan(jsp, jdeps, jtil),
           jplans.data_tiling_plan(jsp, jdeps, jtil), jplans.cfa_plan(jsp, jdeps, jtil),
           jplans.cfa_plan(jsp, jdeps, jtil, storage="irredundant")]
    fired = set()
    for model in (bw.AXI_ZC706, bw.H100_HBM3):
        for p, jp in zip(mine, ref):
            got = an.lint_plan(p, model, n_ports=n_ports, contiguity="inter-tile")
            want = jan.lint_plan(jp, _jax_model(model), n_ports=n_ports,
                                 contiguity="inter-tile")
            assert _dicts(got) == _dicts(want), (model.name, p.scheme)
            assert _dicts(an.plan_accounting(p)) == _dicts(jan.plan_accounting(jp))
            fired |= {d.code for d in got}
    assert "CFA302" in fired  # the inter-tile INFO: the comparison is never vacuous


# ---------------------------------------------------------------------------
# mutation cases: the same ERROR codes in both packages
# ---------------------------------------------------------------------------


def _waves(nt):
    by = {}
    for q in itertools.product(*(range(n) for n in nt)):
        by.setdefault(sum(q), []).append(q)
    return [by[s] for s in sorted(by)]


def _dup_write(plan):
    return dataclasses.replace(
        plan, write_runs=tuple(plan.write_runs) + (plan.write_runs[0],),
        write_run_hosts=tuple(plan.write_run_hosts) + (plan.write_run_hosts[0],))


def _drop_write(plan):
    return dataclasses.replace(plan, write_runs=tuple(plan.write_runs[:-1]),
                               write_run_hosts=tuple(plan.write_run_hosts[:-1]))


def _starve(plan):
    return dataclasses.replace(plan, read_runs=tuple(1 for _ in plan.read_runs))


def _missing_tile():
    waves = _waves((2, 2, 2))
    waves[-1] = waves[-1][:-1]
    return waves


#: (id, compile kwargs, verify kwargs built from the compiled plan, ERROR codes)
PLAN_MUTATIONS = [
    ("duplicate-write-run", {}, lambda p: dict(plan=_dup_write(p)), ["CFA101"]),
    ("dropped-owner-block", dict(storage="irredundant"), lambda p: dict(plan=_drop_write(p)),
     ["CFA102"]),
    ("starved-reads", {}, lambda p: dict(plan=_starve(p)), ["CFA105"]),
    ("merged-waves", {},
     lambda p: dict(waves=[list(itertools.product(range(2), range(2), range(2)))]),
     ["CFA201"]),
    ("reversed-waves", {}, lambda p: dict(waves=list(reversed(_waves((2, 2, 2))))),
     ["CFA202"]),
    ("missing-tile", {}, lambda p: dict(waves=_missing_tile()), ["CFA202"]),
]


@pytest.mark.parametrize("kw,mutate,codes", [m[1:] for m in PLAN_MUTATIONS],
                         ids=[m[0] for m in PLAN_MUTATIONS])
def test_plan_and_wave_mutations_equal_reference(kw, mutate, codes):
    mine, ref = _both("jacobi2d5p", **kw)
    with pytest.raises(cfa.VerificationError) as got:
        cfa.verify(mine, **mutate(mine.plan))
    with pytest.raises(jcfa.VerificationError) as want:
        jcfa.verify(ref, **mutate(ref.plan))
    assert sorted({d.code for d in got.value.report.errors}) == codes
    _report_equal(got.value.report, want.value.report)
    assert str(got.value) == str(want.value)


#: contract mutations via dataclasses.replace on the compiled stencil; the
#: port's kernel backend is ``cuda`` where the reference's is ``pallas``
CONTRACT_MUTATIONS = [
    ("cfa401-3d-only", ("heat3d", {}), "kernel-backend", ["CFA401"], None),
    ("cfa401-storage", ("jacobi2d5p", dict(storage="compressed")), "kernel-backend",
     ["CFA401"], "storage"),
    ("cfa403-codec", ("jacobi2d5p", {}), "codec", ["CFA403"], "storage"),
    ("cfa404-ports", ("jacobi2d5p", dict(n_ports=2)), "ports", ["CFA404"], "n_ports"),
]


def _mutate_contract(compiled, how, kernel_backend, get_codec):
    if how == "kernel-backend":
        return dataclasses.replace(compiled, executor=kernel_backend)
    if how == "codec":
        return dataclasses.replace(compiled, codec=get_codec("deltapack16"))
    return dataclasses.replace(compiled, n_ports=99)


@pytest.mark.parametrize("case,how,codes,fixit", [m[1:] for m in CONTRACT_MUTATIONS],
                         ids=[m[0] for m in CONTRACT_MUTATIONS])
def test_contract_mutations_equal_reference(case, how, codes, fixit):
    name, kw = case
    mine, ref = _both(name, **kw)
    bad = _mutate_contract(mine, how, get_executor("cuda"), cfa.get_codec)
    jbad = _mutate_contract(ref, how, jget_executor("pallas"), jcfa.get_codec)
    with pytest.raises(cfa.VerificationError) as got:
        cfa.verify(bad)
    with pytest.raises(jcfa.VerificationError) as want:
        jcfa.verify(jbad)
    mine_r, ref_r = got.value.report, want.value.report
    assert sorted({d.code for d in mine_r.errors}) == codes
    assert ([(d.code, d.severity, d.fixit, d.analysis) for d in mine_r.diagnostics]
            == [(d.code, d.severity, d.fixit, d.analysis) for d in ref_r.diagnostics])
    err = next(d for d in mine_r.errors if d.code == codes[0])
    assert err.fixit == fixit
    if how == "kernel-backend":
        # the message names the port's registry
        assert "'cuda'" in err.message
    else:
        _report_equal(mine_r, ref_r)


def test_cfa402_overlap_on_a_sequential_backend_equals_reference():
    mine, ref = _both("jacobi2d5p")
    state = dataclasses.replace(an._state_of(mine), overlap=True)
    jstate = dataclasses.replace(jan._state_of(ref), overlap=True)
    got, want = an.run_analyses(state), jan.run_analyses(jstate)
    assert [d.code for d in got.errors] == ["CFA402"]
    _report_equal(got, want)


def test_cfa403_lossy_codec_is_info_only_in_both():
    mine, ref = _both("jacobi2d5p", storage="compressed")
    got = cfa.verify(mine, raise_on_error=False)
    _report_equal(got, jcfa.verify(ref, raise_on_error=False))
    assert got.by_code("CFA403") and all(d.severity == "INFO" for d in got.by_code("CFA403"))


def test_state_of_keeps_the_stencils_device():
    mine, _ = _both("jacobi2d5p")
    assert an._state_of(mine).device == torch.device("cpu") == mine.device


# ---------------------------------------------------------------------------
# VerificationError and strict mode
# ---------------------------------------------------------------------------


def test_verify_strict_raises_on_jacobi2d5p_cfa303_in_both():
    mine, ref = _both("jacobi2d5p")
    report = cfa.verify(mine)  # WARN alone does not raise
    assert report.ok and report.codes == ("CFA303",)
    with pytest.raises(cfa.VerificationError, match="CFA303") as got:
        cfa.verify(mine, strict=True)
    with pytest.raises(jcfa.VerificationError) as want:
        jcfa.verify(ref, strict=True)
    assert str(got.value) == str(want.value)
    _report_equal(got.value.report, want.value.report)


def test_verification_error_and_report_render_like_reference():
    diags = tuple(an.Diagnostic(f"CFA10{i}", "ERROR", f"bad {i}") for i in range(1, 6))
    jdiags = tuple(jan.Diagnostic(f"CFA10{i}", "ERROR", f"bad {i}") for i in range(1, 6))
    err = an.VerificationError(an.AnalysisReport(diags, analyses=(("a", "1"),)))
    jerr = jan.VerificationError(jan.AnalysisReport(jdiags, analyses=(("a", "1"),)))
    assert str(err) == str(jerr) and "+1 more" in str(err)
    assert err.report.to_json() == jerr.report.to_json()
    assert isinstance(err, ValueError)


def test_compile_verify_raises_verification_error_on_an_error():
    """An analysis that reports an ERROR makes ``compile(verify=True)``
    raise, carrying the report, as the reference's does."""
    @an.analysis_pass("always_fails", codes=("CFA999",))
    def always_fails(state):
        return [an.Diagnostic("CFA999", "ERROR", "planted")]

    pipe = an.verify_pipeline()
    pipe = type(pipe)(tuple(pipe.passes) + (always_fails,))
    with pytest.raises(cfa.VerificationError, match="CFA999") as ei:
        cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), device="cpu",
                    passes=pipe, verify=True)
    assert ei.value.report.analyses[-1] == ("always_fails", "1")


def test_verify_pipeline_composes_like_reference():
    pipe = an.verify_pipeline()
    assert pipe.names == jan.verify_pipeline().names
    assert an.verify_pipeline(pipe).names == pipe.names
    assert [(a.name, a.version, a.codes) for a in an.DEFAULT_ANALYSES] == [
        (a.name, a.version, a.codes) for a in jan.DEFAULT_ANALYSES]


# ---------------------------------------------------------------------------
# port only: the port's own backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("name", THREE_D)
def test_auto_backend_draws_no_cfa401(name, storage):
    _, space, tile = CASE[name]
    c = cfa.compile(name, space, layout=tile, storage=storage, device="cpu", verify=True)
    assert c.backend == ("wavefront" if storage == "compressed" else "cuda")
    assert "CFA401" not in c.diagnostics().codes and c.diagnostics().ok


def test_forced_cuda_under_compressed_storage_is_rejected_before_the_analyses():
    with pytest.raises(cfa.BackendError, match="compressed") as ei:
        cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), storage="compressed",
                    backend="cuda", device="cpu", verify=True)
    assert not isinstance(ei.value, cfa.VerificationError)
