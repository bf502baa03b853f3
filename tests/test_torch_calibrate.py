"""The port's measurement layer (repro_torch.core.cfa.calibrate) against the
reference package's (repro.core.cfa.calibrate) on the CPU, deterministically.

* the numpy half — ``wire_bytes``, ``_wire_words``, ``TransferSample``,
  ``fit_burst_model`` on seeded noisy samples, the ``Calibration`` JSON
  record — equals the reference's (the fit to 1e-12 relative; a record
  written by either package is read back by the other);
* ``calibrate()``, ``autotune(score="measured")``, ``report(measured=True)``
  and ``runtime_report()`` equal the reference's with ``measure_runs`` /
  ``measure_plan`` replaced in *both* packages by the same deterministic
  schedule-to-seconds function: no wall clock decides a comparison;
* the real harness on ``device="cpu"`` is held on structure only: positive
  and finite, an empty schedule is free, bad arguments raise, the
  ``measure_pass``/``measure`` spans and counters, one schedule per port;
* the autotune cache key with a ``device`` in ``measure_kwargs`` is JSON and
  names ``"cuda"`` and ``torch.device("cuda")`` alike.
"""
import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.core.cfa  # noqa: F401  (the package; its submodules are read from sys.modules)
import repro_torch.core.cfa  # noqa: F401
from repro import cfa as jcfa
from repro.core.cfa import bandwidth as jbw
from repro_torch import cfa
from repro_torch.core.cfa import bandwidth as bw
from repro_torch.core.cfa.bandwidth import PortedPlan
from repro_torch.core.cfa.obs import TraceRecorder

# ``repro_torch.core.cfa.calibrate`` is the function on the package; the
# modules come from sys.modules
cal = sys.modules["repro_torch.core.cfa.calibrate"]
jcal = sys.modules["repro.core.cfa.calibrate"]
at = sys.modules["repro_torch.core.cfa.autotune"]
obs = sys.modules["repro_torch.core.cfa.obs"]
jobs = sys.modules["repro.core.cfa.obs"]

CPU = dict(warmup=1, repeats=3, device="cpu")
LENGTHS = (1, 7, 64, 511, 4095, 32768)


def _jax_model(model):
    """The same burst model as a reference BurstModel."""
    return jbw.BurstModel(**dataclasses.asdict(model))


#: (port model, the same model in the reference package)
MODELS = [(bw.AXI_ZC706, jbw.AXI_ZC706), (bw.H100_HBM3, _jax_model(bw.H100_HBM3))]
MODEL_IDS = ["axi-zc706", "h100-hbm3"]


# ---------------------------------------------------------------------------
# the numpy half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec_bits", [None, 8, 16])
@pytest.mark.parametrize("elem_bytes", [2, 4, 8])
def test_wire_bytes_and_words_equal_reference(elem_bytes, codec_bits):
    for n in LENGTHS:
        assert cal.wire_bytes(n, elem_bytes, codec_bits) == jcal.wire_bytes(
            n, elem_bytes, codec_bits)
        assert cal._wire_words(n, elem_bytes, codec_bits) == jcal._wire_words(
            n, elem_bytes, codec_bits)


@pytest.mark.parametrize("runs_by_port,elem_bytes,codec_bits", [
    (((4, 8),), 8, None), (((4, 8), (16,)), 8, 16), (((1,) * 5, (3, 3), (4096,)), 4, 8),
    (((32768,),), 2, None),
])
def test_transfer_sample_equals_reference(runs_by_port, elem_bytes, codec_bits):
    s = cal.TransferSample(runs_by_port, elem_bytes, 1e-3, codec_bits, "x")
    j = jcal.TransferSample(runs_by_port, elem_bytes, 1e-3, codec_bits, "x")
    assert dataclasses.asdict(s) == dataclasses.asdict(j)
    assert (s.n_ports, s.runs, s.n_bursts, s.wire_bytes) == (
        j.n_ports, j.runs, j.n_bursts, j.wire_bytes)


@pytest.mark.parametrize("bad", [
    dict(runs_by_port=()), dict(runs_by_port=((0, 4),)), dict(elem_bytes=0),
    dict(measured_s=-1.0), dict(measured_s=float("nan")),
], ids=["no-port", "zero-run", "elem-bytes", "negative", "nan"])
def test_transfer_sample_rejects_like_reference(bad):
    kw = dict(dict(runs_by_port=((4,),), elem_bytes=8, measured_s=1.0), **bad)
    with pytest.raises(ValueError) as got:
        cal.TransferSample(**kw)
    with pytest.raises(ValueError) as want:
        jcal.TransferSample(**kw)
    assert str(got.value) == str(want.value)


def _noisy_samples(module, model, seed, ports=(2, 4)):
    """Samples drawn from ``model`` with seeded multiplicative noise, built
    in ``module``'s own TransferSample."""
    rng = np.random.default_rng(seed)
    out = []
    for L in (1, 8, 64, 512, 4096, 32768):
        for c in (1, 4, 16):
            sched = (L,) * c
            t = model.time_s(sched) * (1.0 + 0.01 * rng.standard_normal())
            out.append(module.TransferSample((sched,), model.elem_bytes, t))
    for p in ports:
        per_port = tuple((256,) * (4 + q) for q in range(p))
        t = max(model.time_s(r) for r in per_port) * (1.2 + 0.1 * rng.random())
        out.append(module.TransferSample(per_port, model.elem_bytes, t))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("models", MODELS, ids=MODEL_IDS)
def test_fit_burst_model_equals_reference(models, seed):
    model, jmodel = models
    fit = cal.fit_burst_model(_noisy_samples(cal, model, seed), model)
    jfit = jcal.fit_burst_model(_noisy_samples(jcal, jmodel, seed), jmodel)
    assert fit.setup_s == pytest.approx(jfit.setup_s, rel=1e-12)
    assert fit.peak_bytes_per_s == pytest.approx(jfit.peak_bytes_per_s, rel=1e-12)
    assert [p for p, _ in fit.port_factors] == [p for p, _ in jfit.port_factors] == [2, 4]
    for (_, f), (_, jf) in zip(fit.port_factors, jfit.port_factors):
        assert f == pytest.approx(jf, rel=1e-12)
    assert (fit.name, fit.base_name, fit.elem_bytes) == (jfit.name, jfit.base_name,
                                                         jfit.elem_bytes)
    assert fit.setup_s > 0 and fit.peak_bytes_per_s > 0


def test_fit_without_single_port_samples_raises_like_reference():
    s = cal.TransferSample(((8,), (8,)), 8, 1e-3)
    with pytest.raises(cal.CalibrationError, match="single-port"):
        cal.fit_burst_model([s], bw.AXI_ZC706)
    with pytest.raises(jcal.CalibrationError, match="single-port"):
        jcal.fit_burst_model([jcal.TransferSample(((8,), (8,)), 8, 1e-3)], jbw.AXI_ZC706)


def _record(module, model, seed=0):
    """A Calibration built from seeded samples, no measurement involved."""
    samples = tuple(_noisy_samples(module, model, seed))
    fitted = module.fit_burst_model(samples, model)
    rows = ({"program": "jacobi2d5p", "storage": "redundant", "n_ports": 1,
             "codec_bits": None, "n_bursts": 7, "overlap": False, "compute_s": 0.0,
             "modeled_s": 1e-5, "fitted_s": 1.1e-5, "measured_s": 1.2e-5,
             "rel_err_modeled": 1 / 6, "rel_err_fitted": 1 / 12},)
    return module.Calibration(target=model.name, base=model, fitted=fitted,
                              samples=samples, plan_errors=rows, noise=0.01,
                              host=(("machine", "x"),))


@pytest.mark.parametrize("models", MODELS, ids=MODEL_IDS)
def test_calibration_record_crosses_between_packages(models, tmp_path):
    model, jmodel = models
    mine, ref = _record(cal, model), _record(jcal, jmodel)
    assert mine.to_json() == ref.to_json()
    assert cal.Calibration.from_json(ref.to_json()) == mine
    assert jcal.Calibration.from_json(mine.to_json()) == ref
    back = cal.Calibration.from_json(
        jcal.Calibration.from_json(mine.save(tmp_path / "c.json").read_text()).to_json())
    assert back == mine and isinstance(back.fitted, cal.CalibratedModel)
    assert mine.summary() == ref.summary()
    assert mine.max_rel_err("modeled") == ref.max_rel_err("modeled")


# ---------------------------------------------------------------------------
# the front door with a deterministic timer in both packages
# ---------------------------------------------------------------------------

#: the deterministic "device": 9 us per burst, 40 GB/s
TRUE_SETUP, TRUE_PEAK = 9e-6, 40e9


def _fake_runs(runs, elem_bytes=8, *, codec_bits=None, compute_s=0.0, overlap=False,
               **_):
    t = sum(TRUE_SETUP + cal.wire_bytes(int(r), elem_bytes, codec_bits) / TRUE_PEAK
            for r in runs)
    return max(t, compute_s) if overlap else t + compute_s


def _fake_plan(plan, model, *, compute_s=0.0, overlap=False, **_):
    cb = getattr(plan, "codec_bits", None)
    kw = dict(codec_bits=cb, compute_s=compute_s, overlap=overlap)
    if hasattr(plan, "read_runs_by_port"):
        return max(_fake_runs(rr + wr, model.elem_bytes, **kw)
                   for rr, wr in zip(plan.read_runs_by_port, plan.write_runs_by_port))
    return _fake_runs(plan.read_runs + plan.write_runs, model.elem_bytes, **kw)


@pytest.fixture
def fake_timer(monkeypatch):
    """Both packages' harness replaced by the same deterministic function;
    the devices the port was asked to measure on are recorded."""
    devices = []

    def runs(*a, **kw):
        if "device" in kw:  # the port's call
            devices.append(kw["device"])
        return _fake_runs(*a, **kw)

    def plan(*a, **kw):
        if "device" in kw:
            devices.append(kw["device"])
        return _fake_plan(*a, **kw)

    for module in (cal, jcal):
        monkeypatch.setattr(module, "measure_runs", runs)
        monkeypatch.setattr(module, "measure_plan", plan)
        monkeypatch.setattr(module, "measurement_noise", lambda *a: 0.0)
    for module in (obs, jobs):
        monkeypatch.setattr(module, "measurement_noise", lambda *a: 0.0)
    return devices


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("models", MODELS, ids=MODEL_IDS)
def test_calibrate_equals_reference(models, overlap, fake_timer):
    model, jmodel = models
    mine = cal.calibrate(model, overlap=overlap, device="cpu")
    ref = jcal.calibrate(jmodel, overlap=overlap)
    assert [dataclasses.asdict(s) for s in mine.samples] == [
        dataclasses.asdict(s) for s in ref.samples]
    assert dataclasses.asdict(mine.fitted) == dataclasses.asdict(ref.fitted)
    assert mine.plan_errors == ref.plan_errors
    assert len(mine.plan_errors) == 12 * (2 if overlap else 1)
    assert mine.noise == ref.noise == 0.0
    assert set(fake_timer) == {"cpu"}
    # the fit recovers the deterministic device
    assert mine.fitted.setup_s == pytest.approx(TRUE_SETUP, rel=1e-9)
    assert mine.fitted.peak_bytes_per_s == pytest.approx(TRUE_PEAK, rel=1e-9)


@pytest.mark.parametrize("name,space,n_ports", [
    ("jacobi2d5p", (16, 32, 32), 1), ("jacobi2d5p", (16, 32, 32), 2),
    ("heat1d", (8, 64), 1), ("gaussian", (4, 32, 32), 1),
])
def test_autotune_measured_equals_reference(name, space, n_ports, fake_timer):
    kw = dict(budget=12, seed=0, score="measured", measure_top=3, n_ports=n_ports,
              cache=False)
    mine = cfa.autotune(name, space, bw.AXI_ZC706, measure_kwargs=dict(device="cpu"), **kw)
    ref = jcfa.autotune(name, space, jbw.AXI_ZC706, **kw)
    assert mine.evaluated == ref.evaluated and mine.score == ref.score == "measured"
    assert ([(s.candidate.key, s.time_s, s.measured_time_s, s.model_error)
             for s in mine.ranked]
            == [(s.candidate.key, s.time_s, s.measured_time_s, s.model_error)
                for s in ref.ranked])
    assert sum(s.measured_time_s is not None for s in mine.ranked) == 3
    assert mine.best_cfa().candidate.key == ref.best_cfa().candidate.key
    assert set(fake_timer) == {"cpu"}


CASES = [
    ("jacobi2d5p", (8, 8, 8), (4, 4, 4)),
    ("jacobi2d9p", (8, 8, 8), (4, 4, 4)),
    ("gaussian", (4, 16, 16), (2, 8, 8)),
    ("heat1d", (8, 8), (4, 4)),
    ("heat3d", (4, 4, 4, 4), (2, 2, 2, 2)),
]


def _both(name, space, tile, n_ports, storage="redundant"):
    backend = "sharded" if n_ports > 1 else "wavefront"
    mine = cfa.compile(name, space, layout=tile, backend=backend, n_ports=n_ports,
                       storage=storage, device="cpu")
    ref = jcfa.compile(name, space, layout=tile, backend=backend, n_ports=n_ports,
                       storage=storage)
    return mine, ref


@pytest.mark.parametrize("n_ports", [1, 2])
@pytest.mark.parametrize("name,space,tile", CASES, ids=[c[0] for c in CASES])
def test_report_measured_equals_reference(name, space, tile, n_ports, fake_timer):
    mine, ref = _both(name, space, tile, n_ports)
    got = mine.report(measured=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref.report(measured=True))
    assert got.measured_time_s > 0 and got.model_error is not None
    assert fake_timer == [torch.device("cpu")]


@pytest.mark.parametrize("storage", ["redundant", "irredundant"])
@pytest.mark.parametrize("n_ports", [1, 2])
@pytest.mark.parametrize("name,space,tile", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_runtime_report_equals_reference(name, space, tile, n_ports, storage, fake_timer):
    mine, ref = _both(name, space, tile, n_ports, storage)
    got, want = mine.runtime_report(), ref.runtime_report()
    assert got.to_dict() == want.to_dict()
    assert got.summary() == want.summary()
    assert got.rows and set(fake_timer) == {torch.device("cpu")}


def test_report_measured_reuses_the_measured_decision(tmp_path, fake_timer):
    compiled = cfa.compile(
        "jacobi2d5p", (16, 32, 32), backend="wavefront", device="cpu",
        autotune_kwargs=dict(budget=12, seed=0, score="measured", measure_top=2,
                             cache_dir=tmp_path))
    best = compiled.decision.best
    # compile names the stencil's device for the measured search
    assert set(fake_timer) == {torch.device("cpu")}
    assert best.measured_time_s is not None
    n = len(fake_timer)
    rep = compiled.report(measured=True)
    if best.candidate == compiled.layout:
        assert rep.measured_time_s == best.measured_time_s and len(fake_timer) == n
    else:
        assert len(fake_timer) == n + 1


# ---------------------------------------------------------------------------
# the real harness on the CPU: structure only
# ---------------------------------------------------------------------------


def test_measure_runs_on_the_cpu_is_positive_and_finite():
    t = cal.measure_runs((256,) * 4, 8, **CPU)
    assert t > 0.0 and math.isfinite(t)
    # one persistent buffer pair per (words, device), reused by every pass
    pair = cal._BUFFERS[(cal._wire_words(256, 8, None), "cpu")]
    cal.measure_runs((256,), 8, **CPU)
    assert cal._BUFFERS[(cal._wire_words(256, 8, None), "cpu")] is pair
    assert pair[0].dtype == torch.float32 and pair[1].device.type == "cpu"


def test_measure_runs_empty_schedule_is_free():
    assert cal.measure_runs((), 8, **CPU) == 0.0
    assert cal.measure_runs((), 8, device="cuda") == 0.0  # nothing to issue


@pytest.mark.parametrize("kw,match", [
    (dict(runs=(0, 4)), "positive"),
    (dict(runs=(4,), compute_s=-1e-3), "compute_s"),
    (dict(runs=(4,), repeats=0), "repeats"),
    (dict(runs=(4,), warmup=-1), "warmup"),
], ids=["zero-length", "negative-compute", "repeats", "warmup"])
def test_measure_runs_rejects_bad_arguments(kw, match):
    args = dict(CPU, **kw)
    with pytest.raises(ValueError, match=match):
        cal.measure_runs(args.pop("runs"), 8, **args)


def test_compute_only_pass_takes_the_compute_time():
    for overlap in (False, True):
        assert cal.measure_runs((), 8, warmup=0, repeats=1, compute_s=5e-4,
                                overlap=overlap, device="cpu") >= 5e-4


@pytest.mark.parametrize("overlap", [False, True])
def test_measure_spans_and_counters(overlap):
    rec = TraceRecorder()
    cal.measure_runs((64,) * 5, 4, warmup=2, repeats=3, overlap=overlap, recorder=rec,
                     label="sched", device="cpu")
    passes = [s for s in rec.spans if s.name == "measure_pass"]
    summary = [s for s in rec.spans if s.name == "measure"]
    assert len(passes) == 3 and len(summary) == 1
    assert {s.cat for s in passes + summary} == {"measure"}
    assert all(s.track == "measure/sched" and s.arg("n_bursts") == 5
               and s.arg("wire_bytes") == 5 * 64 * 4 and s.arg("overlap") is overlap
               for s in passes)
    assert summary[0].arg("repeats") == 3 and summary[0].arg("warmup") == 2
    assert rec.counters["measure_passes"] == 3 and rec.counters["measure_schedules"] == 1


def test_ported_plan_is_measured_once_per_port():
    pp = PortedPlan(scheme="cfa", n_ports=3, strategy="facet-lpt",
                    read_runs_by_port=((64, 64), (32,), (128,)),
                    write_runs_by_port=((16,), (), (8,)),
                    read_useful=288, write_useful=24)
    rec = TraceRecorder()
    t = cal.measure_plan(pp, bw.AXI_ZC706, recorder=rec, **CPU)
    summary = [s for s in rec.spans if s.name == "measure"]
    assert sorted(s.arg("label") for s in summary) == [
        "plan:cfa/port0", "plan:cfa/port1", "plan:cfa/port2"]
    assert [s.arg("n_bursts") for s in sorted(summary, key=lambda s: s.arg("label"))] == [
        3, 1, 2]
    assert t == max(s.arg("median_s") for s in summary)


def test_calibrate_on_the_cpu_holds_its_structure():
    c = cal.calibrate(bw.H100_HBM3, programs=("jacobi2d5p",), storages=("redundant",),
                      ports=(1, 2), lengths=(1, 64, 4096), counts=(1, 4), **CPU)
    assert len(c.samples) == 3 * 2 + 2 and len(c.plan_errors) == 2
    assert c.target == "h100-hbm3" and c.fitted.base_name == "h100-hbm3"
    assert c.fitted.setup_s >= 0.0 and 0.0 < c.fitted.peak_bytes_per_s < math.inf
    assert all(r["measured_s"] > 0.0 for r in c.plan_errors)
    assert cal.Calibration.from_json(c.to_json()) == c
    assert dict(c.host)["device"] in ("cpu", torch.cuda.get_device_name(0)
                                      if torch.cuda.is_available() else "cpu")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card behaviour")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cal.measure_runs((4,), 8, warmup=0, repeats=1)
    plan = cfa.compile("jacobi2d5p", (8, 8, 8), layout=(4, 4, 4), device="cpu").plan
    with pytest.raises(RuntimeError, match="CUDA device"):
        cal.measure_plan(plan, bw.AXI_ZC706, warmup=0, repeats=1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cal.calibrate(bw.H100_HBM3, programs=(), lengths=(8,), counts=(1,))


def test_timing_probe_per_device_and_escape_hatch(monkeypatch):
    obs._timing_probe.cache_clear()
    try:
        monkeypatch.setenv("REPRO_TIMING_TESTS", "force")
        assert cal.timing_unusable_reason("cpu") is None
        assert cal.measurement_noise("cpu") == 0.0
        monkeypatch.setenv("REPRO_TIMING_TESTS", "skip")
        obs._timing_probe.cache_clear()
        assert "REPRO_TIMING_TESTS" in cal.timing_unusable_reason("cpu")
        assert cal.measurement_noise(torch.device("cpu")) == 1.0
        if not torch.cuda.is_available():
            monkeypatch.delenv("REPRO_TIMING_TESTS")
            obs._timing_probe.cache_clear()
            assert "harness failed" in cal.timing_unusable_reason("cuda")
    finally:
        obs._timing_probe.cache_clear()


def test_no_buffer_is_made_at_import():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.core.cfa, sys as s; "
            "m = s.modules['repro_torch.core.cfa.calibrate']; "
            "print(len(m._BUFFERS))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "0"


# ---------------------------------------------------------------------------
# the autotune cache key with a device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a,b", [
    ("cuda", torch.device("cuda")), ("cpu", torch.device("cpu")),
    (torch.device("cuda"), "cuda:0"),
], ids=["cuda", "cpu", "cuda-index"])
def test_cache_key_names_a_device_alike(a, b):
    if torch.cuda.is_available() and torch.cuda.current_device() != 0:
        pytest.skip("the current card is not card 0")
    ka, kb = at._measure_key(dict(device=a, repeats=3)), at._measure_key(
        dict(repeats=3, device=b))
    assert ka == kb and json.loads(json.dumps(ka)) == [list(x) for x in ka]
    prog, sp = cfa.get_program("jacobi2d5p"), cfa.IterSpace((8, 8, 8))
    key = [at._cache_key(prog, sp, bw.AXI_ZC706, 0, 8, None, ("intra-tile",), None, 2, 1,
                         ("facet-lpt",), "redundant", None, 0.0, "measured", 2,
                         dict(device=d), False, 0.0, (("p", "1"),)) for d in (a, b)]
    assert key[0] == key[1]


def test_measured_decision_caches_under_a_device(tmp_path, fake_timer):
    kw = dict(budget=8, seed=0, score="measured", measure_top=2, cache_dir=tmp_path)
    first = cfa.autotune("heat1d", (8, 64), bw.AXI_ZC706,
                         measure_kwargs=dict(device=torch.device("cpu")), **kw)
    again = cfa.autotune("heat1d", (8, 64), bw.AXI_ZC706,
                         measure_kwargs=dict(device="cpu"), **kw)
    assert not first.from_cache and again.from_cache
    assert again.ranked == first.ranked
