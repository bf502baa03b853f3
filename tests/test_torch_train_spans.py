"""The training path's spans (``obs.TraceRecorder`` installed by
``Trainer(recorder=...)``) and the repaired ``metrics_log`` ``dt``, on the
CPU.

* The process-wide recorder (``repro_torch.runtime``): none by default,
  ``installed()`` sets it for every thread (a plain global: autograd's
  device thread inherits no context), a span site without one enters the
  one shared ``NO_SPAN``.
* Spans keep the native id of their thread and the span open on it when
  they began; ``unix_us`` puts them on the clock of ``torch.profiler``'s
  Chrome trace (``ts`` + ``baseTimeNanoseconds``), and ``to_chrome`` gives
  its time zero on that clock.
* A 2-layer MoE ``Trainer`` records each phase once a step, nested in its
  parent, and ``moe.dispatch``/``moe.combine`` once a layer in the forward
  and once in the remat recompute; without a recorder it computes the same
  bits.
"""
import collections
import dataclasses
import json
import threading
import time

import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch import runtime
from repro_torch.core.cfa import obs
from repro_torch.models.lm import param_leaves
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import TrainHParams

STEP_CHILDREN = ("train.feed", "train.to_device", "train.forward", "train.backward",
                 "train.clip", "train.optimizer")


@pytest.fixture(autouse=True)
def flush_denormal():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _moe_trainer(tmp_path, recorder=None, **kw):
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), n_layers=2)
    return Trainer(cfg, batch=2, seq=16, ckpt_dir=tmp_path, hp=TrainHParams(), device="cpu",
                   recorder=recorder, **kw)


def test_no_recorder_is_active_by_default():
    assert runtime.active() is None


def test_installed_recorder_is_seen_by_every_thread_and_removed_after():
    rec = obs.TraceRecorder()
    seen = []
    with rec.installed():
        assert runtime.active() is rec
        worker = threading.Thread(target=lambda: seen.append(runtime.active()))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        inner = obs.TraceRecorder()
        with inner.installed():
            assert runtime.active() is inner
        assert runtime.active() is rec
    assert seen == [rec]
    assert runtime.active() is None


def test_a_span_site_without_a_recorder_enters_one_shared_no_op():
    assert runtime.train_span(None, "train.step", step=3) is runtime.NO_SPAN
    assert runtime.train_span(None, "moe.dispatch") is runtime.NO_SPAN
    with runtime.train_span(None, "train.forward"):
        pass


def test_spans_keep_their_thread_and_parent():
    rec = obs.TraceRecorder()
    with runtime.train_span(rec, "train.step", step=1):
        with runtime.train_span(rec, "train.forward"):
            done = []

            def recompute():
                with runtime.train_span(rec, "moe.dispatch"):
                    done.append(threading.get_native_id())

            worker = threading.Thread(target=recompute)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    by = {s.name: s for s in rec.spans}
    me = threading.get_native_id()
    assert by["train.step"].tid == me and by["train.step"].parent == -1
    assert by["train.step"].arg("step") == 1 and by["train.step"].cat == "train"
    assert by["train.forward"].parent == by["train.step"].sid
    assert by["moe.dispatch"].tid == done[0] != me and by["moe.dispatch"].parent == -1
    assert by["train.forward"].to_dict()["parent"] == by["train.step"].sid
    assert rec.threads[me] == threading.get_ident() and set(rec.threads) == {me, done[0]}


def test_unix_clock_follows_time_time_ns_across_clock_marks():
    rec = obs.TraceRecorder()
    for _ in range(3):
        time.sleep(0.01)
        rec.mark_clock()
        before = time.time_ns() / 1e3
        t = rec.now() - rec.epoch
        after = time.time_ns() / 1e3
        assert before - 50 <= rec.unix_us(t) <= after + 50
    assert len(rec._clock) == 4


def test_a_span_contains_the_profiler_marker_on_the_converted_clock(tmp_path):
    """A ``record_function`` marker inside a recorder span, under a CPU
    ``torch.profiler``: the marker's ``ts`` + ``baseTimeNanoseconds`` lies
    within the span's Unix interval, to 0.5 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = obs.TraceRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with runtime.train_span(rec, "train.step", step=1):
            with record_function("marker"):
                torch.ones(64).add_(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    obj = json.loads(path.read_text())
    base = float(obj.get("baseTimeNanoseconds", 0)) / 1e3
    (ev,) = [e for e in obj["traceEvents"] if e.get("name") == "marker"]
    (span,) = rec.spans
    start = rec.unix_us(span.t0)
    end = start + span.dur * 1e6
    ts = float(ev["ts"]) + base
    assert start - 500 <= ts and ts + float(ev["dur"]) <= end + 500
    assert ev["tid"] == span.tid


def test_to_chrome_keeps_its_schema_and_gives_its_time_zero_on_the_unix_clock():
    rec = obs.TraceRecorder(label="train")
    with runtime.train_span(rec, "train.step", step=1):
        with runtime.train_span(rec, "train.feed"):
            pass
    obj = rec.to_chrome()
    assert obs.validate_chrome_trace(obj) == []
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert {e["cat"] for e in xs} == {"train"} and min(e["ts"] for e in xs) == 0
    t_min = min(s.t0 for s in rec.spans)
    assert obj["otherData"]["ts0_unix_us"] == rec.unix_us(t_min)
    assert abs(obj["otherData"]["ts0_unix_us"] - time.time_ns() / 1e3) < 5e6


def test_trainer_records_each_phase_once_a_step_nested_in_its_parent(tmp_path):
    rec = obs.TraceRecorder()
    tr = _moe_trainer(tmp_path, rec, ckpt_every=2)
    try:
        tr.run(2, log_every=1)
    finally:
        tr.data.close()
    assert runtime.active() is None
    spans = rec.find(cat="train")
    assert spans == rec.spans
    by_id = {s.sid: s for s in spans}
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.arg("step") for s in steps] == [1, 2]

    def inside(child, parent):
        return parent.t0 <= child.t0 and child.t0 + child.dur <= parent.t0 + parent.dur

    for step in steps:
        kids = collections.Counter(s.name for s in spans if s.parent == step.sid)
        assert {n: kids[n] for n in STEP_CHILDREN + ("train.log", "train.preempt")} == \
            dict.fromkeys(STEP_CHILDREN + ("train.log", "train.preempt"), 1)
        assert kids["train.checkpoint"] == (step.arg("step") == 2)
        forward = next(s for s in spans if s.name == "train.forward" and s.parent == step.sid)
        backward = next(s for s in spans if s.name == "train.backward" and s.parent == step.sid)
        loss = [s for s in spans if s.name == "train.loss" and s.parent == forward.sid]
        assert len(loss) == 1
        for name in ("moe.dispatch", "moe.combine"):  # a layer each, forward and recompute
            assert sum(s.name == name and s.parent == forward.sid for s in spans) == 2
            assert sum(s.name == name and s.parent == backward.sid for s in spans) == 2
    for s in spans:
        assert s.tid == threading.get_native_id()
        if s.parent >= 0:
            assert inside(s, by_id[s.parent]), (s.name, by_id[s.parent].name)


def test_trainer_without_a_recorder_computes_the_same_bits(tmp_path):
    logs, params = [], []
    for i, rec in enumerate((obs.TraceRecorder(), None)):
        tr = _moe_trainer(tmp_path / str(i), rec, seed=3)
        try:
            log = tr.run(2, log_every=1)
        finally:
            tr.data.close()
        logs.append([(m["loss"], m["grad_norm"]) for m in log])
        params.append([p.detach().clone() for leaf in param_leaves(tr.model) for p in leaf.parts])
    assert logs[0] == logs[1]
    assert all(torch.equal(a, b) for a, b in zip(*params))


@pytest.mark.parametrize("log_every", [1, 2, 3])
def test_metrics_log_dt_times_steps_sums_to_the_run_s_wall(tmp_path, log_every):
    """``dt`` is the seconds a step since the previous log (the run's start
    for the first), so dt x steps over the logs sums to the run's wall."""
    tr = _moe_trainer(tmp_path)
    try:
        tr.run(1, log_every=1)  # first-call set-up outside the timed run
        t0 = time.perf_counter()
        log = tr.run(4, log_every=log_every)[1:]
        wall = time.perf_counter() - t0
    finally:
        tr.data.close()
    steps = [m["step"] for m in log]
    assert steps == [s for s in range(2, 6) if s % log_every == 0 or s == 5]
    gone = [b - a for a, b in zip([1] + steps, steps)]
    total = sum(m["dt"] * n for m, n in zip(log, gone))
    assert abs(total - wall) <= 0.05 * wall
