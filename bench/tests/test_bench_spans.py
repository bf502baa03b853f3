"""``bench.spans``: the Chrome trace's clock, thread and correlation ids,
and where device time and idle gaps go among the program's spans
(:class:`bench.spans.Attribution`), on hand-built traces; and one profiled
window at a CPU test's size with the recorder in the trainer."""
from __future__ import annotations

import pytest

from bench import registry
from bench.spans import Attribution, Event, parse, phases, spans_of

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]
TRAINER, AUTOGRAD = 101, 202


def _window(spans, calls, device) -> tuple[Attribution, list]:
    """One step: ``calls`` (tid, start us, correlation) launch the
    ``device`` kernels (start us, length us, correlation)."""
    calls = [Event("call", "cudaLaunchKernel", s, 1.0, tid=tid, correlation=c)
             for tid, s, c in calls]
    ops = [Event("kernel", f"kernel{c}", s, d, correlation=c) for s, d, c in device]
    return Attribution.of(spans, calls, ops), ops


SPANS = [("moe.dispatch", TRAINER, 15.0, 20.0, 1), ("train.forward", TRAINER, 10.0, 40.0, 1),
         ("moe.dispatch", AUTOGRAD, 50.0, 55.0, 1), ("train.backward", TRAINER, 45.0, 80.0, 1),
         ("train.optimizer", TRAINER, 85.0, 95.0, 1), ("train.step", TRAINER, 0.0, 100.0, 1)]
CALLS = [(TRAINER, 16.0, 1), (TRAINER, 30.0, 2), (AUTOGRAD, 52.0, 3), (AUTOGRAD, 60.0, 4),
         (TRAINER, 90.0, 5), (TRAINER, 98.0, 6), (TRAINER, 120.0, 7)]
DEVICE = [(17.0, 2.0, 1), (31.0, 4.0, 2), (53.0, 8.0, 3), (61.0, 16.0, 4), (91.0, 32.0, 5),
          (123.0, 64.0, 6), (187.0, 128.0, 7)]


def test_a_launch_goes_to_the_innermost_span_on_its_thread():
    a, _ = _window(SPANS, CALLS, DEVICE)
    names = [a.name(i) for i in a.device]
    assert names[:3] == ["moe.dispatch", "train.forward", "moe.dispatch"]
    assert a.chains[2] == ("train.step", "train.backward", "moe.dispatch")  # the recompute
    assert a.chains[0] == ("train.step", "train.forward", "moe.dispatch")
    assert names[4:6] == ["train.optimizer", "train.step"]


def test_a_launch_from_a_thread_with_no_span_open_goes_to_the_trainer_s():
    a, _ = _window(SPANS, CALLS, DEVICE)
    assert a.name(a.device[3]) == "train.backward"
    assert a.device[6] is None and a.launches_outside == 1  # after the step closed


def test_the_phases_read_device_time_launched_inside_each():
    a, ops = _window(SPANS, CALLS, DEVICE)
    got = phases(a, ops, 1)
    assert got["forward_ms_per_step"] == pytest.approx((2 + 4) / 1e3)
    assert got["backward_ms_per_step"] == pytest.approx((8 + 16) / 1e3)
    assert got["optimizer_ms_per_step"] == pytest.approx(32 / 1e3)
    assert got["moe_dispatch_ms_per_step"] == pytest.approx((2 + 8) / 1e3)
    assert phases(a, ops, 2)["forward_ms_per_step"] == pytest.approx(3 / 1e3)
    a, ops = _window([s for s in SPANS if s[0] != "moe.dispatch"], CALLS, DEVICE)
    assert phases(a, ops, 1)["moe_dispatch_ms_per_step"] is None  # no MoE (mamba2)


def test_an_idle_gap_goes_to_the_trainer_s_span_open_when_it_began():
    a, ops = _window(SPANS, CALLS, DEVICE)
    assert [(s, e, a.name(i)) for s, e, i in a.gaps] == [
        (19.0, 31.0, "moe.dispatch"), (35.0, 53.0, "train.forward"),
        (77.0, 91.0, "train.backward")]
    # none began outside forward, backward, clip and optimizer
    assert phases(a, ops, 1)["trainer_idle_ms_per_step"] == 0.0
    a, ops = _window(SPANS + [("train.log", TRAINER, 96.0, 99.0, 1)], CALLS,
                     DEVICE[:4] + [(91.0, 5.0, 5), (97.5, 1.0, 6)])
    assert phases(a, ops, 1)["trainer_idle_ms_per_step"] == pytest.approx(1.5 / 1e3)


def test_the_table_puts_every_launch_somewhere():
    a, ops = _window(SPANS, CALLS, DEVICE)
    got = phases(a, ops, 1)
    ms = got["ms_per_step"]
    assert ms["moe.dispatch"]["device_ms"] == pytest.approx(0.010)
    assert ms["train.backward"] == {"device_ms": pytest.approx(0.016),
                                    "idle_ms": pytest.approx(0.014)}
    assert ms["(outside spans)"]["device_ms"] == pytest.approx(0.128)
    assert got["launches_outside_spans"] == 1
    assert got["kernel_pct_in_spans"] == pytest.approx(100 * 126 / 254)
    assert got["kernel_pct_in_phases"] == pytest.approx(100 * 62 / 254)


def test_without_spans_every_launch_is_outside():
    a, ops = _window([], CALLS, DEVICE)
    got = phases(a, ops, 1)
    assert got["launches_outside_spans"] == 7 and got["kernel_pct_in_spans"] == 0.0
    assert got["moe_dispatch_ms_per_step"] is None
    assert got["forward_ms_per_step"] == 0.0


def test_the_chrome_trace_keeps_its_base_threads_and_correlations():
    obj = {"baseTimeNanoseconds": 1_790_000_000_000_000_000, "traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10.5, "dur": 2,
         "pid": 1, "tid": 77, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 3, "pid": 0, "tid": 7,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30, "dur": 1, "pid": 0,
         "tid": 7, "args": {"correlation": 10}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 5, "dur": 1, "tid": 77},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 10.5, "id": 9}]}
    device, calls, base = parse(obj)
    assert base == 1_790_000_000_000_000.0
    assert calls == [Event("call", "cudaLaunchKernel", 10.5, 2.0, tid=77, correlation=9)]
    assert device == [Event("kernel", "k", 20.0, 3.0, tid=7, correlation=9),
                      Event("copy", "Memcpy HtoD", 30.0, 1.0, tid=7, correlation=10)]
    # a file whose ts are absolute Unix microseconds counts from 0
    for ev in obj["traceEvents"]:
        ev["ts"] += 1_790_000_000_000_000
    assert parse(obj)[2] == 0.0
    assert parse({"traceEvents": obj["traceEvents"]})[2] == 0.0


def test_span_threads_take_the_ids_the_trace_s_cuda_calls_carry():
    """A profiler recording the CUDA activity alone writes CUPTI's thread id
    on a CUDA call (the pthread id's low 32 bits, signed, without the sign:
    the card read 0x7ED89D00 for pthread 0x7f6581276300 and 0x329FF6C0 for
    0x7f62329ff6c0); with CPU activity, the native id.  The spans take
    whichever the trace's calls carry."""
    from types import SimpleNamespace

    from bench.spans import cupti_tid

    assert cupti_tid(0x7F65_8127_6300) == 0x7ED8_9D00
    assert cupti_tid(0x7F62_329F_F6C0) == 0x329F_F6C0
    span = SimpleNamespace(name="train.step", cat="train", tid=7, t0=1.0, dur=0.5,
                           arg=lambda key: 4)
    rec = SimpleNamespace(spans=[span], threads={7: 0x7F65_8127_6300},
                          unix_us=lambda t: 1e6 * t + 100.0)
    cupti = [Event("call", "cudaLaunchKernel", 0.0, 1.0, tid=0x7ED8_9D00)]
    assert spans_of(rec, 50.0, cupti) == [("train.step", 0x7ED8_9D00, 1e6 + 50.0,
                                           1.5e6 + 50.0, 4)]
    native = [Event("call", "cudaLaunchKernel", 0.0, 1.0, tid=7)]
    assert spans_of(rec, 50.0, native)[0][1] == 7


def test_a_profiled_window_records_the_steps_spans_on_the_trace_s_clock(tmp_path):
    """At a CPU test's size (a CPU profiler: no CUDA calls to attribute):
    the window's spans, one ``train.step`` a step with its phases inside,
    on the clock of the profiler's events."""
    from bench.drivers import train
    from bench.spans import profile_window
    from bench.tests.test_bench_correctness import SEED, _small
    from repro_torch.core.cfa import obs

    cell = next(c for c in CELLS if c.startswith("olmoe"))
    config, mix = _small(cell)
    trainer = train.make_trainer(config, mix, SEED, "cpu", tmp_path)
    try:
        trainer.run(1, log_every=1)
        rec = obs.TraceRecorder()
        obj, window_s = profile_window(trainer, 2, rec, "cpu")
    finally:
        trainer.data.close()
    assert trainer.recorder is None and window_s > 0
    device, calls, base = parse(obj)
    spans = spans_of(rec, base, calls)
    assert [s[4] for s in spans if s[0] == "train.step"] == [2, 3]
    assert sum(s[0] == "moe.dispatch" for s in spans) == 2 * 2 * 2  # layers x (fwd, recompute)
    ops = [e["ts"] for e in obj["traceEvents"] if e.get("cat") == "cpu_op" and "dur" in e]
    first, last = min(s[2] for s in spans), max(s[3] for s in spans)
    assert first - 5e3 <= min(ops) and max(ops) <= last + 5e3
