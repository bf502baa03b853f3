"""The ``train`` driver: a cell whose work is training steps through the
program's own entry, ``repro_torch.train.loop.Trainer.run``, as a user runs
it.

Set-up builds one ``Trainer`` (a fresh checkpoint directory under
``$TMPDIR`` and no checkpoint inside the window), gives it the benchmark's
weights (:mod:`bench.inputs`) and a feed of the benchmark's token batches
(the program's ``SyntheticTokens`` pipeline, prefetch thread and all, with
the batches drawn by :func:`bench.inputs.tokens`), and drives it through
its first ``check_steps`` steps with ``run(1)`` and ``run(check_steps - 1)``.
Those steps warm up every shape the window uses and are the steps the plain
reference follows: their losses, the first step's clipped gradient as the
optimizer got it (its first moment after one step, over ``1 - b1``) and the
parameters' change over all of them, by part of each leaf.  The window then
calls ``run(chunk_steps)`` until ``--seconds`` have passed; the trainer's
log at each chunk's end and a synchronize close it.  With ``--trace 1``
the window is ``plain_chunks`` such chunks timed alone, then
``trace_steps`` steps under ``torch.profiler`` recording the device's
activity.

Once the window has closed and the program's state is freed, the reference
(``bench/reference/<config's reference>.py``) runs the same steps from the
same weights and batches in float32, and :func:`gaps` compares.
"""
from __future__ import annotations

import gc
import math
import shutil
import statistics
import tempfile
import time

import torch

from bench import inputs, registry
from bench.trace import Trace, read_chrome_trace

__all__ = ["run", "check_leaves", "make_trainer", "program_readings", "reference_readings", "gaps"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _arch_config(arch: dict):
    from repro_torch.models.config import ArchConfig

    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})


def check_leaves(have: dict, specs: list) -> None:
    """Raise where the program's parameters ``have`` (key -> shape) are not
    the benchmark's leaves ``specs`` (:func:`bench.inputs.config_specs`),
    naming the keys and shapes on each side alone."""
    want = {key: tuple(shape) for key, shape, _, _ in specs}
    have = {key: tuple(shape) for key, shape in have.items()}
    if have != want:
        raise RuntimeError(f"the program's parameters differ from the benchmark's weights: "
                           f"only the program's {sorted(set(have.items()) - set(want.items()))}, "
                           f"only the benchmark's {sorted(set(want.items()) - set(have.items()))}")


def make_trainer(config: dict, mix: dict, seed: int, device, ckpt_dir):
    """The program's ``Trainer`` on the cell's shapes with the benchmark's
    feed and weights."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import TrainHParams

    arch, batch, seq = config["arch"], config["batch"], mix["seq"]
    specs = inputs.config_specs(config)

    class Feed(SyntheticTokens):
        """The program's prefetching pipeline over the benchmark's batches."""

        def batch_at(self, step):
            return {"tokens": inputs.tokens(self.seed, step, self.batch, self.seq, self.vocab)}

    feed = Feed(vocab=arch["vocab"], batch=batch, seq=seq, seed=seed)
    trainer = Trainer(_arch_config(arch), batch=batch, seq=seq, ckpt_dir=ckpt_dir,
                      hp=TrainHParams(**config["hparams"]), seed=seed, ckpt_every=10 ** 9,
                      data=feed, device=device)
    leaves = _leaves(trainer)
    check_leaves({key: leaf.shape for key, leaf in leaves.items()}, specs)
    for key, value in inputs.iter_weights(specs, seed, trainer.device):
        leaves[key].assign(value)
    return trainer


def _leaves(trainer) -> dict:
    return {"/".join(leaf.path): leaf for leaf in trainer.leaves}


def _part_norms(leaf, t: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(v) for v in leaf.views(t)])


def program_readings(trainer, config: dict, mix: dict, seed: int) -> tuple[dict, float]:
    """Drive the trainer through its first ``check_steps`` steps; return
    their readings and the seconds spent reading (not set-up)."""
    n = mix["check_steps"]
    b1 = config["adamw"]["b1"]
    trainer.run(1, log_every=1)
    t0 = time.perf_counter()
    leaves = _leaves(trainer)
    first = {key: (_part_norms(leaf, m) / (1 - b1)).tolist()
             for (key, leaf), m in zip(leaves.items(), trainer.opt_state.mu)}
    clip = min(1.0, config["hparams"]["clip_norm"] / (trainer.metrics_log[-1]["grad_norm"] + 1e-9))
    raw = {key: [v / clip for v in norms] for key, norms in first.items()}
    spent = time.perf_counter() - t0
    trainer.run(n - 1, log_every=1)
    t0 = time.perf_counter()
    update = {}
    with torch.no_grad():
        for key, start in inputs.iter_weights(inputs.config_specs(config), seed,
                                              trainer.device):
            leaf = leaves[key]
            update[key] = torch.stack([torch.linalg.vector_norm(p - s) for p, s in
                                       zip(leaf.parts, leaf.views(start))]).tolist()
            del start
    log = trainer.metrics_log[-n:]
    return {"loss": [m["loss"] for m in log], "grad_norm": [m["grad_norm"] for m in log],
            "first_grad": first, "raw_grad": raw, "update": update}, \
        spent + time.perf_counter() - t0


def reference_readings(config: dict, mix: dict, seed: int, device, *,
                       precision: str = "float32", half_batch: bool = False) -> dict:
    """The plain reference's readings over the same steps, weights and
    batches (``precision``/``half_batch``: the control and a fault)."""
    arch = config["arch"]
    ref = registry.reference(config["reference"])
    batches = [inputs.tokens(seed, s, config["batch"], mix["seq"], arch["vocab"])
               for s in range(mix["check_steps"])]
    return ref.train_steps(arch, config["hparams"], config["adamw"],
                           inputs.weights(inputs.config_specs(config), seed, device), batches,
                           precision=precision, half_batch=half_batch,
                           rows=config["reference_rows"])


def _worst(values) -> float:
    """The largest value; infinite where one is not finite (a NaN read by
    either side fails every limit)."""
    values = list(values)
    return math.inf if not all(math.isfinite(v) for v in values) else max(values)


def _part_gaps(prog: dict, ref: dict, key: str, parts: list) -> tuple[float, float]:
    """(worst, median) over ``parts`` of the gap between the two norms of
    ``key``, each against the larger of the reference's norm of that part
    and its median part's."""
    med = statistics.median(ref[key][k][i] for k, i in parts)
    found = [abs(prog[key][k][i] - ref[key][k][i]) / max(ref[key][k][i], med) for k, i in parts]
    worst = _worst(found)
    return worst, statistics.median(found) if math.isfinite(worst) else math.inf


def _layer_gap(prog: list, ref: list) -> float:
    """The median layer's gap between the two norms of a leaf stacked by
    layer, each against the larger of that layer's reference norm and the
    leaf's median layer's: a fault in the leaf's gradient moves it in every
    layer, a spike in a few layers does not move the median."""
    med = statistics.median(ref)
    found = [abs(p - r) / max(r, med) for p, r in zip(prog, ref)]
    return statistics.median(found) if all(math.isfinite(v) for v in found) else math.inf


def gaps(prog: dict, ref: dict) -> dict:
    """Every number a cell may compare (its configuration's ``limits`` say
    which): the worst step's relative loss gap; by part of each leaf, the
    worst gap between the two first-gradient norms as the optimizer got
    them (after clipping), the median gap between the two first-gradient
    norms before clipping (the program's over its own clipping factor, from
    its logged norm), and the worst gap between the two parameter-change
    norms; each against the larger of the reference's norm of that part and
    its median part's.  For each leaf stacked by layer, by its path within
    a period, ``raw_grad_layer_gap.<path>`` (:func:`_layer_gap` of the
    first gradient before clipping).  Parts whose reference gradient is
    under a thousandth of the median part's (nought to rounding) are left
    out of the change."""
    loss = _worst(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    parts = [(k, i) for k in sorted(ref["first_grad"]) for i in range(len(ref["first_grad"][k]))]
    med_g = statistics.median(ref["first_grad"][k][i] for k, i in parts)
    kept = [(k, i) for k, i in parts if ref["first_grad"][k][i] >= 1e-3 * med_g]
    out = {"loss_gap": loss, "first_grad_gap": _part_gaps(prog, ref, "first_grad", parts)[0],
           "raw_grad_median_gap": _part_gaps(prog, ref, "raw_grad", parts)[1],
           "update_gap": _part_gaps(prog, ref, "update", kept)[0],
           "parts_left_out": len(parts) - len(kept)}
    for k in sorted(ref["raw_grad"]):
        if k.startswith("periods/") and len(ref["raw_grad"][k]) > 1:
            path = k.split("/", 2)[2]
            out[f"raw_grad_layer_gap.{path}"] = _layer_gap(prog["raw_grad"][k], ref["raw_grad"][k])
    return out


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _finite(logged: dict) -> bool:
    """The trainer's log of a chunk's last step holds a finite loss and
    gradient norm (else the chunk's steps count as failed)."""
    return math.isfinite(logged["loss"]) and math.isfinite(logged["grad_norm"])


def run(r) -> dict:
    """One run of a training cell (``r``: :class:`bench.run.Run`)."""
    config, mix, device = r.config, r.mix, r.device
    cuda = torch.device(device).type == "cuda"
    batch, seq = config["batch"], mix["seq"]
    ckpt_dir = tempfile.mkdtemp(prefix="bench-ckpt-")
    try:
        trainer = make_trainer(config, mix, r.seed, device, ckpt_dir)
        prog, reading_s = program_readings(trainer, config, mix, r.seed)
        _sync(device)
        setup_s = time.perf_counter() - r.t_start - reading_s
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        trace = None
        steps, failed = 0, 0
        if r.trace:
            from torch.profiler import ProfilerActivity, profile

            # first ``plain_chunks`` chunks without the profiler, whose pace
            # the step's MFU and idle share read: the profiler slows the
            # host, and the host paces a step
            k, n_plain = mix["chunk_steps"], mix["plain_chunks"]
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n_plain):
                log = trainer.run(k, log_every=k)
                failed += 0 if _finite(log[-1]) else k
            _sync(device)
            plain_s = time.perf_counter() - t0
            # the device's activity only (kernels, copies, CUDA runtime
            # calls): recording every host operator as well slows a
            # host-paced step by half or more
            acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
            with profile(activities=acts) as prof:
                _sync(device)
                t0 = time.perf_counter()
                log = trainer.run(mix["trace_steps"], log_every=mix["trace_steps"])
                _sync(device)
                window_s = time.perf_counter() - t0
            steps = k * n_plain + mix["trace_steps"]
            failed += 0 if _finite(log[-1]) else mix["trace_steps"]
        else:
            k = mix["chunk_steps"]
            _sync(device)
            t0 = time.perf_counter()
            ends = [t0]
            while True:
                log = trainer.run(k, log_every=k)
                _sync(device)
                ends.append(time.perf_counter())
                steps += k
                if not _finite(log[-1]):
                    failed += k
                if time.perf_counter() - t0 >= r.seconds:
                    break
            window_s = time.perf_counter() - t0
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if r.trace:
            kernels, device_ops, host_ops = read_chrome_trace(prof)
            del prof
            trace = Trace(kind="train", kernels=kernels, device_ops=device_ops,
                          host_ops=host_ops, steps=mix["trace_steps"], window_s=window_s,
                          plain_steps=k * n_plain, plain_s=plain_s,
                          arch=config["arch"], batch=batch, seq=seq, peak_bytes=window_peak)
        trainer.data.close()
        del trainer, log
        _free(device)
        ref = reference_readings(config, mix, r.seed, device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    found = gaps(prog, ref)
    limits = config["limits"]
    checks = {name: (found[name], limit) for name, limit in limits.items()}
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return {
        "correct": correct, "attempted": steps, "failed": failed,
        "metrics": {"train_tokens_per_s": steps * batch * seq / window_s, "setup_s": setup_s},
        "memory_peak_bytes": max(peak, window_peak), "trace": trace, "checks": checks,
        "notes": {"gaps": found, "window_s": window_s,
                  "plain_s": plain_s if r.trace else None,
                  "chunk_s": [] if r.trace else [e - s for s, e in zip(ends, ends[1:])],
                  "steps": steps, "reading_s": reading_s},
    }
