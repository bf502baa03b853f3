"""The port's checkpointing (``repro_torch.checkpoint``) and training data
(``repro_torch.data``) against the reference's, on the CPU.

* ``CheckpointManager``: the reference's ``tests/test_train.py`` cases
  (keep-last-k, a wrong tree is rejected — with the reference's messages);
  a round trip is bit-exact (float32, int32, bfloat16 held as float32);
  ``step_N.tmp`` is never listed; the files and the manifest's keys are the
  reference's; and a port ``Trainer``'s checkpoint restores into the
  reference's own ``CheckpointManager`` against the reference's
  ``(params, opt_state)`` of the same configuration — the same leaves, in
  the same order, with the same values.
* ``SyntheticTokens``/``PackedDocs``: batches bit-equal to the reference's
  for the same seeds and steps, through ``batch_at``, ``next``, ``seek`` and
  the deadline skip.
"""
import dataclasses
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import PackedDocs as JaxPackedDocs
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models.lm import init_lm as jax_init_lm
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import PackedDocs, SyntheticTokens
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import TrainHParams


def test_checkpoint_keep_last_k(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, [torch.arange(4.0)], blocking=True)
    assert m.all_steps() == [3, 4]


def test_checkpoint_restore_rejects_wrong_tree_with_the_references_messages(tmp_path):
    m = CheckpointManager(tmp_path / "port")
    m.save(1, [torch.arange(4.0)], blocking=True)
    jm = JaxCheckpointManager(tmp_path / "ref")
    jm.save(1, [jnp.arange(4.0)], blocking=True)
    for port_tree, ref_tree in (([torch.arange(4.0), torch.zeros(2)],
                                 [jnp.arange(4.0), jnp.zeros(2)]),
                                ([torch.zeros(2)], [jnp.zeros(2)])):
        with pytest.raises(ValueError) as got:
            m.restore(1, port_tree)
        with pytest.raises(ValueError) as want:
            jm.restore(1, ref_tree)
        assert str(got.value) == str(want.value)


def test_checkpoint_round_trip_is_bit_exact_and_atomic(tmp_path):
    rng = np.random.default_rng(4)
    tree = [torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
            torch.tensor(7, dtype=torch.int32),
            torch.from_numpy(rng.normal(size=(6,)).astype(np.float32)).bfloat16()]
    m = CheckpointManager(tmp_path)
    m.save(12, tree)  # asynchronous
    (tmp_path / "step_0000000099.tmp").mkdir()  # a write cut short: never listed
    m.wait()
    assert m.all_steps() == [12] and m.latest_step() == 12
    got = m.restore(12, [torch.empty_like(t) for t in tree])
    for a, b in zip(got, tree):
        assert a.dtype == b.dtype and torch.equal(a, b)
    files = sorted(p.name for p in (tmp_path / "step_0000000012").iterdir())
    assert files == ["leaves.npz", "manifest.json"]
    manifest = json.loads((tmp_path / "step_0000000012" / "manifest.json").read_text())
    jm = JaxCheckpointManager(tmp_path / "ref")
    jm.save(12, [jnp.zeros((3, 5)), jnp.int32(7), jnp.zeros(6)], blocking=True)
    ref = json.loads((tmp_path / "ref" / "step_0000000012" / "manifest.json").read_text())
    assert sorted(manifest) == sorted(ref)
    assert manifest["shapes"] == ref["shapes"] == [[3, 5], [], [6]]
    assert manifest["dtypes"] == ["float32", "int32", "float32"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_a_port_checkpoint_restores_into_the_references_tree(tmp_path, arch):
    """The Trainer saves the model's leaves and then the optimizer state in
    the reference's flatten order: the reference's manager restores it
    against its own ``(params, opt_state)`` for the same configuration."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=len(get_smoke_config(arch).period))
    tr = Trainer(cfg, batch=2, seq=8, ckpt_dir=tmp_path, hp=TrainHParams(remat=False),
                 ckpt_every=1, device="cpu")
    tr.run(1)
    tr.data.close()
    jcfg = dataclasses.replace(jax_smoke(arch), n_layers=cfg.n_layers)
    params = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    opt = jax_make_optimizer(jcfg.optimizer)[0](params)
    restored = JaxCheckpointManager(tmp_path).restore(1, (params, opt))
    got = jax.tree.leaves(restored)
    want = tr.state()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("cls,jcls,kw", [
    (SyntheticTokens, JaxSyntheticTokens, {}),
    (PackedDocs, JaxPackedDocs, {"mean_doc_len": 10}),
])
def test_batches_are_the_references(cls, jcls, kw):
    args = dict(vocab=100, batch=3, seq=64, seed=5, **kw)
    d, jd = cls(**args), jcls(**args)
    try:
        for step in (0, 1, 17):
            np.testing.assert_array_equal(d.batch_at(step)["tokens"], jd.batch_at(step)["tokens"])
        for _ in range(3):
            np.testing.assert_array_equal(d.next()["tokens"], jd.next()["tokens"])
        d.seek(9)
        jd.seek(9)
        for _ in range(2):
            np.testing.assert_array_equal(d.next()["tokens"], jd.next()["tokens"])
        assert d.step == jd.step == 11
    finally:
        d.close()
        jd.close()


def test_a_missed_deadline_skips_like_the_reference():
    """With the producer stopped and its queue drained, a batch that misses
    its deadline is the deterministic fallback, counted in ``stats``."""
    outs = []
    for cls in (SyntheticTokens, JaxSyntheticTokens):
        d = cls(vocab=50, batch=2, seq=8, seed=1)
        d.close()
        d._thread.join(timeout=5)
        while not d._q.empty():
            d._q.get_nowait()
        d.seek(4)
        b = d.next(deadline_s=0.01)
        outs.append((b["tokens"], d.stats["skipped"], d.step))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:] == (1, 5)


def test_packed_docs_have_eos_and_full_rows():
    """The reference's ``test_packed_docs_have_eos_and_full_rows``."""
    d = PackedDocs(vocab=100, batch=2, seq=64, mean_doc_len=10)
    b = d.next()
    assert b["tokens"].shape == (2, 64)
    assert (b["tokens"] == 0).any(axis=1).all()
    d.close()
