"""Port parity of the supervised train loop and the synthetic corpus: the
three ``Supervisor`` cases and the three ``SyntheticLM`` cases of
``tests/test_runtime.py``, the corpus's arrays equal to the reference's for
every ``(seed, step, shard)`` tried."""

import numpy as np
import pytest

from repro.data import SyntheticLM as JSyntheticLM
from repro.runtime import Supervisor as JSupervisor
from repro_torch.data import SyntheticLM
from repro_torch.runtime import FaultInjector, Supervisor


def _run(sup_cls, fail_at, saved):
    inj = FaultInjector(fail_at)

    def step_fn(state, step):
        inj.maybe_fail(step)
        return state + step

    def save_fn(state, step):
        saved[step] = state

    def restore_fn():
        if not saved:
            return None
        s = max(saved)
        return s, saved[s]

    sup = sup_cls(step_fn, save_fn, restore_fn, ckpt_every=10,
                  max_restarts=3)
    return sup.run(0, 40)


def test_supervisor_restarts_and_replays():
    """A fault at step 25 -> restore at 20 -> the state of an uninterrupted
    run, as the reference's loop gives it."""
    step, state, stats = _run(Supervisor, [25], {})
    assert step == 40 and stats["restarts"] == 1
    _, clean, _ = _run(Supervisor, [], {})
    assert state == clean
    assert (step, state, stats["restarts"]) == \
        _run(JSupervisor, [25], {})[:2] + (1,)


def test_supervisor_gives_up_after_max_restarts():
    for cls in (Supervisor, JSupervisor):
        calls = []

        def step_fn(state, step):
            calls.append(step)
            raise RuntimeError("always fails")

        sup = cls(step_fn, lambda *a: None, lambda: (0, 0), ckpt_every=10,
                  max_restarts=2)
        with pytest.raises(RuntimeError, match="always fails"):
            sup.run(0, 10)
        assert len(calls) == 3  # the first try and max_restarts replays


def test_supervisor_no_checkpoint_to_restore():
    def step_fn(state, step):
        if step == 3:
            raise ValueError("fault before any checkpoint")
        return state + step

    sup = Supervisor(step_fn, lambda *a: None, lambda: None, ckpt_every=10,
                     max_restarts=3)
    with pytest.raises(RuntimeError, match="no checkpoint to restore"):
        sup.run(0, 10)


def _same(t, j):
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("seed,shard", [(0, 0), (1, 0), (1, 1), (7, 3)])
def test_data_deterministic_per_step_and_shard(seed, shard):
    kw = dict(vocab=100, seq_len=32, global_batch=8, seed=seed, n_shards=4,
              shard=shard)
    d1, d2 = SyntheticLM(**kw), SyntheticLM(**kw)
    b1 = d1.batch(5)
    np.testing.assert_array_equal(b1["tokens"], d2.batch(5)["tokens"])
    other = SyntheticLM(**dict(kw, shard=(shard + 1) % 4)).batch(5)
    assert not np.array_equal(b1["tokens"], other["tokens"])
    assert not np.array_equal(b1["tokens"], d1.batch(6)["tokens"])
    for step in (0, 5, 123):
        _same(SyntheticLM(**kw).batch(step), JSyntheticLM(**kw).batch(step))


@pytest.mark.parametrize("packed", [True, False])
def test_data_labels_shifted_and_masked(packed):
    kw = dict(vocab=100, seq_len=64, global_batch=4, seed=0, packed=packed)
    b = SyntheticLM(**kw).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (4, 64)
    assert b["loss_mask"].shape == (4, 64)
    assert set(np.unique(b["loss_mask"])) <= {0.0, 1.0}
    assert b["loss_mask"].sum() > 0
    assert b["tokens"].max() < 100 and b["tokens"].min() >= 0
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    _same(b, JSyntheticLM(**kw).batch(0))
    with pytest.raises(ValueError, match="not divisible"):
        SyntheticLM(**dict(kw, n_shards=3)).local_batch


def test_data_modality_stubs():
    kw = dict(vocab=100, seq_len=16, global_batch=2, memory_len=10,
              img_tokens=4, d_model=8)
    b = SyntheticLM(**kw).batch(0)
    assert b["memory"].shape == (2, 10, 8)
    assert b["img_embeds"].shape == (2, 4, 8)
    _same(b, JSyntheticLM(**kw).batch(0))
