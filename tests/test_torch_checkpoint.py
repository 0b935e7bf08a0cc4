"""Port parity of checkpointing: the cases of ``tests/test_checkpoint.py``
(roundtrip, retention, integrity, tree mismatch, async then restore; the
elastic sharded restore waits for distribution), the restore joining a
pending async write, and the on-disk layout shared with the JAX package:
a checkpoint of a JAX train state restores in the port with equal arrays,
and the port's restores through the JAX ``restore``."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import tree_map
from repro_torch.models import build_model as t_build
from repro_torch.nn.module import materialize
from repro_torch.optim import AdamWConfig, adamw_init
from test_torch_donor import jax_donor


def _tree():
    return {"b": {"d": torch.tensor(2.5),
                  "c": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "a": torch.arange(12.0).reshape(3, 4)}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t, extra={"note": "hi"})
    got, extra = restore(str(tmp_path), 7, t, device="cpu")
    _equal(got, t)
    assert list(got) == list(t)  # the given tree's structure and order
    assert extra["note"] == "hi"
    m = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    # leaves named and ordered as jax.tree_util sorts them
    assert m["names"] == ["a", "b/c", "b/d"]
    assert m["dtypes"] == ["float32", "int32", "float32"]
    assert m["shapes"] == [[3, 4], [3], []]


def test_latest_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30):
        ck.save_async(s, t)
        ck.wait()
    assert latest_step(str(tmp_path)) == 30
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [20, 30]  # keep=2 removed step 10
    assert latest_step(str(tmp_path / "none")) is None


def test_corruption_detected(tmp_path):
    t = _tree()
    d = save(str(tmp_path), 1, t)
    npz = os.path.join(d, "shard_p0.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        restore(str(tmp_path), 1, t, device="cpu")


def test_tree_mismatch_detected(tmp_path):
    t = _tree()
    save(str(tmp_path), 2, t)
    with pytest.raises(ValueError, match="mismatch"):
        restore(str(tmp_path), 2, {"x": torch.zeros(3)}, device="cpu")


def test_async_then_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    t = _tree()
    ck.save_async(5, t, extra={"arch": "x"})
    step, got, extra = ck.restore_latest(t, device="cpu")
    assert step == 5 and extra["arch"] == "x"
    _equal(got, t)
    assert Checkpointer(str(tmp_path / "empty")).restore_latest(
        t, device="cpu") == (None, None, None)


def test_restore_joins_a_pending_async_save(tmp_path, monkeypatch):
    """A write still in flight when ``restore_latest`` is called: the
    restore waits for it and reads the new step (the reference reads the
    directory list at once and finds no checkpoint)."""
    started, release = threading.Event(), threading.Event()
    write = tck._write

    def slow_write(*a, **kw):
        started.set()
        release.wait(10)
        return write(*a, **kw)

    monkeypatch.setattr(tck, "_write", slow_write)
    ck = Checkpointer(str(tmp_path), keep=3)
    t = _tree()
    ck.save_async(5, t)
    assert started.wait(10)
    assert latest_step(str(tmp_path)) is None  # nothing on disk yet
    threading.Timer(0.2, release.set).start()
    step, got, _ = ck.restore_latest(t, device="cpu")
    assert step == 5
    _equal(got, t)


def test_async_snapshot_is_taken_before_the_write(tmp_path, monkeypatch):
    """``save_async`` copies the leaves before its thread starts: an
    in-place change made after the call does not reach the file."""
    release = threading.Event()
    write = tck._write
    monkeypatch.setattr(tck, "_write",
                        lambda *a, **kw: (release.wait(10), write(*a, **kw)))
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = {k: tree_map(torch.clone, v) for k, v in t.items()}
    ck.save_async(3, t)
    t["a"].add_(100.0)
    release.set()
    got = ck.restore_latest(t, device="cpu")[1]
    _equal(got, want)


def _jax_train_state():
    jcfg = j_smoke("qwen3-0.6b")
    jp = jax_donor(j_build(jcfg).param_specs(), 0)
    jo = j_adamw_init(jp, JAdamW(quantize_moments=True))
    jo = dict(jo, count=jnp.asarray(7, jnp.int32))
    return {"params": jp, "opt": jo}


def _port_like(quantized=True):
    tcfg = t_smoke("qwen3-0.6b")
    tp = materialize(t_build(tcfg).param_specs(), 1, device="cpu")
    return {"params": tp,
            "opt": adamw_init(tp, AdamWConfig(quantize_moments=quantized))}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_train_state()
    jck.save(str(tmp_path), 4, jstate, extra={"arch": "qwen3-smoke"})
    got, extra = restore(str(tmp_path), 4, _port_like(), device="cpu")
    assert extra == {"arch": "qwen3-smoke"}
    jflat = dict(zip(jck._paths(jstate), jax.tree.leaves(jstate)))
    tflat = dict(tck._flatten(got))
    assert list(tflat) == list(jflat)
    for k, v in jflat.items():
        assert tflat[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(v))
    assert int(got["opt"]["count"]) == 7


def test_port_checkpoint_restores_in_jax(tmp_path):
    tstate = _port_like()
    tstate["opt"]["count"] = torch.tensor(9, dtype=torch.int32)
    save(str(tmp_path), 6, tstate, extra={"by": "port"})
    got, extra = jck.restore(str(tmp_path), 6, _jax_train_state())
    assert extra == {"by": "port"}
    tflat = dict(tck._flatten(tstate))
    for name, v in zip(jck._paths(got), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(v), tflat[name].numpy())
    assert int(got["opt"]["count"]) == 9
