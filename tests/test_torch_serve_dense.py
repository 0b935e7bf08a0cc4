"""Port parity of the dense serving path and the three LM entry points.

The port's ``Engine`` on qwen3-0.6b's smoke config, given the JAX engine's
parameters through the bridge, serves the reference CLI's default request
stream (6 requests of 16 new tokens over 4 slots, seed 0; prompts replayed
into the KV cache, slots recycled) as the JAX ``Engine`` does, and goes
through the CLI's dense ``--chaos`` schedule (a step fault at step 4, one
restart) alike.  Every step is compared: the same tokens fed, logits
within 1e-4 of the largest logit in float32 compute (float32 sums in
another order, and the bfloat16 KV cache: a K or V value that lands on the
other side of a bfloat16 rounding boundary moves later logits by ~1e-5
relative), and in the config's bfloat16 compute within 2e-2 of the
largest logit; the port samples its own logits,
except where the greedy tokens differ, which is allowed only at a near-tie
(the reference's choice within the tolerance of the port's maximum), where
the reference's logits are fed on so the streams stay comparable.

Then the entry points on the CPU: the serve CLI's dense defaults,
``--chaos``, ``--traffic`` and the ``--pcilt`` refusal;
``launch.serve_engine``; ``launch.serve_pcilt`` (its tables equal to the
JAX ``convert_kernel``'s on the same weights); ``launch.decode_pcilt``
(its tokens equal to the JAX example's flow on the same parameters,
calibration tokens and prompt).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.core import QuantSpec as JSpec
from repro.core.serving import convert_kernel as j_convert_kernel
from repro.core.serving import convert_mamba_decode as j_convert
from repro.core.serving import mlp_table_bytes as j_mlp_table_bytes
from repro.launch import serve as js
from repro.models import build_model as j_build
from repro.nn.layers import Ctx
from repro.runtime.faults import FaultInjector as JInjector
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.interop import params_from_jax, to_numpy, tree_map
from repro_torch.launch import decode_pcilt, serve_engine, serve_pcilt
from repro_torch.launch import serve as ts
from repro_torch.runtime import FaultInjector
from test_torch_donor import hash_free_engines

SLOTS, N_REQ, MAX_NEW, SEED = 4, 6, 16, 0
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt, want):
    scale = float(np.abs(want).max())
    return 1e-4 * scale if dt == "f32" else 2e-2 * scale


def _reference_run(dt, chaos):
    """The JAX engine's run with the tokens fed and the logits of every
    step recorded."""
    jcfg = dataclasses.replace(j_smoke("qwen3-0.6b"), dtype=DTYPES[dt][0])
    with hash_free_engines():
        jeng = js.Engine(jcfg, max_len=256, slots=SLOTS)
    inj = None
    if chaos:  # the CLI's dense schedule
        inj = JInjector(fail_at=(7,), seed=SEED)
        jeng.chaos = {4: [lambda e: inj.maybe_fail(7)]}
    log = []
    raw = jeng._raw_step

    def logged():
        fed = jeng.tokens.copy()
        logits, cache = raw()
        log.append((fed, np.asarray(logits.astype(jnp.float32))))
        return logits, cache

    jeng._raw_step = logged
    jreqs = js._make_requests(jcfg, N_REQ, MAX_NEW, None, SEED)
    jstats = jeng.run(jreqs)
    return {"jeng": jeng, "jreqs": jreqs, "jstats": jstats, "log": log,
            "inj": inj}


@pytest.fixture(scope="module", params=[("f32", False), ("bf16", False),
                                        ("bf16", True)],
                ids=["f32", "bf16", "bf16-chaos"])
def served(request):
    dt, chaos = request.param
    ref = _reference_run(dt, chaos)
    tcfg = dataclasses.replace(t_smoke("qwen3-0.6b"), dtype=DTYPES[dt][1])
    params = params_from_jax(jax.tree.map(np.asarray, ref["jeng"].params),
                             "cpu")
    eng = ts.Engine(tcfg, slots=SLOTS, device="cpu", params=params)
    inj = None
    if chaos:
        inj = FaultInjector(fail_at=(7,), seed=SEED)
        eng.chaos = {4: [lambda e: inj.maybe_fail(7)]}
    # a mismatch is recorded, not raised: the engine would take an exception
    # for a step fault and replay
    seen = {"steps": 0, "ties": 0, "bad": []}
    raw = eng._raw_step

    def compared():
        i = seen["steps"]
        fed, want = ref["log"][i]
        if not np.array_equal(eng.tokens, fed):
            seen["bad"].append((i, "fed", eng.tokens.ravel().tolist(),
                                fed.ravel().tolist()))
        logits, cache = raw()
        got = to_numpy(logits).astype(np.float32)
        tol = _tol(dt, want)
        err = float(np.abs(got - want).max())
        if err > tol:
            seen["bad"].append((i, "logits", err, tol))
        seen["steps"] += 1
        differ = np.nonzero(got.argmax(-1) != want.argmax(-1))[0]
        for b in differ:
            if got[b, want[b].argmax()] < got[b].max() - tol:
                seen["bad"].append((i, "not a near-tie", int(b)))
        if len(differ):
            seen["ties"] += len(differ)
            return torch.from_numpy(want.copy()).to(logits.dtype), cache
        return logits, cache

    eng._raw_step = compared
    treqs = ts.make_requests(tcfg, N_REQ, MAX_NEW, SEED)
    for r, q in zip(treqs, ref["jreqs"]):
        np.testing.assert_array_equal(r.prompt, q.prompt)
    tstats = eng.run(treqs)
    return dict(ref, dt=dt, chaos=chaos, eng=eng, treqs=treqs, tstats=tstats,
                seen=seen, tinj=inj)


def test_engine_serves_the_reference_stream(served):
    p = served
    assert p["seen"]["bad"] == []
    assert p["seen"]["steps"] == len(p["log"])
    if p["dt"] == "f32":  # no near-tie: the port sampled its own logits
        assert p["seen"]["ties"] == 0
    assert [r.out for r in p["treqs"]] == [r.out for r in p["jreqs"]]
    assert [r.outcome for r in p["treqs"]] == \
        [r.outcome for r in p["jreqs"]] == ["served"] * N_REQ
    for k in ("served", "decode_ticks", "prefill_ticks", "restarts",
              "rollbacks", "slot_evictions", "queue_evictions"):
        assert p["tstats"][k] == p["jstats"][k], k
    assert p["tstats"]["restarts"] == (1 if p["chaos"] else 0)
    if p["chaos"]:
        assert len(p["tinj"].events) == len(p["inj"].events) == 1
    # one write position for every slot, past every committed step (the
    # restore rewinds it with the cache)
    assert p["eng"].cache["pos"] == int(p["jeng"].cache["pos"]) == \
        p["seen"]["steps"] - (4 if p["chaos"] else 0)


def test_engine_cache_matches_the_reference(served):
    """The final KV caches, bfloat16 in both: within one bfloat16 step in
    float32 compute, within 2e-2 of the largest value in bfloat16
    compute."""
    t = served["eng"].cache["layers"]["sub0"]
    j = served["jeng"].cache["layers"]["sub0"]
    for n in ("k", "v"):
        assert t[n].dtype == torch.bfloat16
        got = to_numpy(t[n]).astype(np.float32)
        want = np.asarray(j[n].astype(jnp.float32))
        if served["dt"] == "f32":
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -7 * np.abs(want).max())
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_reset_slot_zeroes_one_slot_and_keeps_pos():
    """A recycled slot's K/V rows are zeroed (axis 1 of every layer's
    cache) and the shared write position stays, as the reference's."""
    eng = ts.Engine(t_smoke("qwen3-0.6b"), slots=3, max_len=8, device="cpu")
    kv = eng.cache["layers"]["sub0"]
    assert kv["k"].shape == (2, 3, 8, 2, 32)
    for t in kv.values():
        t.fill_(1)
    eng.cache["pos"] = 5
    eng._reset_slot(1)
    for t in kv.values():
        assert (t[:, 1] == 0).all() and (t[:, [0, 2]] == 1).all()
    assert eng.cache["pos"] == 5
    eng._checkpoint()
    eng.cache["pos"] = 6
    eng._restore(eng.tick)
    assert eng.cache["pos"] == 5


def test_finite_gate_refuses_a_poisoned_kv_cache():
    eng = ts.Engine(t_smoke("qwen3-0.6b"), slots=2, max_len=8, device="cpu")
    eng.cache["layers"]["sub0"]["v"][1, 0, 3, 0, 0] = float("nan")
    eng.tokens[:] = 3
    with pytest.raises(RuntimeError, match="non-finite"):
        eng._step()


# -- the entry points ------------------------------------------------------


def test_serve_cli_dense_defaults(capsys):
    """``python -m repro_torch.launch.serve --device cpu``: qwen3-0.6b's
    smoke config (the default ``--arch``) serves the default stream."""
    args = ts.parse_args(["--device", "cpu"])
    assert args.arch == "qwen3-0.6b"
    ts.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[served]") == N_REQ
    assert f"served {N_REQ} requests" in out


@pytest.mark.parametrize("flags,line", [
    (["--chaos"], "chaos contract verified: 6 requests completed (6 "
                  "token-identical to fault-free run, 1 faults injected, "
                  "1 restarts"),
    (["--traffic", "poisson"], "accounting invariant verified")])
def test_serve_cli_dense_contracts(flags, line, capsys):
    ts.main([*flags, "--device", "cpu"])
    assert line in capsys.readouterr().out


def test_serve_cli_pcilt_needs_an_ssm_arch():
    with pytest.raises(SystemExit, match="pick an \\[ssm\\] arch"):
        ts.main(["--pcilt", "--device", "cpu"])


def test_serve_engine_entry_point(capsys):
    serve_engine.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[served]") == 6
    assert "served 6 requests" in out


def test_serve_pcilt_entry_point(capsys):
    """The ✓ lines, and the gate's tables equal to the JAX
    ``convert_kernel``'s on the same weights and scale."""
    res = serve_pcilt.run(device="cpu")
    out = capsys.readouterr().out
    assert "PCILT(gather|onehot|kernel) == dense ✓" in out
    assert "full MLP through PCILTs: exact on the quantized grid ✓" in out
    assert res["table_mib"]["qwen3-0.6b"] == \
        j_mlp_table_bytes(1024, 3072, act_bits=4, group=2) / 2**20
    assert max(res["errors"].values()) <= serve_pcilt.TOL
    gate = res["gate"]
    want = j_convert_kernel(jnp.asarray(res["weights"]["wg"]["kernel"]
                                        .numpy()),
                            JSpec(bits=4), jnp.asarray(gate.scale.numpy()), 2)
    np.testing.assert_allclose(gate.tables.numpy(), np.asarray(want.tables),
                               rtol=1e-6, atol=1e-6)


def test_decode_pcilt_entry_point_matches_the_example(capsys, tmp_path):
    """The port's run, then the JAX example's flow (convert, prefill,
    greedy steps; without its ``tune``) on the port's parameters,
    calibration tokens and prompt: the same tokens."""
    from repro.kernels import autotune as atn

    res = decode_pcilt.run(device="cpu")
    out = capsys.readouterr().out
    assert "stacked table fetch == fake-quant dense oracle ✓" in out
    assert res["max_abs_err"] <= decode_pcilt.TOL
    atn.reset_cache(str(tmp_path / "tiles.json"))
    try:
        jcfg = dataclasses.replace(j_smoke("mamba2-130m"),
                                   pcilt=JPCILT(act_bits=2, group=2),
                                   dtype=jnp.float32)
        model = j_build(jcfg)
        params = jax.tree.map(jnp.asarray, tree_map(to_numpy, res["params"]))
        eng = j_convert(model, params, jnp.asarray(res["calib"].numpy()))
        logits, cache = model.prefill(
            params, {"tokens": jnp.asarray(res["prompt"].numpy())}, Ctx())
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        tokens = [int(tok[0, 0])]
        for _ in range(len(res["tokens"]) - 1):
            logits, cache = eng.step(params, cache, tok)
            tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            tokens.append(int(tok[0, 0]))
    finally:
        atn.reset_cache()
    assert res["tokens"] == tokens
