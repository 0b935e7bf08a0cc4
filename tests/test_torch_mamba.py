"""Port parity: the Mamba2 PCILT decode slice at the smoke config
(2 layers, d 64, 4-bit activations, group 2 — the serving engine's
quantization).

The JAX package's parameters and PCILT bundle cross the numpy bridge, so
both packages compute on identical weights and tables:

* calibration absmax agrees to 2e-2 relative: ``_ssd_chunked`` keeps its
  O(T) operands in bfloat16 in both packages, and the two frameworks sum
  the bf16-rounded products in different orders;
* with the JAX scales, ``build_pcilt`` gives the same tables, pointers and
  CRC-32 record as the reference, byte for byte;
* four decode steps agree — logits, cache and saturation stats — when all
  layers are healthy, with one layer demoted to its dense fake-quant oracle
  and with the head demoted.  Logits and state to 1e-4 (float32 sums in
  another order); saturation counts exactly, ratios to 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.core.serving import convert_mamba_decode as j_convert
from repro.models import build_model as j_build
from repro.nn.layers import Ctx
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.interop import bundle_from_jax, params_from_jax, to_numpy
from repro_torch.models import build_model as t_build
from test_torch_donor import jax_donor

STEPS = 4
BATCH = 3


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"),
                               pcilt=JPCILT(act_bits=4, group=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"),
                               pcilt=TPCILT(act_bits=4, group=2),
                               dtype=torch.float32)
    jmodel = j_build(jcfg)
    jparams = jax_donor(jmodel.param_specs(), 0)
    calib = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 16))
    jdec = j_convert(jmodel, jparams, jnp.asarray(calib), head="shared")
    np_params = jax.tree.map(np.asarray, jparams)
    yield {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel, "jparams": jparams,
           "calib": calib, "jdec": jdec,
           "tmodel": t_build(tcfg),
           "tparams": params_from_jax(np_params, "cpu")}
    atn.reset_cache()


def test_calibration_absmax_allclose(problem):
    p = problem
    want = p["jmodel"].calibrate_pcilt(p["jparams"],
                                       {"tokens": jnp.asarray(p["calib"])},
                                       Ctx())
    got = p["tmodel"].calibrate_pcilt(
        p["tparams"], {"tokens": torch.from_numpy(p["calib"])})
    for k in ("in", "out", "conv_in", "head_in"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-2, err_msg=k)


def test_build_pcilt_matches_reference_bytes(problem):
    p = problem
    jb = p["jdec"].pcilt
    proj = jb["proj"]
    got = p["tmodel"].build_pcilt(
        p["tparams"], np.asarray(jb["scale"]),
        proj_scales={"in": np.asarray(proj["scales"]["wx"]),
                     "out": np.asarray(proj["scales"]["wo"])},
        head_scale=np.asarray(jb["head"]["scale"]))
    np.testing.assert_array_equal(got["tables"].numpy(),
                                  np.asarray(jb["tables"]))
    for name, t in proj["tables"].items():
        np.testing.assert_array_equal(got["proj"]["tables"][name].numpy(),
                                      np.asarray(t), err_msg=name)
        np.testing.assert_array_equal(got["proj"]["scales"][name].numpy(),
                                      np.asarray(proj["scales"][name]))
    for k in ("pool", "seg_idx", "kernel_q"):
        np.testing.assert_array_equal(got["head"][k].numpy(),
                                      np.asarray(jb["head"][k]), err_msg=k)
    assert got["head"]["n"] == jb["head"]["n"]
    assert got["integrity"] == jb["integrity"]


SCENARIOS = {"healthy": (None, None),
             "layer1_demoted": ([True, False], None),
             "head_demoted": (None, False)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decode_steps_match_reference(problem, scenario):
    from repro_torch.core.serving import PCILTMambaDecode

    p = problem
    cfg = p["jcfg"]
    layer_ok, head_ok = SCENARIOS[scenario]
    tdec = PCILTMambaDecode(p["tmodel"], bundle_from_jax(p["jdec"].pcilt,
                                                         "cpu"))
    rng = np.random.default_rng(11)
    specs = p["tmodel"].cache_specs(BATCH)["layers"]
    layers = {k: (0.1 * rng.normal(size=s.shape)).astype(np.float32)
              for k, s in specs.items()}
    jcache = {"layers": {k: jnp.asarray(v) for k, v in layers.items()},
              "pos": jnp.asarray(16, jnp.int32)}
    tcache = {"layers": {k: torch.from_numpy(v.copy())
                         for k, v in layers.items()}}
    tok = rng.integers(0, cfg.vocab, (BATCH, 1))
    jl = None if layer_ok is None else jnp.asarray(layer_ok)
    jh = None if head_ok is None else jnp.asarray(head_ok)
    for _ in range(STEPS):
        wl, jcache, wsat = p["jdec"].step(p["jparams"], jcache,
                                          jnp.asarray(tok, jnp.int32), jl, jh,
                                          with_stats=True)
        gl, tcache, gsat = tdec.step(p["tparams"], tcache,
                                     torch.from_numpy(tok), layer_ok, head_ok,
                                     with_stats=True)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-4,
                                   atol=1e-4)
        for k in ("conv", "ssd"):
            np.testing.assert_allclose(tcache["layers"][k].numpy(),
                                       np.asarray(jcache["layers"][k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        for g in ("in", "conv", "out"):
            np.testing.assert_array_equal(gsat[g]["count"].numpy(),
                                          np.asarray(wsat[g]["count"]))
            np.testing.assert_allclose(gsat[g]["ratio"].numpy(),
                                       np.asarray(wsat[g]["ratio"]),
                                       rtol=1e-6)
        # feed the reference's greedy tokens to both: identical inputs
        tok = np.array(jnp.argmax(wl, -1))[:, None]


def test_fetch_decode_matches_dense_fakequant_oracle(problem):
    """The port's own fetch path against its dense fake-quant oracle (the
    comparison ``chip_smoke.py`` makes on the card): exact on the grid, so
    equal to float32 summation order (2e-4, the reference's own bound)."""
    p = problem
    bundle = bundle_from_jax(p["jdec"].pcilt, "cpu")
    oracle = dict(bundle, proj=dict(bundle["proj"], path="dense_fq"))
    cache = {"layers": {k: torch.zeros(s.shape) for k, s in
                        p["tmodel"].cache_specs(BATCH)["layers"].items()}}
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, p["tcfg"].vocab, (BATCH, 1)))
    got, gc = p["tmodel"].decode_step(p["tparams"], cache, tok, pcilt=bundle)
    want, wc = p["tmodel"].decode_step(p["tparams"], cache, tok,
                                       pcilt=oracle, head_ok=False)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    # the same pick, or a tie: the fetched head's logits lie on a grid, so
    # two ids can share the largest value exactly, and the oracle's float32
    # sums then order them by an ulp
    for b in torch.nonzero(got.argmax(-1) != want.argmax(-1))[:, 0]:
        assert got[b, want[b].argmax()] == got[b].max(), f"row {b}: no tie"
    torch.testing.assert_close(gc["layers"]["ssd"], wc["layers"]["ssd"],
                               rtol=2e-4, atol=2e-4)


def test_integrity_breach_is_localized(problem):
    from repro_torch.core.serving import PCILTMambaDecode

    bundle = bundle_from_jax(problem["jdec"].pcilt, "cpu")
    dec = PCILTMambaDecode(problem["tmodel"], bundle)
    assert dec.verify_integrity() == []
    bundle["proj"]["tables"]["wB"][1].view(torch.int32)[3, 7, 2] ^= 1 << 4
    bundle["head"]["seg_idx"][5] += 1
    assert dec.verify_layer(0) == [] and dec.verify_layer(1) == [("wB", 1)]
    assert dec.verify_integrity() == [("wB", 1), ("head.seg_idx",)]
    with pytest.raises(RuntimeError, match="integrity"):
        PCILTMambaDecode(problem["tmodel"], bundle)
    assert np.array_equal(to_numpy(bundle["tables"]),
                          np.asarray(problem["jdec"].pcilt["tables"]))
