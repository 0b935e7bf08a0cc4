"""Port parity of the full-sequence PCILT conv frontend at the mamba2 smoke
width (C = 160 conv channels, k = 4, 4-bit symmetric codes, V = 65536).

The JAX package's layer parameters cross the numpy bridge; the JAX side
runs its fused Pallas kernel in interpret mode (``_conv1d`` as is, the
whole block under ``jax.jit``, as its CPU backend needs for the SSD's
bfloat16 contractions).  In float32 compute:

* ``build_pcilt_conv`` gives the reference's tables bit for bit;
* ``_conv1d(pcilt=)`` over a whole signal (CAUSAL, the signal padded with
  0.0) equals the reference's to 1e-5, its saturation count exactly and
  its ratio to 1e-6;
* ``mamba_block(pcilt=)`` equals the reference's to one bfloat16 step
  (2**-7 of the largest output), over one SSD chunk and over four: the SSD
  rounds its O(T) operands to bfloat16 in both packages, and projections
  that agree to ~1e-7 round to neighbouring bfloat16 values there now and
  then (from run to run: the frameworks' threaded sums are not ordered).
  Most runs agree to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PCILTConfig as JPCILT
from repro.nn import ssm as js
from repro.nn.layers import Ctx
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PCILTConfig as TPCILT
from repro_torch.core import fake_quant, pcilt_depthwise_conv1d
from repro_torch.interop import params_from_jax
from repro_torch.nn import ssm as ts
from test_torch_donor import jax_donor

CTX = Ctx()


@pytest.fixture(scope="module")
def layer(tmp_path_factory):
    from repro.kernels import autotune as atn

    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    jcfg = dataclasses.replace(j_smoke("mamba2-130m"),
                               pcilt=JPCILT(act_bits=4, group=2),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(t_smoke("mamba2-130m"),
                               pcilt=TPCILT(act_bits=4, group=2),
                               dtype=torch.float32)
    jp = jax_donor(js.mamba_spec(jcfg), 3)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    _, calib = jax.jit(lambda p, x: js.mamba_block(
        p, jcfg, CTX, x, return_calib=True))(jp, jnp.asarray(x))
    scale = np.float32(calib["conv_in"]) / np.float32(7)
    jpc = js.build_pcilt_conv(jp, jcfg, jnp.float32(scale))
    tpc = ts.build_pcilt_conv(tp, tcfg, float(scale))
    yield {"jcfg": jcfg, "tcfg": tcfg, "jp": jp, "tp": tp, "x": x,
           "scale": scale, "jpc": jpc, "tpc": tpc, "rng": rng}
    atn.reset_cache()


def test_build_pcilt_conv_matches_reference(layer):
    jpc, tpc = layer["jpc"], layer["tpc"]
    assert tpc["tables"].dtype == torch.float32
    assert tuple(tpc["tables"].shape) == jpc["tables"].shape == (160, 65536)
    np.testing.assert_array_equal(tpc["tables"].numpy(),
                                  np.asarray(jpc["tables"]))
    assert (tpc["spec"].bits, tpc["spec"].symmetric) == \
        (jpc["spec"].bits, jpc["spec"].symmetric) == (4, True)
    with pytest.raises(ValueError, match="requires cfg.pcilt"):
        ts.build_pcilt_conv(layer["tp"], t_smoke("mamba2-130m"), 0.1)


@pytest.mark.parametrize("T", [3, 8, 37])
def test_conv1d_full_sequence_matches_reference(layer, T):
    """The whole signal through the fused CAUSAL fetch, with stats and
    without; ``conv_b`` added after the cast, no decode state."""
    C = layer["tpc"]["tables"].shape[0]
    # about 5% of the codes saturate
    x = (4 * layer["scale"] * layer["rng"].standard_normal((2, T, C))
         ).astype(np.float32)
    want, wst, wc, wr = js._conv1d(layer["jp"], layer["jcfg"],
                                   jnp.asarray(x), pcilt=layer["jpc"],
                                   with_stats=True)
    got, gst, gc, gr = ts._conv1d(layer["tp"], layer["tcfg"],
                                  torch.from_numpy(x), pcilt=layer["tpc"],
                                  with_stats=True)
    assert gst is None and wst is None
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert int(gc) == int(wc) and int(wc) > 0
    np.testing.assert_allclose(float(gr), float(wr), rtol=1e-6)
    plain, st = ts._conv1d(layer["tp"], layer["tcfg"], torch.from_numpy(x),
                           pcilt=layer["tpc"])
    assert st is None
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_conv1d_full_sequence_pads_the_signal(layer):
    """The fused semantics: the first ``k - 1`` outputs see the signal
    padded with 0.0 (the symmetric grid's zero point), which is the dense
    conv over the fake-quantized signal; the host-packed paths pad the
    codes with 0 instead and differ there."""
    tp, tpc = layer["tp"], layer["tpc"]
    x = torch.from_numpy(
        (0.4 * layer["rng"].standard_normal((2, 9, 160))).astype(np.float32))
    got, _ = ts._conv1d(tp, layer["tcfg"], x, pcilt=tpc)
    xq = torch.nn.functional.pad(fake_quant(x, tpc["spec"], tpc["scale"]),
                                 (0, 0, 3, 0))
    w = tp["conv_w"]
    want = sum(xq[:, i:i + 9] * w[i] for i in range(4)) + tp["conv_b"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    gather = pcilt_depthwise_conv1d(x, w, tpc["spec"], tpc["scale"],
                                    tables=tpc["tables"], path="gather")
    assert not torch.allclose(gather[:, :3] + tp["conv_b"], got[:, :3])
    torch.testing.assert_close(gather[:, 3:] + tp["conv_b"], got[:, 3:],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [16, 64])
def test_mamba_block_pcilt_matches_reference(layer, T):
    x = layer["x"][:, :T]
    tables = layer["jpc"]["tables"]
    want = np.asarray(jax.jit(lambda p, x, t: js.mamba_block(
        p, layer["jcfg"], CTX, x, pcilt=dict(layer["jpc"], tables=t)))(
            layer["jp"], jnp.asarray(x), tables))
    got = ts.mamba_block(layer["tp"], layer["tcfg"], torch.from_numpy(x),
                         pcilt=layer["tpc"])
    assert got.shape == want.shape == (2, T, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())
    # the PCILT conv moves the block: it is not the dense block
    dense = ts.mamba_block(layer["tp"], layer["tcfg"], torch.from_numpy(x))
    assert not torch.allclose(dense, got, rtol=1e-5, atol=1e-5)


def test_mamba_block_positional_pcilt(layer):
    """``pcilt`` is the fifth positional parameter, after ``return_state``,
    as in the reference."""
    x = torch.from_numpy(layer["x"][:, :16])
    a = ts.mamba_block(layer["tp"], layer["tcfg"], x, False, layer["tpc"])
    b = ts.mamba_block(layer["tp"], layer["tcfg"], x, pcilt=layer["tpc"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    out, state = ts.mamba_block(layer["tp"], layer["tcfg"], x, True,
                                layer["tpc"])
    torch.testing.assert_close(out, b, rtol=0, atol=0)
    assert set(state) == {"conv", "ssd"}
