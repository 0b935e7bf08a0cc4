"""Port parity for the paper CNN as a whole: ``PaperCNN`` (every forward
mode, calibration, table build), ``PCILTConv2d`` / ``convert_conv_kernel``
and the paper's arithmetic against the JAX package on its smoke config,
with the JAX parameters and tables carried across the bridge; and the
port's quickstart on the CPU.

Tolerances: table builds at group 1 are one product per cell, so
bit-equal.  Logits go through two conv layers whose float32 sums run in
another order than the reference's (and, for ``dm``, through another
convolution routine), then a mean and a matmul: allclose at 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.paper_cnn import smoke_config as j_smoke
from repro.core import calibrate as j_calibrate
from repro.core import pcilt as jp
from repro.core.serving import convert_conv_kernel as j_convert
from repro.kernels import autotune as atn
from repro_torch.configs.paper_cnn import config as t_config
from repro_torch.configs.paper_cnn import smoke_config as t_smoke
from repro_torch.core import pcilt as tp
from repro_torch.core.serving import convert_conv_kernel as t_convert
from repro_torch.interop import params_from_jax, tables_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.launch import quickstart
from test_torch_donor import jax_donor

TOL = 1e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX smoke CNN: parameters, an input, calibrated scales and
    dense tables."""
    atn.reset_cache(str(tmp_path_factory.mktemp("tune") / "tiles.json"))
    model = j_smoke()
    params = jax_donor(model.param_specs(), 0)
    x = np.random.default_rng(1).uniform(0, 2, (2, 12, 10, 1)) \
        .astype(np.float32)
    scales, h = {}, jnp.asarray(x)
    for i in range(len(model.channels)):
        scales[f"conv{i}"] = j_calibrate(h, model.act_spec)
        h = jax.nn.relu(jax.lax.conv_general_dilated(
            h, params[f"conv{i}"], (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
    tables = model.build_tables(params, scales)
    yield model, params, x, scales, tables
    atn.reset_cache()


def _port(ref):
    model, params, x, scales, tables = ref
    return (t_smoke(device="cpu"),
            params_from_jax({k: np.asarray(v) for k, v in params.items()},
                            "cpu"),
            torch.from_numpy(x),
            {k: float(np.float32(v)) for k, v in scales.items()},
            tables_from_jax({k: np.asarray(v) for k, v in tables.items()},
                            "cpu"))


@pytest.mark.parametrize("mode", ["dm", "gather", "onehot", "kernel",
                                  "fused", "shared"])
def test_paper_cnn_forward_matches_reference(ref, mode):
    """Every mode against the same mode of the JAX model (``shared``
    builds its pools in the forward on both sides), and against the port's
    own direct multiplication."""
    model, params, x, scales, tables = ref
    tm, tparams, tx, tscales, ttables = _port(ref)
    use = None if mode in ("dm", "shared") else tables
    want = model.forward(params, jnp.asarray(x), mode=mode, scales=scales,
                         tables=use)
    got = tm.forward(tparams, tx, mode=mode, scales=tscales,
                     tables=None if use is None else ttables)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    dm = tm.forward(tparams, tx, mode="dm", scales=tscales)
    np.testing.assert_allclose(got.numpy(), dm.numpy(), rtol=TOL, atol=TOL)
    assert all(v == 0 for v in tops.LAUNCHES.values())


def test_paper_cnn_calibration_and_tables_match_reference(ref):
    model, params, x, scales, tables = ref
    tm, tparams, tx, tscales, ttables = _port(ref)
    got = tm.calibrate(tparams, tx)
    for k, v in scales.items():
        np.testing.assert_allclose(got[k], float(v), rtol=TOL)
    built = tm.build_tables(tparams, tscales)
    for k, v in tables.items():  # group 1: one product per cell
        np.testing.assert_array_equal(built[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("shared,weight_bits", [(False, None), (True, 4),
                                                (False, 3)])
def test_convert_conv_kernel_matches_reference(ref, shared, weight_bits):
    """The converted layer — weight quantization, table or pool build, and
    each of its paths — against the JAX ``convert_conv_kernel``."""
    model, params, x, scales, tables = ref
    tm, tparams, tx, tscales, _ = _port(ref)
    spec = model.act_spec
    w = params["conv1"]
    jlay = j_convert(w, spec, scales["conv1"], 1, weight_bits=weight_bits,
                     shared=shared)
    tlay = t_convert(tparams["conv1"], tm.act_spec, tscales["conv1"], 1,
                     weight_bits=weight_bits, shared=shared)
    np.testing.assert_array_equal(tlay.filters.numpy(),
                                  np.asarray(jlay.filters))
    if shared:
        np.testing.assert_array_equal(tlay.shared.pool.numpy(),
                                      np.asarray(jlay.shared.pool))
        np.testing.assert_array_equal(tlay.shared.seg_idx.numpy(),
                                      np.asarray(jlay.shared.seg_idx))
    else:
        np.testing.assert_array_equal(tlay.tables.numpy(),
                                      np.asarray(jlay.tables))
    assert tlay.table_bytes() == jlay.table_bytes()
    assert tlay.n_segments == jlay.n_segments
    h = np.random.default_rng(2).uniform(0, 1.5, (1, 6, 5, 8)) \
        .astype(np.float32)
    for path in (("shared", "gather") if shared else ("fused", "gather")):
        want = jlay(jnp.asarray(h), path=path)
        got = tlay(torch.from_numpy(h), path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    with pytest.raises(ValueError):
        tlay(torch.from_numpy(h), path="fused" if shared else "shared")


@pytest.mark.parametrize("fn,args", [
    ("table_bytes", (25 * 50, 8, 2)),
    ("grouped_table_bytes", (688960 // 256, 8, 1, 4)),
    ("grouped_table_bytes", (27, 4, 2, 4)),
    ("shared_table_bytes", (12, [4, 8], 2)),
    ("build_cost_multiplies", (25, 8))])
def test_paper_arithmetic_matches_reference(fn, args):
    assert getattr(tp, fn)(*args) == getattr(jp, fn)(*args)


def test_paper_config_has_the_published_widths():
    m = t_config(device="cpu")
    assert m.channels == (50, 80, 120, 200, 350) and m.k == 5
    assert m.act_spec.bits == 8 and not m.act_spec.symmetric
    assert m.group == 1 and m.in_channels == 1
    cells = sum(m.k * m.k * cin * 256 * cout for cin, cout in
                zip((1,) + m.channels[:-1], m.channels))
    assert cells == 688_960_000  # 2.57 GiB of float32 tables
    assert dataclasses.replace(m, device="cuda").device == "cuda"


def test_quickstart_runs_on_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for path in quickstart.PATHS:
        assert f"PCILT[{path:7s}] == DM  ✓" in out
    assert "build multiplies" in out


def test_cnn_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_config().init_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        tables_from_jax(np.zeros((2, 4, 3), np.float32))
    m = t_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        m.forward({}, torch.zeros(1, 4, 4, 1))
