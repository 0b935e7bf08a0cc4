"""The frozen plain references against the port at smoke sizes on the CPU:
the same scales from the same calibration inputs, and outputs within the
float32 sums' rounding."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.kinds import mamba_decode, paper_cnn
from portbench.reference import cnn, mamba2, quant

from .smoke import CNN, MAMBA


def _json(name):
    import json

    from portbench import manifest
    return json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("bits,symmetric", [(2, False), (4, True), (8, False)])
def test_fake_quant_matches_the_ports_grid(bits, symmetric):
    from repro_torch.core.quantization import QuantSpec, fake_quant

    spec = QuantSpec(bits=bits, symmetric=symmetric)
    s = float(quant.scale_from_amax(torch.tensor(1.7), bits, symmetric))
    x = torch.linspace(-3, 3, 2001)
    x = torch.cat([x, torch.arange(-9, 9) * s + s / 2])  # exact half ties
    assert torch.equal(quant.fake_quant(x, bits, symmetric, s),
                       fake_quant(x, spec, s))


def test_cnn_reference_matches_the_port():
    cfg = dict(_json("paper-cnn"), **CNN)
    model = paper_cnn._model(cfg, "cpu")
    params = weights.make(cnn.layout(cfg), 7, "cpu")
    g = torch.Generator().manual_seed(3)
    calib = torch.rand((1, 24, 32, 1), generator=g) * 2
    x = torch.rand((2, 24, 32, 1), generator=g) * 2
    with torch.no_grad():
        scales = model.calibrate(params, calib)
        got = model.forward(params, x, mode="fused", scales=scales,
                            tables=model.build_tables(params, scales))
    ref_scales = cnn.calibrate(params, cfg, calib)
    assert ref_scales == [scales[f"conv{i}"] for i in range(2)]
    want = cnn.forward(params, cfg, ref_scales, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * want.abs().max())


def test_mamba_reference_matches_the_port():
    from repro_torch.core.serving import convert_mamba_decode
    from repro_torch.models.mamba import MambaLM

    cfg = dict(_json("mamba2-130m-pcilt4"), **MAMBA, name="smoke")
    mc = mamba_decode.model_config(cfg)
    model = MambaLM(mc)
    params = weights.make(mamba2.layout(cfg), 11, "cpu")
    calib = torch.randint(0, cfg["vocab"], (2, 16),
                          generator=torch.Generator().manual_seed(5))
    dec = convert_mamba_decode(model, params, calib, head="shared",
                               device="cpu")
    scales = mamba2.calibrate(params, cfg, calib)
    assert scales == mamba_decode._scales(dec.pcilt)
    toks = np.random.default_rng(2).integers(0, cfg["vocab"], (3, 6))
    cache = {"layers": mamba2.Decoder(params, cfg, scales).zero_state(3, "cpu"),
             "pos": 0}
    got = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lg, cache = dec.step(params, cache, torch.from_numpy(toks[:, i:i + 1]))
            got.append(lg)
    want = mamba2.Decoder(params, cfg, scales).teacher_forced(
        [list(r) + [0] for r in toks], "cpu")
    got = torch.stack(got, 1)
    want = torch.stack(want)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())


def test_sample_takes_the_longest_and_enough_tokens():
    class R:
        def __init__(self, rid, p, o):
            self.rid, self.prompt, self.out = rid, [0] * p, [0] * o

    done = [R(i, 10 + i, 5) for i in range(10)]
    picked = mamba_decode.sample(done, 3, 12)
    assert picked[0].rid == 9 and sum(len(r.out) for r in picked) >= 12
    assert mamba_decode.sample(done, 3, 12) == picked
