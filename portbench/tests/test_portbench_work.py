"""The work counters, pinned to the published shapes and to the port's own
tables at a smoke size."""

import json

import pytest
import torch

from portbench import manifest, work


def _cfg(name):
    return json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())


def test_paper_cnn_conv4_fetch_adds_and_bound():
    img = work.cnn_image(_cfg("paper-cnn"), 768, 1024)
    conv4 = img["layers"][4]
    assert conv4["ops"] == 786432 * 25 * 200 * 350 == 1_376_256_000_000
    assert round(conv4["ops"] / 67e12 * 1e3, 2) == 20.54
    assert img["ops"] == 786432 * 25 * 107650 == 2_116_485_120_000
    assert img["model_flops"] == 2 * (img["ops"] + 350 * 10)


def test_paper_cnn_table_cells():
    img = work.cnn_image(_cfg("paper-cnn"), 768, 1024)
    assert sum(l["table_cells"] for l in img["layers"]) == 688_960_000


def test_cnn_table_cells_match_the_ports_tables():
    from repro_torch.core.quantization import QuantSpec
    from repro_torch.models.cnn import PaperCNN

    cfg = dict(_cfg("paper-cnn"), channels=[3, 5], act_bits=3)
    model = PaperCNN(channels=(3, 5), act_spec=QuantSpec(bits=3), device="cpu")
    params = model.init_params(0)
    tables = model.build_tables(params, {"conv0": 0.1, "conv1": 0.1})
    got = [t.numel() for t in tables.values()]
    assert got == [l["table_cells"] for l in work.cnn_image(cfg, 8, 8)["layers"]]


def test_mamba_step_bytes_and_flops():
    cfg = _cfg("mamba2-130m-pcilt4")
    step = work.mamba_step(cfg, 4)
    # 24 layers of named rows (wz, wx 1536; wB, wC 128; wdt 24 wide over
    # 384 segments; wo 768 wide over 768 segments) and conv entries, the
    # head's 384 x 4 rows of 50288, and the states read and written
    rows = 24 * (384 * 4 * (1536 * 2 + 128 * 2 + 24) + 768 * 4 * 768
                 + 4 * 1792) + 384 * 4 * 50288
    states = 24 * 2 * 4 * (3 * 1792 + 24 * 128 * 64)
    assert step["ops"] == rows
    assert step["bytes"] == 4 * (rows + states)
    assert step["bytes"] / 3.35e12 == pytest.approx(3.5e-4, rel=0.05)
    assert work.mamba_token_flops(cfg) == pytest.approx(2.8e8, rel=0.02)


def test_mamba_stacks_match_the_ports_layout():
    from portbench.kinds.mamba_decode import model_config
    from portbench.reference import mamba2
    from portbench.weights import shapes
    from repro_torch.models.mamba import MambaLM

    cfg = dict(_cfg("mamba2-130m-pcilt4"), name="m")
    model = MambaLM(model_config(cfg))
    want = {p: s for p, s, _, _ in mamba2.layout(cfg)}
    assert shapes(model.param_specs()) == want
