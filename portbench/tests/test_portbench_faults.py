"""A whole run at smoke size on the CPU (the look for a card skipped), sound
and with the timed path broken underneath: each fault a cell can have
must come out ``correct: false``."""

import pytest

from . import smoke


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make(tmp_path_factory.mktemp("portbench"))


def _answer_altered(monkeypatch):
    from repro_torch.models.cnn import PaperCNN

    plain = PaperCNN.forward

    def forward(self, *a, **kw):
        out = plain(self, *a, **kw).clone()
        out[..., 0] += 0.01 * out.abs().max()
        return out

    monkeypatch.setattr(PaperCNN, "forward", forward)


def _token_altered(monkeypatch):
    from repro_torch.launch.serve import Engine

    plain = Engine._step

    def step(self):
        return (plain(self) + 1) % self.cfg.vocab

    monkeypatch.setattr(Engine, "_step", step)


def _state_unchanged(monkeypatch):
    from repro_torch.core.serving import PCILTMambaDecode

    plain = PCILTMambaDecode.step

    def step(self, params, cache, *a, **kw):
        logits, _, *rest = plain(self, params, cache, *a, **kw)
        return (logits, cache, *rest)

    monkeypatch.setattr(PCILTMambaDecode, "step", step)


def _half_batch(monkeypatch):
    from repro_torch.core.serving import PCILTMambaDecode

    plain = PCILTMambaDecode.step

    def step(self, *a, **kw):
        logits, *rest = plain(self, *a, **kw)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return (logits, *rest)

    monkeypatch.setattr(PCILTMambaDecode, "step", step)


@pytest.mark.parametrize("workload", ["cnn-1024x768", "mamba-decode-4slots"])
def test_sound_run_is_correct(root, workload):
    rec, out = smoke.run(root, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("cnn-1024x768", _answer_altered),
    ("mamba-decode-4slots", _token_altered),
    ("mamba-decode-4slots", _state_unchanged),
    ("mamba-decode-4slots", _half_batch),
], ids=["cnn-answer-altered", "decode-token-altered",
        "decode-state-unchanged", "decode-half-batch"])
def test_fault_is_caught(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    rec, out = smoke.run(root, workload)
    assert not out["correct"], out["checks"]
