"""Deterministic synthetic data pipeline (a numpy-only copy of
``repro.data.pipeline``: the same arrays for every ``(seed, step, shard)``).

Host-side, seeded, shard-aware: batch contents are a pure function of
(seed, step, shard) so restarts and elastic re-sharding reproduce the same
global batch — the property the fault-tolerance tests assert.

``packed`` mode simulates a real LM corpus: documents of random length packed
into the sequence with EOS boundaries and a loss mask that ignores padding —
so the loss path exercises masking exactly as a production pipeline would.
Modality frontends are stubbed: ``memory`` (whisper frame
embeddings) and ``img_embeds`` (llava patch embeddings) come out of the same
seeded generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    packed: bool = True
    eos_id: int = 1
    n_shards: int = 1
    shard: int = 0
    # modality stubs
    memory_len: int = 0      # whisper encoder frames
    img_tokens: int = 0      # llava patch embeddings
    d_model: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(
                f"global_batch {self.global_batch} is not divisible by "
                f"n_shards {self.n_shards}")
        return self.global_batch // self.n_shards

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S = self.local_batch, self.seq_len
        toks = rng.integers(2, self.vocab, size=(B, S + 1), dtype=np.int32)
        mask = np.ones((B, S), np.float32)
        if self.packed:
            # documents ~ Zipf-ish lengths; EOS at boundaries; tail padding
            for b in range(B):
                pos = 0
                while pos < S:
                    doc = int(rng.integers(16, max(S // 2, 17)))
                    end = min(pos + doc, S)
                    toks[b, end - 1] = self.eos_id
                    pos = end
                pad_from = int(rng.integers(S - 8, S + 1))
                toks[b, pad_from:] = 0
                mask[b, pad_from:] = 0.0
        out = {
            "tokens": toks[:, :S],
            "labels": toks[:, 1 : S + 1],
            "loss_mask": mask,
        }
        if self.memory_len:
            out["memory"] = rng.standard_normal(
                (B, self.memory_len, self.d_model)).astype(np.float32)
        if self.img_tokens:
            out["img_embeds"] = rng.standard_normal(
                (B, self.img_tokens, self.d_model)).astype(np.float32)
        return out
