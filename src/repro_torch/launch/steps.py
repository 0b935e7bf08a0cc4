"""Step-function factories (port of the serving half of
``repro.launch.steps``): prefill and decode for any ported config.

The reference closes its steps over a sharding context (``make_ctx``); the
port has no mesh yet, so the steps close over the model alone.
``make_train_step`` waits for training.
"""

from __future__ import annotations

from repro_torch.models import build_model

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg):
    """``prefill_step(params, batch) -> (logits [B, Vp], cache)``."""
    model = build_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg):
    """``serve_step(params, cache, tokens [B, 1]) -> (logits [B, Vp],
    new cache)``; the padded vocabulary's logits are set to -1e30, so a
    padded id is never sampled."""
    model = build_model(cfg)

    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode_step(params, cache, tokens)
        if cfg.padded_vocab > cfg.vocab:
            logits[..., cfg.vocab:] = -1e30
        return logits, new_cache

    return serve_step
