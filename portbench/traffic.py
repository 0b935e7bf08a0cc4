"""The one traffic generator: it turns a traffic file's parameters and a run
seed into requests.  A traffic file (``traffic/<name>.json``) holds:

* ``"requests": "images"``: one image a request, ``"shape"`` ``[batch,
  height, width, channels]``, pixels uniform on ``"pixels"`` ``[low,
  high)``, made on the device from the seed; or
* ``"requests": "prompts"``: token prompts, each with the number of tokens
  to generate.  Lengths come in blocks of ``"strata"`` requests: a block
  holds the ``strata`` evenly spaced prompt lengths of
  ``"prompt_tokens"`` ``[low, high]``, prompt ``i`` paired with output
  length ``(i + strata // 2) % strata`` of the evenly spaced lengths of
  ``"output_tokens"``, in an order drawn from the seed: every seed offers
  the same requests, block by block, in another order.  ``"queued"`` of
  them are queued; tokens are uniform over the vocabulary.

``"loop": "closed"``: a client sends its next request when the previous
one has come back (one client sends images; a serving engine's slots are
the prompts' clients).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .weights import derive, generator

KINDS = ("images", "prompts")


def check(traffic: Dict) -> None:
    """Raise on a traffic file the generator cannot serve."""
    if traffic.get("loop") != "closed":
        raise ValueError(f"only closed loops are generated, not "
                         f"{traffic.get('loop')!r}")
    if traffic.get("requests") not in KINDS:
        raise ValueError(f"requests must be one of {KINDS}")


def images(traffic: Dict, seed: int, device,
           stream: str = "images") -> Iterator[torch.Tensor]:
    """An endless stream of NHWC float32 images on ``device`` (``stream``
    names a seed stream of its own: the requests', the calibration's, the
    warm-up's)."""
    g = generator(seed, stream, device)
    lo, hi = traffic["pixels"]
    shape = tuple(traffic["shape"])
    while True:
        yield torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def strata(lo: int, hi: int, n: int) -> List[int]:
    """``n`` lengths spread evenly over ``[lo, hi]``: the midpoints of ``n``
    equal parts."""
    return [lo + int((i + 0.5) * (hi - lo + 1) / n) for i in range(n)]


def prompts(traffic: Dict, seed: int, vocab: int
            ) -> List[Tuple[np.ndarray, int]]:
    """``(prompt tokens, tokens to generate)`` of every queued request."""
    rng = np.random.default_rng(derive(seed, "prompts"))
    n, count = traffic["strata"], traffic["queued"]
    p_len = strata(*traffic["prompt_tokens"], n)
    o_len = strata(*traffic["output_tokens"], n)
    pairs = [(p_len[i], o_len[(i + n // 2) % n]) for i in range(n)]
    out = []
    while len(out) < count:
        for i in rng.permutation(n):
            p, o = pairs[i]
            out.append((rng.integers(0, vocab, size=p), o))
    return out[:count]
