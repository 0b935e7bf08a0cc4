"""The parity tests' donor weights, drawn independently of ``hash()``.

The JAX package's ``materialize`` derives each leaf's key from Python's
salted ``hash()`` of its path, so its weights change from one process to
the next (``PYTHONHASHSEED``).  The parity tests draw their donor with
:func:`jax_donor` instead: each leaf from the port's recipe
(``repro_torch.nn.module.materialize``: ``default_rng([seed,
crc32(path)])``), handed to the JAX side as an array of the JAX spec's
dtype.  The same seed gives the same bytes in every process.
"""

import contextlib
import hashlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.nn.module import ParamSpec as JSpec
from repro_torch.nn.module import ParamSpec as TSpec
from repro_torch.nn.module import materialize as t_materialize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_specs(jspecs):
    if isinstance(jspecs, JSpec):
        return TSpec(tuple(jspecs.shape), init=jspecs.init,
                     scale=jspecs.scale, axes=tuple(jspecs.axes))
    return {k: _port_specs(v) for k, v in jspecs.items()}


def _to_jax(jspecs, t):
    if isinstance(jspecs, JSpec):
        return jnp.asarray(t.numpy(), dtype=jspecs.dtype)
    return {k: _to_jax(v, t[k]) for k, v in jspecs.items()}


def jax_donor(jspecs, seed: int = 0):
    """Parameters for the JAX spec tree ``jspecs``: every leaf drawn in
    float32 by the port's seeded recipe at its key path, then cast to the
    JAX spec's dtype."""
    return _to_jax(jspecs, t_materialize(_port_specs(jspecs), seed,
                                         device="cpu"))


@contextlib.contextmanager
def hash_free_engines():
    """Inside the block, the JAX ``Engine``'s own draws
    (``materialize(specs, PRNGKey(n))`` in ``repro.launch.serve``: its
    parameters, its cache, the chaos contract's probe cache) are made by
    :func:`jax_donor` with seed ``n``, so an engine's weights do not depend
    on ``PYTHONHASHSEED`` either.  The module's attribute is restored on
    exit; the package's files are not touched."""
    import repro.launch.serve as js

    orig = js.materialize

    def draw(specs, key):
        return jax_donor(specs, int(np.asarray(
            jax.random.key_data(key)).reshape(-1)[-1]))

    js.materialize = draw
    try:
        yield
    finally:
        js.materialize = orig


_DIGEST = """
import hashlib, sys
import numpy as np
sys.path.insert(0, {tests!r})
from test_torch_donor import jax_donor
from repro.configs import get_smoke_config
from repro.models import build_model
h = hashlib.sha256()
for arch in ("qwen3-0.6b", "mamba2-130m", "granite-moe-3b-a800m",
             "zamba2-7b"):
    p = jax_donor(build_model(get_smoke_config(arch)).param_specs(), 0)
    stack = [p]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t[k] for k in sorted(t, reverse=True))
        else:
            h.update(np.asarray(t).tobytes())
print(h.hexdigest())
"""


def test_donor_is_byte_equal_across_hash_seeds():
    """The smoke donors drawn in two processes under ``PYTHONHASHSEED=0``
    and ``=2`` are byte-equal."""
    code = _DIGEST.format(tests=os.path.join(ROOT, "tests"))
    digests = []
    for seed in ("0", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True,
                             timeout=300)
        digests.append(out.stdout.strip().splitlines()[-1])
    assert digests[0] == digests[1] and len(digests[0]) == 64


def test_hash_free_engine_draws_the_donor():
    """A JAX engine built inside :func:`hash_free_engines` holds the donor
    of seed 0 as its parameters and zeros as its cache."""
    from repro.configs import get_smoke_config
    from repro.launch import serve as js

    cfg = get_smoke_config("qwen3-0.6b")
    with hash_free_engines():
        eng = js.Engine(cfg, max_len=16, slots=2)
    want = jax_donor(eng.model.param_specs(), 0)
    got, ref = jax.tree.leaves(eng.params), jax.tree.leaves(want)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(got, ref)) and len(got) == len(ref)
    assert all(not np.asarray(a).any()
               for a in jax.tree.leaves(eng.cache["layers"]))
    from repro.nn import module as jmodule
    assert js.materialize is jmodule.materialize  # restored


def test_donor_leaves_follow_the_jax_specs():
    """Each leaf has its spec's shape and dtype; zeros and ones stay so."""
    specs = {"a": JSpec((3, 4), (None, None), jnp.bfloat16, "fan_in"),
             "b": {"c": JSpec((5,), (None,), jnp.float32, "ones")}}
    p = jax_donor(specs, 1)
    assert p["a"].shape == (3, 4) and p["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(p["b"]["c"]), np.ones(5))
    assert hashlib.sha256(np.asarray(jax_donor(specs, 1)["a"]).tobytes()) \
        .hexdigest() == hashlib.sha256(np.asarray(p["a"]).tobytes()) \
        .hexdigest()
