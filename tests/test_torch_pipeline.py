"""Port parity: ``runtime.pipeline.pipeline_apply`` over a single-process
stage mesh of ``"cpu"`` devices.

* the forward pass and the gradient against the sequential stages, in the
  port (2e-5 forward; rtol 5e-4, atol 5e-5 for the gradients: the
  reference's own test's tolerances);
* the same inputs through the reference's ``pipeline_apply`` in a
  subprocess with 8 forced host devices on an ``Auto``-axes stage mesh
  (its gradient fails under the default ``Explicit`` axes of this JAX),
  held to the same tolerances;
* stage parameters given placed (``nn.module.Placed``, the stage dim over
  ``"stage"``) and a transformer's blocks as stages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.nn import module as tmod
from repro_torch.runtime import pipeline_apply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, B, D = 4, 6, 2, 8

REF_PIPELINE = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.runtime.pipeline import pipeline_apply

S, M, B, D = 4, 6, 2, 8
rng = np.random.default_rng(0)
ws = jnp.asarray((0.3 * rng.normal(size=(S, D, D))).astype(np.float32))
x = jnp.asarray(rng.normal(size=(M, B, D)).astype(np.float32))
mesh = jax.make_mesh((S,), ("stage",), axis_types=(AxisType.Auto,))


def stage(w, a):
    return jnp.tanh(a @ w)


got = pipeline_apply(stage, ws, x, mesh)
g = jax.grad(lambda ws: jnp.sum(pipeline_apply(stage, ws, x, mesh) ** 2))(ws)
np.savez(sys.argv[1], ws=np.asarray(ws), x=np.asarray(x),
         out=np.asarray(got), grad=np.asarray(g))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "pipeline.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", REF_PIPELINE, str(out)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


def _stage(w, a):
    return torch.tanh(a @ w)


def _sequential(ws, x):
    h = x
    for s in range(ws.shape[0]):
        h = torch.tanh(h @ ws[s])
    return h


def _mesh(n=S):
    return make_mesh((n,), ("stage",), devices=["cpu"] * n)


def test_forward_and_gradient_match_sequential(ref):
    ws = torch.from_numpy(ref["ws"]).requires_grad_()
    x = torch.from_numpy(ref["x"])
    got = pipeline_apply(_stage, ws, x, _mesh())
    want = _sequential(ws, x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    g, = torch.autograd.grad((got ** 2).sum(), [ws])
    g2, = torch.autograd.grad((want ** 2).sum(), [ws])
    np.testing.assert_allclose(g.numpy(), g2.numpy(), rtol=5e-4, atol=5e-5)


def test_forward_and_gradient_match_reference(ref):
    ws = torch.from_numpy(ref["ws"]).requires_grad_()
    x = torch.from_numpy(ref["x"])
    got = pipeline_apply(_stage, ws, x, _mesh())
    np.testing.assert_allclose(got.detach().numpy(), ref["out"], rtol=2e-5,
                               atol=2e-5)
    g, = torch.autograd.grad((got ** 2).sum(), [ws])
    np.testing.assert_allclose(g.numpy(), ref["grad"], rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("n_stages,n_micro", [(1, 3), (2, 1), (4, 6),
                                              (3, 2)])
def test_schedule_shapes(n_stages, n_micro):
    """Any stage and microbatch count: ``M + S - 1`` ticks give the
    sequential result on the axis's first device."""
    g = torch.Generator().manual_seed(n_stages * 10 + n_micro)
    ws = 0.3 * torch.randn(n_stages, D, D, generator=g)
    x = torch.randn(n_micro, B, D, generator=g)
    got = pipeline_apply(_stage, ws, x, _mesh(n_stages))
    assert got.shape == x.shape and got.device == torch.device("cpu")
    np.testing.assert_allclose(got.numpy(), _sequential(ws, x).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_placed_stage_params(ref):
    """Stage parameters placed with their stage dim over ``"stage"``: each
    stage reads its own block; the result is the whole tensor's."""
    mesh = _mesh()
    ws = torch.from_numpy(ref["ws"])
    placed = tmod.Placed.place(ws, tmod.TablePlacement(
        mesh, ("stage", None, None)))
    assert all(b.shape[0] == 1 for b in placed.blocks.values())
    x = torch.from_numpy(ref["x"])

    def fn(p, a):
        return _stage(p["w"], a)

    got = pipeline_apply(fn, {"w": placed}, x, mesh)
    assert torch.equal(got, pipeline_apply(fn, {"w": ws}, x, mesh))


def test_transformer_blocks_as_stages():
    """The smoke qwen3's two blocks as two stages over three microbatches
    equal the blocks applied in order (bit-equal: the same operations)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import block_apply

    cfg = get_smoke_config("qwen3-0.6b")
    m = build_model(cfg)
    params = tmod.materialize(m.param_specs(), 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 2, 5, cfg.d_model, generator=g).to(cfg.dtype)
    pos = torch.arange(5)[None].expand(2, 5)

    def stage(p, a):
        return block_apply(p["sub0"], cfg, a, pos)[0]

    with torch.no_grad():
        got = pipeline_apply(stage, params["blocks"], x, _mesh(2))
        want = x
        for l in range(cfg.n_layers):
            want = torch.stack([stage(tmod.layer_view(params["blocks"], l),
                                      want[i]) for i in range(3)])
    assert torch.equal(got, want)
