"""Port parity: the compressed gradient reduction (``optim.compress``)
against the reference's ``compressed_pmean`` and ``compress_grads_tree``.

The reference runs in one module-scoped subprocess with 8 forced host
devices: ``shard_map`` over a ``("data",)`` mesh of 4 and of 8 devices,
each shard's seeded local value in; the port runs on meshes of as many
``"cpu"`` devices, the same values stacked into a ``Placed`` cut over
``"data"``.  The subprocess also records what the reference's int8
scheme hands its collectives (the wrapped ``all_to_all`` and
``all_gather``), so the codes can be compared.

Held: the int8 codes and scales of every source bit-equal; each owner's
requantized codes within one code and its scale within 1e-6 relative; the
reduced value within one requantization step (the largest owner scale);
the residuals within 1e-6; bf16's reduced value within one bfloat16 ulp
of the mean's largest magnitude (``2**-7`` of it); none's within 1e-6 of
it; each scheme against the exact mean at the reference test's gates
(int8 3e-2, bf16 1e-2, none 1e-6).  ``compress_grads_tree`` on a granite
smoke gradient tree (four microbatches' gradients, one a shard) against
the reference's, leaf by leaf.  int8's counted bytes are under 0.75 x
none's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.nn import module as tmod
from repro_torch.optim import compress, compress_grads_tree, compressed_pmean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = (4, 8)
#: local shapes: padded to a multiple of the shards, and not
SHAPES = {"flat": (1001,), "matrix": (37, 16)}
GATES = {"int8": 3e-2, "bf16": 1e-2, "none": 1e-6}

REF = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, "tests")
from test_torch_compress import SHAPES, SHARDS, local_values
from repro.compat import shard_map
from repro.optim import compress_grads_tree, compressed_pmean

assert jax.device_count() >= 8
real_a2a, real_gather = jax.lax.all_to_all, jax.lax.all_gather
seen = []


def a2a(x, *a, **k):
    seen.append(x)
    return real_a2a(x, *a, **k)


def gather(x, *a, **k):
    seen.append(x)
    return real_gather(x, *a, **k)


jax.lax.all_to_all, jax.lax.all_gather = a2a, gather
SCHEMES = ("int8", "bf16", "none")
out = {}
for n in SHARDS:
    mesh = jax.make_mesh((n,), ("data",))
    for name in SHAPES:
        x = jnp.asarray(local_values(n, name))

        def body(xl):  # the three schemes in one compile
            got = []
            for scheme in SCHEMES:
                seen.clear()
                r, res = compressed_pmean(xl[0], "data", scheme)
                got += [r, res[None], *[s[None] for s in seen]]
            return tuple(got)

        specs = (P(), P("data"), *[P("data")] * 4, P(), P("data"), P(),
                 P("data"))
        got = iter(jax.jit(shard_map(body, mesh=mesh, in_specs=P("data"),
                                     out_specs=specs, check_vma=False))(x))
        for scheme in SCHEMES:
            tag = f"{n}|{name}|{scheme}"
            out[tag + "|reduced"] = np.asarray(next(got))
            out[tag + "|residual"] = np.asarray(next(got))
            if scheme == "int8":  # q, scales (a2a), q2, s2 (all_gather)
                for key in ("q", "s", "q2", "s2"):
                    out[f"{tag}|{key}"] = np.asarray(next(got))
grads = dict(np.load(sys.argv[2]))
tree = {k: jnp.asarray(v) for k, v in grads.items()}
mesh = jax.make_mesh((4,), ("data",))
red, res = jax.jit(shard_map(
    lambda t: compress_grads_tree({k: v[0] for k, v in t.items()}, "data",
                                  "int8"),
    mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False))(tree)
for k in red:
    out[f"tree|{k}"] = np.asarray(red[k])
np.savez(sys.argv[1], **out)
'''


def local_values(n, name):
    """The ``n`` shards' seeded local values, stacked ``[n, *shape]``."""
    rng = np.random.default_rng([n, len(name)])
    return rng.standard_normal((n, *SHAPES[name])).astype(np.float32)


def _mesh(n):
    return make_mesh((n,), ("data",), devices=["cpu"] * n)


def _stacked(a, mesh):
    return tmod.Placed.place(torch.from_numpy(np.ascontiguousarray(a)),
                             tmod.TablePlacement(
                                 mesh, ("data",) + (None,) * (a.ndim - 1)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def grads():
    """granite's smoke gradients of four microbatches (by leaf path),
    stacked ``[4, ...]``: one shard's local gradient each."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    m = build_model(cfg)
    params = tmod.materialize(m.param_specs(), 0, device="cpu")
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_()
    rng = np.random.default_rng(9)
    per = []
    for _ in range(4):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
             for k in ("tokens", "labels")}
        loss, _ = m.loss(params, b)
        g = torch.autograd.grad(loss, list(leaves.values()))
        per.append({k: v.detach().numpy() for k, v in zip(leaves, g)})
    return {k: np.stack([p[k] for p in per]) for k in leaves}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, grads):
    d = tmp_path_factory.mktemp("ref")
    np.savez(d / "grads.npz", **grads)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", REF, str(d / "out.npz"),
                        str(d / "grads.npz")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("scheme", ["int8", "bf16", "none"])
def test_compressed_pmean_matches_reference(ref, scheme, n, name):
    x = local_values(n, name)
    mesh = _mesh(n)
    red, res = compressed_pmean(_stacked(x, mesh), "data", scheme)
    assert red.spec == (None,) * len(SHAPES[name]) and res.spec[0] == "data"
    got, resid = red.join().numpy(), res.join().numpy()
    tag = f"{n}|{name}|{scheme}"
    want = ref[tag + "|reduced"]
    assert got.shape == want.shape == SHAPES[name]
    assert _rel(got, x.mean(0)) < GATES[scheme], scheme
    np.testing.assert_allclose(resid, ref[tag + "|residual"], rtol=0,
                               atol=1e-6)
    if scheme == "none":
        assert _rel(got, want) <= 1e-6
        assert not resid.any()
    elif scheme == "bf16":
        assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    else:
        step = float(ref[tag + "|s2"].max())
        assert np.abs(got - want).max() <= step * (1 + 1e-6)
    for blk, c in ((red.blocks[(i,)], i) for i in range(n)):
        assert torch.equal(blk, red.blocks[(0,)]), c  # every shard alike


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("n", SHARDS)
def test_int8_codes_and_scales_are_the_references(ref, n, name):
    """Every source's int8 codes and chunk scales bit-equal to what the
    reference's ``all_to_all`` sends; each owner's requantized codes
    within one code (its float32 sum may round apart at a tie) and its
    scale within 1e-6 relative."""
    x = local_values(n, name)
    devs = [torch.device("cpu")] * n
    flats = [compress._chunks(torch.from_numpy(v), n) for v in x]
    qs, scales, owned = compress._int8_codes(flats, devs)
    tag = f"{n}|{name}|int8"
    for i in range(n):
        assert qs[i].dtype == torch.int8
        np.testing.assert_array_equal(qs[i].numpy(), ref[tag + "|q"][i])
        np.testing.assert_array_equal(
            np.broadcast_to(scales[i].numpy(), (n, 1)), ref[tag + "|s"][i])
        q2, s2 = owned[i]
        assert np.abs(q2.numpy().astype(int)
                      - ref[tag + "|q2"][i].astype(int)).max() <= 1
        np.testing.assert_allclose(float(s2), ref[tag + "|s2"][i],
                                   rtol=1e-6)


def test_compress_grads_tree_matches_reference(ref, grads):
    """A granite smoke gradient tree over a (4,) ``"data"`` mesh: every
    leaf's int8 mean against the reference's (one requantization step of
    the leaf) and the exact mean (3e-2); the residual tree beside it."""
    mesh = _mesh(4)
    tree = {}
    for path, a in grads.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _stacked(a, mesh)
    stats = {}
    red, res = compress_grads_tree(tree, "data", "int8", stats=stats)
    assert stats["sent_bytes"] > 0
    red, res = _flat(red), _flat(res)
    assert sorted(red) == sorted(res) == sorted(grads)
    for k, a in grads.items():
        got = red[k].join().numpy()
        want = ref[f"tree|{k}"]
        assert got.shape == want.shape == a.shape[1:]
        scale = np.abs(a.mean(0)).max()
        assert _rel(got, a.mean(0)) < 3e-2 or scale < 1e-12, k
        # one requantization step: the largest owner's max|part| / 127
        assert np.abs(got - want).max() <= np.abs(want).max() / 127 * 1.01 \
            + 1e-12, k
        assert res[k].shape == a.shape


def test_int8_moves_fewer_bytes_than_float32():
    """The bytes the shards send (both phases), counted: int8 under 0.75 x
    none's (about a quarter: 1 B a value and a scale a chunk against 4
    B), bf16 half of none's."""
    x = local_values(8, "flat")
    mesh = _mesh(8)
    sent = {}
    for scheme in ("int8", "bf16", "none"):
        stats = {}
        compressed_pmean(_stacked(x, mesh), "data", scheme, stats=stats)
        sent[scheme] = stats["sent_bytes"]
    C = -(-1001 // 8)
    assert sent["none"] == 2 * 8 * 7 * C * 4
    assert sent["bf16"] * 2 == sent["none"]
    assert sent["int8"] == 2 * 8 * 7 * (C + 4)
    assert sent["int8"] < 0.75 * sent["none"]


def test_refuses_a_value_not_cut_over_the_axis():
    mesh = _mesh(4)
    whole = tmod.Placed.place(torch.zeros(4, 3), tmod.TablePlacement(
        mesh, (None, None)))
    with pytest.raises(ValueError, match="one value per"):
        compressed_pmean(whole, "data")
    with pytest.raises(ValueError, match="scheme"):
        compressed_pmean(_stacked(np.zeros((4, 3), np.float32), mesh),
                         "data", "fp8")
