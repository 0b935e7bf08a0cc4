"""Port parity: the sharding context (``nn.layers.Ctx``), the logical axes
of every spec and their placements (``nn.module``), and the per-shard
building blocks on exact grids.

* spec parity: for all 11 configurations (the ten architectures at their
  published sizes and the paper CNN), every parameter and cache leaf's
  logical axes and its partition spec equal the reference's, under the
  reference's own ``ShardingRules`` (which needs no devices) at mesh sizes
  (1, 2), (1, 3), (1, 4), (2, 2) and (2, 4);
* ``Placed``: a leaf cut into its blocks and joined again, a replicated
  leaf held once per distinct device, the FSDP join, the per-device byte
  check;
* exact grids (small integers: every partial sum is exact in bfloat16 and
  in float32, so sharded and unsharded results must be **bit-equal**): the
  column- and row-parallel ``dense``, the vocab-parallel embedding and
  logits, ``row_parallel`` and its gradient;
* ``row_parallel`` returns None exactly where the reference's does.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.models import build_model as j_build
from repro.models.cnn import PaperCNN as JCNN
from repro.nn import module as jmod
from repro_torch.configs import ARCHS, get_config as t_full
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_ctx
from repro_torch.models import build_model as t_build
from repro_torch.models.cnn import PaperCNN as TCNN
from repro_torch.nn import layers as tl
from repro_torch.nn import module as tmod

SIZES = ((1, 2), (1, 3), (1, 4), (2, 2), (2, 4))
CONFIGS = ARCHS + ("paper-cnn",)


def _specs(name):
    """``(reference specs, port specs)``: parameters and, for a language
    model, its cache at B = 4, T = 256 and at B = 1, T = 4096 (where the
    cache's time axis takes the data axes)."""
    if name == "paper-cnn":
        return ({"params": JCNN().param_specs()},
                {"params": TCNN(device="cpu").param_specs()})
    jm, tm = j_build(j_full(name)), t_build(t_full(name))
    return ({"params": jm.param_specs(), "cache": jm.cache_specs(4, 256),
             "cache1": jm.cache_specs(1, 4096)},
            {"params": tm.param_specs(), "cache": tm.cache_specs(4, 256),
             "cache1": tm.cache_specs(1, 4096)})


def _leaves(tree, cls, prefix=""):
    if isinstance(tree, cls):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, cls, f"{prefix}/{k}"))
    return out


def _ref_pspec(p):
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_axes_and_partition_specs_match_reference(name, size):
    """Every leaf: the same logical axes, shape and partition spec as the
    reference's under its ``DEFAULT_RULES`` on a (data, model) mesh of
    ``size``."""
    jspecs, tspecs = _specs(name)
    jl = _leaves(jspecs, jmod.ParamSpec)
    tl_ = _leaves(tspecs, tmod.ParamSpec)
    assert set(tl_) == set(jl)
    sizes = {"data": size[0], "model": size[1]}
    jr = jmod.ShardingRules(dict(jmod.DEFAULT_RULES), sizes)
    tr = tmod.ShardingRules(dict(tmod.DEFAULT_RULES), sizes)
    for path, js in jl.items():
        ts = tl_[path]
        assert tuple(ts.axes) == tuple(js.axes), path
        assert tuple(ts.shape) == tuple(js.shape), path
        want = _ref_pspec(jmod.logical_to_partition_spec(js.axes, js.shape,
                                                         jr))
        got = tmod.logical_to_partition_spec(ts.axes, ts.shape, tr)
        assert got == want, (path, got, want)


def test_rules_and_bytes_match_reference():
    """The rule table, the fallback of a tuple rule and ``spec_bytes``."""
    assert tmod.DEFAULT_RULES == jmod.DEFAULT_RULES
    sizes = {"pod": 2, "data": 4, "model": 8}
    jr = jmod.ShardingRules(dict(jmod.DEFAULT_RULES), sizes)
    tr = tmod.ShardingRules(dict(tmod.DEFAULT_RULES), sizes)
    for ax in ("batch", "embed", "cache_seq", "vocab", None):
        for dim in (1, 6, 8, 16, 24):
            assert tr.mesh_axes_for(ax, dim) == jr.mesh_axes_for(ax, dim)
    for name in ("qwen3-0.6b", "mamba2-130m", "whisper-medium"):
        jm, tm = j_build(j_full(name)), t_build(t_full(name))
        assert tmod.spec_bytes(tm.param_specs()) == \
            jmod.spec_bytes(jm.param_specs())
    with pytest.raises(ValueError, match="axes"):
        tmod.ParamSpec((2, 3), axes=("mlp",))
    with pytest.raises(TypeError):
        tmod.ParamSpec((2, 3))  # axes are required: nothing replicates


def test_ctx_constrain_and_data_axes():
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    ctx = make_ctx(mesh)
    x = torch.arange(8.0).reshape(2, 4)
    assert ctx.constrain(x, "batch", "seq_sp") is x
    assert ctx.data_axes == ("data",)
    assert tl.Ctx().data_axes == ()
    assert ctx.tp == 2 and ctx.rows() == [(0, 0), (1, 0)]
    assert ctx.batch_block((1, 0), 4) == (2, 4)
    assert ctx.batch_block((1, 0), 3) == (0, 3)  # 3 rows replicate
    assert make_ctx(mesh, {"cache_seq": "model"}, decode=True).rules.rules[
        "cache_seq"] == "model"


def test_placed_blocks_join_and_dedupe():
    """A (2, 2) CPU mesh: an FSDP x TP leaf is cut into four blocks and
    joined again; a replicated leaf on four coordinates of one device is
    one tensor; the FSDP join gives the shard's whole column block."""
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    p = tmod.Placed.place(t, tmod.TablePlacement(mesh, ("data", "model")))
    assert {c: tuple(b.shape) for c, b in p.blocks.items()} == \
        {c: (4, 3) for c in p.blocks}
    assert torch.equal(p.join(), t)
    assert torch.equal(p.blocks[(1, 0)], t[4:, :3])
    assert torch.equal(p.gather((1, 1), ("data", "pod")), t[:, 3:])
    assert p.expected_bytes() == 4 * 3 * 4
    r = tmod.Placed.place(t, tmod.TablePlacement(mesh, (None, None)))
    assert len(r.unique()) == 1  # four coordinates, one device, one copy
    assert all(b.data_ptr() == r.unique()[0][1].data_ptr()
               for b in r.blocks.values())
    two = make_host_mesh(1, 2, devices=["cpu", "meta"])
    r2 = tmod.Placed.place(t, tmod.TablePlacement(two, (None, None)))
    assert len(r2.unique()) == 2  # once per distinct device
    c = p.clone()
    c.fill_index_(0, 5, -1.0)
    assert torch.equal(c.join()[5], torch.full((6,), -1.0))
    assert torch.equal(p.join(), t)  # the clone's blocks are its own
    assert tmod.check_placed_bytes({"w": p, "r": r}) == 2
    p.blocks[(0, 1)] = p.blocks[(0, 1)][:2]
    with pytest.raises(RuntimeError, match="partition spec"):
        tmod.check_placed_bytes({"w": p})


def test_shardings_and_shape_structs():
    mesh = make_host_mesh(1, 4, devices=["cpu"] * 4)
    tm = t_build(t_full("qwen3-0.6b"))
    sh = tmod.shardings(tm.param_specs(), mesh)
    assert sh["blocks"]["sub0"]["attn"]["wq"]["kernel"].spec == \
        (None, "data", "model", None)
    ss = tmod.shape_structs(tm.param_specs(), mesh)
    e = ss["embed"]["embedding"]
    assert e.device.type == "meta" and tuple(e.shape) == (151936, 1024)
    assert e.sharding.spec == ("model", "data")
    assert tmod.shape_structs(tm.param_specs())["ln_f"]["scale"] \
        .sharding is None


# ----------------------------------------------------------------------------
# exact grids: sharded == unsharded, bit for bit
# ----------------------------------------------------------------------------


def _grid(shape, lo=-2, hi=3, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32)) \
        .to(dtype)


MESHES = ((1, 2), (1, 4), (2, 2))


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _placed(t, mesh, axes, rules=None):
    rules = rules or tmod.ShardingRules.for_mesh(mesh)
    return tmod.Placed.place(t, tmod.TablePlacement(
        mesh, tmod.logical_to_partition_spec(axes, t.shape, rules)))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_column_and_row_parallel_dense_exact(shape):
    """``column_parallel`` pieces joined equal ``dense``; the row-parallel
    partial sums reduced in float32 and cast once equal ``dense`` of the
    whole weight: bit-equal in bfloat16."""
    mesh = _mesh(shape)
    ctx = make_ctx(mesh)
    x = _grid((4, 3, 16), seed=1)
    w = _grid((16, 8, 4), seed=2)
    b = _grid((8, 4), seed=3)
    wp = {"kernel": _placed(w, mesh, ("embed", "heads", None)),
          "bias": _placed(b, mesh, ("heads", None))}
    want = tl.dense({"kernel": w, "bias": b}, x, torch.bfloat16)
    for row in ctx.rows():
        pieces = tl.column_parallel(ctx, row, wp, x, torch.bfloat16)
        assert len(pieces) == shape[1]
        got = tl.assemble(pieces, 0, 8, torch.device("cpu"), 2)
        assert torch.equal(got, want)
    wd = _grid((32, 16), seed=4)
    h = _grid((4, 3, 32), seed=5, dtype=torch.bfloat16)
    wdp = _placed(wd, mesh, ("mlp", "embed"))
    want = tl.dense({"kernel": wd}, h, torch.bfloat16)
    n = ctx.splits(wdp, 0)
    for row in ctx.rows():
        parts = [h[..., j * 32 // n:(j + 1) * 32 // n].float()
                 @ ctx.weight(wdp, row, j).to(torch.bfloat16).float()
                 for j in range(n)]
        assert torch.equal(ctx.reduce(parts, row, torch.bfloat16), want)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_vocab_parallel_embed_and_logits_exact(shape):
    """The vocab-parallel lookup and head, tied and untied, equal the
    unsharded ``embed`` and ``x @ E.T`` / ``dense`` bit for bit."""
    mesh = _mesh(shape)
    ctx = make_ctx(mesh)
    E = _grid((64, 16), seed=6)
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, 64, (4, 5)))
    Ep = _placed(E, mesh, ("vocab", "embed"))
    rows = tl.Rows({r: tok[slice(*ctx.batch_block(r, 4))]
                    for r in ctx.rows()}, 4)
    got = tl.vocab_embed(ctx, Ep, rows, torch.bfloat16)
    want = tl.embed({"embedding": E}, tok, torch.bfloat16)
    x = _grid((4, 5, 16), seed=8, dtype=torch.bfloat16)
    head = _grid((16, 64), seed=9)
    hp = _placed(head, mesh, ("embed", "vocab"))
    xr = tl.Rows({r: x[slice(*ctx.batch_block(r, 4))] for r in ctx.rows()},
                 4)
    tied = tl.vocab_logits(ctx, Ep, xr, torch.bfloat16, tied=True)
    untied = tl.vocab_logits(ctx, hp, xr, torch.bfloat16, tied=False)
    for r in ctx.rows():
        sl = slice(*ctx.batch_block(r, 4))
        assert torch.equal(got[r], want[sl])
        assert torch.equal(tied[r], (x @ E.to(torch.bfloat16).T)[sl])
        assert torch.equal(untied[r],
                           tl.dense({"kernel": head}, x, torch.bfloat16)[sl])


def _row_parallel_inputs(mesh, ctx, S=8, seed=10):
    x = _grid((4, S, 4, 8), seed=seed, dtype=torch.bfloat16)
    w = _grid((4, 8, 16), seed=seed + 1)
    xp = _placed(x, mesh, ("batch", None, "heads", None), ctx.rules)
    wp = _placed(w, mesh, ("heads", None, "embed"), ctx.rules)
    return x, w, xp, wp


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_row_parallel_exact_and_differentiable(shape):
    """Per-shard einsums added in shard order and split over the sequence
    onto the model devices: joined, bit-equal to the whole einsum; the
    gradients through autograd equal the unsharded ones (exact grid)."""
    mesh = _mesh(shape)
    ctx = make_ctx(mesh, explicit_rs=True)
    x, w, xp, wp = _row_parallel_inputs(mesh, ctx)
    y = tl.row_parallel(xp, wp, "bshd,hde->bse", ctx=ctx)
    assert y.spec == ("data", "model", None)
    want = torch.einsum("bshd,hde->bse", x.float(),
                        w.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(y.join(), want)
    # gradients: the blocks are autograd leaves of their own
    for t in list(xp.blocks.values()) + list(wp.blocks.values()):
        t.requires_grad_()
    y = tl.row_parallel(xp, wp, "bshd,hde->bse", ctx=ctx)
    loss = sum((b.float() ** 2).sum() for _, b in y.unique())
    xb = xp.unique()[0][1]
    g_x, = torch.autograd.grad(loss, [xb])
    xw = x.clone().requires_grad_()
    ww = w.clone().requires_grad_()
    ref = torch.einsum("bshd,hde->bse", xw.float(),
                       ww.to(torch.bfloat16).float()).to(torch.bfloat16)
    gx_ref, = torch.autograd.grad((ref.float() ** 2).sum(), [xw])
    (b0, b1), _, (h0, h1), _ = xp.ranges(xp.unique()[0][0])
    assert torch.equal(g_x, gx_ref[b0:b1, :, h0:h1])


def test_row_parallel_returns_none_where_the_reference_does():
    mesh = _mesh((1, 4))
    on = make_ctx(mesh, explicit_rs=True)
    x, w, xp, wp = _row_parallel_inputs(mesh, on)
    eq = "bshd,hde->bse"
    assert tl.row_parallel(xp, wp, eq, ctx=tl.Ctx()) is None  # no mesh
    assert tl.row_parallel(xp, wp, eq, ctx=make_ctx(mesh)) is None  # off
    one = make_ctx(_mesh((2, 1)), explicit_rs=True)
    assert tl.row_parallel(xp, wp, eq, ctx=one) is None  # model axis of 1
    for S in (6, 2):  # 4 does not divide 6; 2 < 4
        x, w, xp, wp = _row_parallel_inputs(mesh, on, S=S)
        assert tl.row_parallel(xp, wp, eq, ctx=on) is None
    x, w, xp, wp = _row_parallel_inputs(mesh, on, S=4)
    assert tl.row_parallel(xp, wp, eq, ctx=on) is not None
