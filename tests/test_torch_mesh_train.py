"""Port parity: training on a mesh (``make_train_step(cfg, mesh, ocfg,
...)``), the optimizer on placed trees, ``adamw_init_specs`` and the
elastic ``restore(shardings=)``.

The train step at the smoke configs of qwen3-0.6b, mamba2-130m and
zamba2-7b (cut to 4 layers) on CPU meshes of ``"cpu"`` devices, with the parameters placed by
``nn.module.shardings``, held three ways: against the reference
unsharded, the reference's own step on the same ``Auto``-axes mesh (one
module-scoped subprocess with 8 forced host devices; the reference's
``make_host_mesh`` builds ``Explicit`` axes, under which its mesh path
fails in this JAX), and the port unsharded.  Variants: the default step,
``bf16_grads`` with ``grad_accum = 2``, ``explicit_rs`` (qwen3) and
ZeRO-1 (qwen3: ``rule_overrides={"embed": None, "opt_embed": ("data",
"pod")}`` with ``grad_shardings`` from ``adamw_init_specs(remap_axes=
{"embed": "opt_embed"})``).  The reference runs its default step
unsharded too; each compiled step costs seconds, so its other variants
run on the mesh only.

Metrics and tolerances are ``test_torch_train.py::
test_train_step_matches_reference``'s, at float32 compute: loss, ce and z
to 1e-5; the gradients (read off a probe optimizer: ``b1 = 0``, no
clipping, zero moments, so the first moment after one update is the
gradient) of the 1-D leaves within 1e-5 of each leaf's largest, of the
bfloat16-cast leaves and the global norm within one bfloat16 step
(2**-7).  The Mamba-based families' gradients are held within 2e-2 of
each leaf's largest (their SSD rounds its O(T) operands to bfloat16, as
``test_torch_train.py`` says).  A bfloat16 step is held to the port
unsharded, loss within 1e-2.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.nn.module import ParamSpec as JSpec
from repro.optim import AdamWConfig as JAdam
from repro.optim import adamw_init_specs as j_init_specs
from repro_torch.checkpoint import Checkpointer, restore, save
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data import SyntheticLM
from repro_torch.interop import params_from_jax, tree_leaves, tree_map
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_ctx, make_train_step
from repro_torch.models import build_model as t_build
from repro_torch.nn import module as tmod
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_init_specs,
                               adamw_update)
from test_torch_donor import jax_donor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 16
ZERO1 = {"embed": None, "opt_embed": ("data", "pod")}
REMAP = {"embed": "opt_embed"}
#: (arch, variant) -> the reference's mesh steps; the variants: kwargs of
#: make_train_step past ``ocfg`` and the config's grad_accum
VARIANTS = {"base": ({}, 1), "bf16acc": ({"bf16_grads": True}, 2),
            "rowrs": ({"explicit_rs": True}, 1),
            "zero1": ({"rule_overrides": ZERO1, "zero1": True}, 1)}
CASES = [("qwen3-0.6b", v) for v in ("base", "bf16acc", "rowrs", "zero1")] \
    + [(a, v) for a in ("mamba2-130m", "zamba2-7b")
       for v in ("base", "bf16acc")]
MESH = (2, 2)

#: the reference's steps, unsharded and on a (2, 2) ``Auto``-axes mesh:
#: the probe step's metrics and gradients by leaf path
REF_TRAIN = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, "tests")
from test_torch_donor import jax_donor
from test_torch_mesh_train import (CASES, MESH, REMAP, VARIANTS, batch,
                                   config, flat)
from repro.launch.steps import make_ctx, make_train_step
from repro.models import build_model
from repro.nn.module import shardings
from repro.optim import AdamWConfig, adamw_init, adamw_init_specs

assert jax.device_count() >= 8, jax.device_count()
probe = AdamWConfig(lr=0.0, weight_decay=0.0, b1=0.0, clip_norm=0.0)
mesh = jax.make_mesh(MESH, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, variant in CASES:
    kw, accum = VARIANTS[variant]
    kw = dict(kw)
    zero1 = kw.pop("zero1", False)
    cfg = config(arch, "jax", grad_accum=accum)
    specs = build_model(cfg).param_specs()
    p = jax_donor(specs, 0)
    b = {k: jnp.asarray(v) for k, v in batch(cfg).items()}
    runs = [("mesh", mesh)] + ([("whole", None)] if variant == "base"
                               else [])
    for where, m in runs:
        ov = kw.get("rule_overrides")
        pd, gs = p, None
        if m is not None:
            rules = make_ctx(m, ov).rules
            pd = jax.device_put(p, shardings(specs, m, rules))
            if zero1:
                gs = shardings(adamw_init_specs(specs, probe, REMAP)["m"],
                               m, rules)
        step = make_train_step(cfg, m, probe, kw.get("bf16_grads", False),
                               ov, gs, kw.get("explicit_rs", False))
        _, st, met = jax.jit(step)(pd, adamw_init(pd, probe), b)
        tag = f"{arch}|{variant}|{where}"
        out[tag + "|metrics"] = np.asarray(
            [met[k] for k in ("loss", "ce", "z", "grad_norm")], np.float32)
        for path, g in flat(st["m"]).items():
            out[f"{tag}|g|{path}"] = np.asarray(
                jnp.asarray(g).astype(jnp.float32))
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are small (the steps run faster
    so), and the other test workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch, pkg, dtype="float32", **kw):
    """The smoke config of ``arch`` in either package, computing in
    ``dtype``; zamba2's cut to 4 layers (two segments: both shared sets
    run), which saves the reference seconds of compilation a step."""
    cfg = (j_smoke if pkg == "jax" else t_smoke)(arch)
    if arch == "zamba2-7b":
        kw = {"n_layers": 4, **kw}
    return dataclasses.replace(cfg, dtype=getattr(
        jnp if pkg == "jax" else torch, dtype), **kw)


def batch(cfg):
    return SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B,
                       seed=3).batch(0)


def flat(tree, prefix=""):
    """A tree's leaves by ``a/b/c`` path (placed leaves joined)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, tmod.Placed):
        tree = tree.join()
    return {prefix: tree}


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def ref_train(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "train.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", REF_TRAIN, str(out)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def donors():
    return {arch: jax.tree.map(np.asarray, jax_donor(
        j_build(config(arch, "jax")).param_specs(), 0))
        for arch in ("qwen3-0.6b", "mamba2-130m", "zamba2-7b")}


PROBE = AdamWConfig(lr=0.0, weight_decay=0.0, b1=0.0, clip_norm=0.0)


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def port_step(arch, variant, donor, shape=None, dtype="float32",
              ocfg=PROBE):
    """The port's probe step of one case: ``(metrics, grads by path,
    new params, new state)``; on ``shape``'s mesh with the parameters (and
    for ZeRO-1 the moments) placed, else unsharded."""
    kw, accum = VARIANTS[variant]
    kw = dict(kw)
    zero1 = kw.pop("zero1", False)
    cfg = config(arch, "torch", dtype, grad_accum=accum)
    specs = t_build(cfg).param_specs()
    mesh = None if shape is None else _mesh(shape)
    params = params_from_jax(donor, "cpu")
    opt = None
    if mesh is not None:
        rules = make_ctx(mesh, kw.get("rule_overrides")).rules
        params = tmod.place(params, tmod.shardings(specs, mesh, rules))
        if zero1:
            osh = tmod.shardings(adamw_init_specs(specs, ocfg, REMAP), mesh,
                                 rules)
            kw["grad_shardings"] = osh["m"]
            whole = adamw_init(params_from_jax(donor, "cpu"), ocfg)
            opt = dict(whole, m=tmod.place(whole["m"], osh["m"]),
                       v=tmod.place(whole["v"], osh["v"]))
    else:
        kw.pop("rule_overrides", None)
    step = make_train_step(cfg, mesh, ocfg, **kw)
    new_p, st, met = step(params, opt or adamw_init(params, ocfg),
                          {k: torch.from_numpy(v)
                           for k, v in batch(cfg).items()})
    metrics = np.asarray([float(met[k]) for k in ("loss", "ce", "z",
                                                   "grad_norm")], np.float32)
    return metrics, flat(st["m"]), new_p, st


def check_against(arch, metrics, grads, want_metrics, want_grads, what):
    """The module's tolerances: loss, ce, z 1e-5; grad_norm 2**-7; the
    gradients of 1-D leaves 1e-5 of each leaf's largest, of cast leaves
    2**-7 (2e-2 for the Mamba-based families)."""
    for i, k in enumerate(("loss", "ce", "z", "grad_norm")):
        np.testing.assert_allclose(
            metrics[i], want_metrics[i],
            rtol=2 ** -7 if k == "grad_norm" else 1e-5, err_msg=f"{what} {k}")
    ssm = arch != "qwen3-0.6b"
    assert sorted(grads) == sorted(want_grads), what
    for k, want in want_grads.items():
        got = _np(grads[k])
        want = _np(want)
        assert got.shape == want.shape, (what, k)
        tol = 2e-2 if ssm else (2 ** -7 if got.ndim > 1 else 1e-5)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"{what} {k}")


def _ref(ref_train, arch, variant, where):
    tag = f"{arch}|{variant}|{where}"
    grads = {k.split("|g|", 1)[1]: v for k, v in ref_train.items()
             if k.startswith(tag + "|g|")}
    return ref_train[tag + "|metrics"], grads


@pytest.mark.parametrize("arch,variant", CASES,
                         ids=[f"{a}-{v}" for a, v in CASES])
def test_train_step_on_mesh_matches_reference(ref_train, donors, arch,
                                              variant):
    """One probe step on the (2, 2) mesh against the reference's step on
    the same mesh, the reference unsharded (the ``bf16acc`` variant's
    unsharded reference is the port's, held to the reference by
    ``test_torch_train.py``) and the port unsharded (metrics and every
    leaf's gradient)."""
    donor = donors[arch]
    metrics, grads, new_p, st = port_step(arch, variant, donor, MESH)
    assert isinstance(new_p["ln_f"]["scale"], tmod.Placed)
    check_against(arch, metrics, grads,
                  *_ref(ref_train, arch, variant, "mesh"), "reference mesh")
    base = "bf16acc" if variant == "bf16acc" else "base"
    if base == "base":
        check_against(arch, metrics, grads,
                      *_ref(ref_train, arch, base, "whole"),
                      "reference unsharded")
    wm, wg, _, _ = port_step(arch, base, donor)
    check_against(arch, metrics, grads, wm, wg, "port unsharded")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m", "zamba2-7b"])
def test_train_step_on_a_model_axis_only(ref_train, donors, arch):
    """The same on (1, 2): tensor parallel, no FSDP join, against the
    reference unsharded and the port unsharded."""
    metrics, grads, _, _ = port_step(arch, "base", donors[arch], (1, 2))
    check_against(arch, metrics, grads, *_ref(ref_train, arch, "base",
                                              "whole"), "reference")
    wm, wg, _, _ = port_step(arch, "base", donors[arch])
    check_against(arch, metrics, grads, wm, wg, "port unsharded")


def test_a_scaled_replicated_gradient_fails_the_parity(ref_train, donors,
                                                       monkeypatch):
    """The mutation check: the mesh step's gradient of one replicated leaf
    (the final norm's scale) scaled by 1.001 fails the parity above."""
    real = tsteps._value_and_grad

    def scaled(fn, params, b):
        out, grads = real(fn, params, b)
        g = grads["ln_f"]["scale"]
        grads["ln_f"]["scale"] = g.map(lambda t: t * 1.001)
        return out, grads

    monkeypatch.setattr(tsteps, "_value_and_grad", scaled)
    metrics, grads, _, _ = port_step("qwen3-0.6b", "base",
                                     donors["qwen3-0.6b"], MESH)
    with pytest.raises(AssertionError, match="ln_f/scale"):
        check_against("qwen3-0.6b", metrics, grads,
                      *_ref(ref_train, "qwen3-0.6b", "base", "mesh"),
                      "reference mesh")


def test_explicit_rs_and_zero1_equal_the_default_step(donors):
    """``explicit_rs`` (row_parallel in every ``wo``/``wd``) and ZeRO-1
    (moments placed by ``adamw_init_specs(remap_axes=)``, gradients
    re-placed onto them) give the default mesh step's parameters, joined,
    bit for bit: the same sums, the update run on other blocks."""
    ocfg = AdamWConfig(lr=1e-3)
    _, _, base, _ = port_step("qwen3-0.6b", "base", donors["qwen3-0.6b"],
                              MESH, ocfg=ocfg)
    for variant in ("rowrs", "zero1"):
        _, _, got, st = port_step("qwen3-0.6b", variant,
                                  donors["qwen3-0.6b"], MESH, ocfg=ocfg)
        for k, v in flat(base).items():
            assert torch.equal(flat(got)[k], v), (variant, k)
    m = st["m"]["blocks"]["sub0"]["mlp"]["wg"]["kernel"]
    p = got["blocks"]["sub0"]["mlp"]["wg"]["kernel"]
    assert m.spec[1] == "data" and p.spec[1] is None  # ZeRO-1's layouts


def test_row_parallel_is_taken_under_explicit_rs(donors, monkeypatch):
    """``explicit_rs=True`` routes each block's attention ``wo`` and MLP
    ``wd`` through ``row_parallel`` (two a layer), the default none."""
    from repro_torch.nn import layers

    calls = []
    real = layers.row_parallel

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(layers, "row_parallel", spy)
    cfg = config("qwen3-0.6b", "torch")
    port_step("qwen3-0.6b", "base", donors["qwen3-0.6b"], MESH)
    assert not calls
    port_step("qwen3-0.6b", "rowrs", donors["qwen3-0.6b"], MESH)
    assert sum(calls) == 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m", "zamba2-7b"])
def test_bf16_train_step_on_mesh_matches_unsharded(donors, arch):
    """bfloat16 compute on (2, 2): loss within 1e-2 of the port
    unsharded, the gradient norm within 1e-2."""
    ocfg = AdamWConfig()
    got, _, _, _ = port_step(arch, "base", donors[arch], MESH, "bfloat16",
                             ocfg)
    want, _, _, _ = port_step(arch, "base", donors[arch], None, "bfloat16",
                              ocfg)
    np.testing.assert_allclose(got[[0, 3]], want[[0, 3]], rtol=1e-2)


def test_allreduce_replicas_adds_in_mesh_order():
    """A block held on two devices (two tensors of one block index): the
    all-reduce adds them in float32 in coordinate order on the first
    one's device and gives each the sum; a leaf with no such replica is
    returned as it is."""
    mesh = _mesh((2, 1))
    place = tmod.TablePlacement(mesh, (None,))
    a = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    b = torch.tensor([0.5, 4.0], dtype=torch.bfloat16)
    g = tmod.Placed(place, (2,), torch.bfloat16, {(0, 0): a, (1, 0): b})
    out = tsteps._allreduce_replicas(g)
    want = (a.float() + b.float()).to(torch.bfloat16)
    assert all(torch.equal(t, want) for t in out.blocks.values())
    assert out.blocks[(0, 0)] is not out.blocks[(1, 0)]
    t = a.float()
    one = tmod.Placed(place, (2,), torch.float32, {(0, 0): t, (1, 0): t})
    assert tsteps._allreduce_replicas(one) is one


# ----------------------------------------------------------------------------
# the optimizer on placed trees and its specs
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_update_on_placed_trees_is_the_whole_update(quantize):
    """Placed parameters, gradients and moments (the int8 moments' row
    scales maxed over the blocks of a row) update bit for bit as the whole
    tree does, each block on its block's device; ZeRO-1 moments (placed by
    ``adamw_init_specs(remap_axes=)``) too."""
    cfg = config("qwen3-0.6b", "torch")
    specs = t_build(cfg).param_specs()
    whole = tmod.materialize(specs, 0, device="cpu")
    g = tmod.materialize(specs, 1, device="cpu")
    ocfg = AdamWConfig(lr=1e-2, quantize_moments=quantize)
    st = adamw_init(whole, ocfg)
    p1, s1, m1 = adamw_update(g, st, whole, ocfg)
    p2, s2, m2 = adamw_update(g, s1, p1, ocfg)
    for ov, remap in ((None, None), (ZERO1, REMAP)):
        mesh = _mesh(MESH)
        rules = make_ctx(mesh, ov).rules
        psh = tmod.shardings(specs, mesh, rules)
        osh = tmod.shardings(adamw_init_specs(specs, ocfg, remap), mesh,
                             rules)
        pp = tmod.place(whole, psh)
        pst = adamw_init(pp, ocfg)
        if remap:
            pst = dict(pst, m=tmod.place(adamw_init(whole, ocfg)["m"],
                                         osh["m"]),
                       v=tmod.place(adamw_init(whole, ocfg)["v"], osh["v"]))
        gp = tmod.place(g, psh)
        q1, t1, n1 = adamw_update(gp, pst, pp, ocfg)
        q2, t2, n2 = adamw_update(gp, t1, q1, ocfg)
        assert float(n2["grad_norm"]) == pytest.approx(
            float(m2["grad_norm"]), rel=1e-6)
        for k, v in flat(p2).items():
            assert torch.equal(flat(q2)[k], v), k
        for k, v in flat(s2["m"]).items():
            assert torch.equal(flat(t2["m"])[k], v), k
        if remap:
            lead = t2["m"]["blocks"]["sub0"]["mlp"]["wg"]["kernel"]
            lead = lead["q"] if quantize else lead
            assert lead.spec[1] == "data"


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("remap", [None, REMAP])
def test_adamw_init_specs_match_reference(quantize, remap):
    """The state's spec tree (shapes, dtypes, init and logical axes, the
    int8 moments' row scales included) as the reference's, for every
    config's smoke parameter specs."""
    for arch in ("qwen3-0.6b", "mamba2-130m", "zamba2-7b",
                 "granite-moe-3b-a800m"):
        jspecs = j_build(j_smoke(arch)).param_specs()
        tspecs = t_build(t_smoke(arch)).param_specs()
        want = j_init_specs(jspecs, JAdam(quantize_moments=quantize), remap)
        got = adamw_init_specs(tspecs, AdamWConfig(
            quantize_moments=quantize), remap)
        wl = jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, JSpec))
        gl = flat(got)
        assert len(wl) == len(gl)
        for path, w in wl:
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            s = gl[name]
            assert tuple(s.shape) == tuple(w.shape), name
            assert tuple(s.axes) == tuple(w.axes), name
            assert str(s.dtype).split(".")[-1] == str(np.dtype(w.dtype)), name
            assert s.init == w.init == "zeros", name


# ----------------------------------------------------------------------------
# the elastic restore and the trainer on a mesh
# ----------------------------------------------------------------------------


def test_elastic_restore_with_shardings(tmp_path):
    """A placed (2, 2) train state saved (its joined leaves, the
    reference's layout, readable by the reference) and restored onto a
    (1, 4) mesh by ``restore(shardings=)``: bit-equal, each leaf placed by
    its new placement; the reference's restore reads the same files.  The
    port's counterpart of ``test_checkpoint.py::
    test_elastic_restore_with_shardings``."""
    from repro.checkpoint import restore as j_restore

    cfg = config("qwen3-0.6b", "torch")
    specs = t_build(cfg).param_specs()
    whole = tmod.materialize(specs, 0, device="cpu")
    ocfg = AdamWConfig()
    st = {"params": tmod.place(whole, tmod.shardings(specs, _mesh(MESH))),
          "opt": adamw_init(whole, ocfg)}
    save(str(tmp_path), 3, st, extra={"arch": cfg.name})
    new = _mesh((1, 4))
    sh = {"params": tmod.shardings(specs, new),
          "opt": tree_map(lambda _: None, st["opt"])}
    got, extra = restore(str(tmp_path), 3, tree_map(lambda _: None, st), sh,
                         device="cpu")
    assert extra == {"arch": cfg.name}
    emb = got["params"]["embed"]["embedding"]
    assert isinstance(emb, tmod.Placed) and emb.spec[0] == "model"
    assert emb.blocks[(0, 3)].shape[0] == emb.shape[0] // 4
    assert tmod.check_placed_bytes(got["params"]) > 0
    for k, v in flat(whole).items():
        assert torch.equal(flat(got["params"])[k], v), k
    jtree = jax.tree.map(np.asarray, jax_donor(
        j_build(j_smoke("qwen3-0.6b")).param_specs(), 0))
    back, _ = j_restore(str(tmp_path), 3, {"opt": jax.tree.map(
        np.asarray, {"count": 0, "m": jtree, "v": jtree}),
        "params": jtree})
    for k, v in flat(whole).items():
        np.testing.assert_array_equal(
            np.asarray(flat(back["params"])[k]), v.numpy())
    ck = Checkpointer(str(tmp_path))
    step, again, _ = ck.restore_latest(tree_map(lambda _: None, st), sh,
                                       device="cpu")
    assert step == 3
    assert all(torch.equal(a.join(), b.join()) for a, b in zip(
        tree_leaves(again["params"]), tree_leaves(got["params"])))


def test_trainer_on_a_mesh_restarts_bit_equal(tmp_path, capsys):
    """``launch.train.run(cfg, args, mesh=)`` on a (2, 2) CPU mesh (the
    path more than one card takes): a fault after a checkpoint restores
    the placed state and ends on the uninterrupted run's parameters and
    optimizer state, bit for bit; the losses follow the unsharded run's
    within 1e-2."""
    cfg = t_smoke("qwen3-0.6b")
    args = train.parse_args(["--device", "cpu", "--steps", "12", "--seq",
                             "16", "--batch", "4", "--ckpt-every", "5",
                             "--log-every", "5"])
    mesh = _mesh(MESH)
    args.ckpt_dir, args.fail_at = str(tmp_path / "a"), [7]
    got = train.run(cfg, args, mesh=mesh)
    assert "restored checkpoint at step 5" in capsys.readouterr().out
    args.ckpt_dir, args.fail_at = str(tmp_path / "b"), []
    clean = train.run(cfg, args, mesh=mesh)
    assert got["stats"]["restarts"] == 1
    assert isinstance(got["params"]["ln_f"]["scale"], tmod.Placed)
    for a, b in zip(tree_leaves({"p": got["params"], "o": got["opt"]}),
                    tree_leaves({"p": clean["params"], "o": clean["opt"]})):
        a = a.join() if isinstance(a, tmod.Placed) else a
        b = b.join() if isinstance(b, tmod.Placed) else b
        assert torch.equal(a, b)
    args.ckpt_dir = str(tmp_path / "c")
    whole = train.run(cfg, args)
    np.testing.assert_allclose(clean["losses"], whole["losses"], rtol=1e-2)


# ----------------------------------------------------------------------------
# remat under a mesh
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium",
                                  "mamba2-130m", "zamba2-7b"])
def test_mesh_loss_does_not_depend_on_the_remat_policy(arch):
    """``loss(ctx=)`` on (2, 2) under ``none``, ``full`` and ``dots``: the
    same loss and gradients of every placed block, bit for bit."""
    mesh = _mesh(MESH)
    ctx = make_ctx(mesh)
    runs = []
    for policy in ("none", "full", "dots"):
        cfg = config(arch, "torch", "bfloat16", remat_policy=policy,
                     loss_chunk=8)
        model = t_build(cfg)
        params = tmod.place(tmod.materialize(model.param_specs(), 0,
                                             device="cpu"),
                            tmod.shardings(model.param_specs(), mesh))
        params = tree_map(tsteps._fresh, params)
        b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
        if cfg.encoder_layers:
            b["memory"] = torch.from_numpy(np.random.default_rng(1).normal(
                size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32))
        loss, _ = model.loss(params, b, ctx=ctx)
        blocks = [t for leaf in tree_leaves(params)
                  for t in tsteps._distinct(leaf)]
        runs.append((float(loss), torch.autograd.grad(loss, blocks,
                                                      allow_unused=True)))
    for loss, grads in runs[1:]:
        assert loss == runs[0][0]
        for g, w in zip(grads, runs[0][1]):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)
