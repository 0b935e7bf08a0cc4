"""The port's public signatures against the reference's.

For every public function and class that a module of ``repro_torch`` shares
(by name) with its counterpart in ``repro``, and every public method of such
a class, a positional call must bind the same parameters in both packages.
The rule, after setting aside the reference parameters the port leaves out
by design (``ctx`` and ``axes``, keyword-only in the port, and ``key``
where the port takes a ``seed`` or ``generator`` in its place), and
``mesh``/``mesh_axis`` of the names whose mesh is still queued
(:data:`MESH_QUEUED`, empty now that every mesh is ported; the rule test
keeps the set-aside working on a stand-in name):

* the port's positional parameters are a prefix of the reference's, in the
  reference's order;
* every port parameter after the first reference parameter the port lacks
  is keyword-only (which the prefix rule implies: a positional one there
  would break the prefix).

Then one positional call each of ``Engine``, ``pcilt_linear``,
``ModelConfig``, ``make_train_step`` and ``MambaLM.calibrate_pcilt`` in
both packages, showing the same meaning (and the positional ``mesh`` of
``pcilt_linear``, ``Engine`` and ``make_train_step``).
"""

import importlib
import inspect
import os
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch

#: reference parameters the port leaves out by design
BY_DESIGN = {"ctx", "axes"}
#: the shared names whose ``mesh``/``mesh_axis`` wait for a slice (none)
MESH_QUEUED: tuple = ()
#: a stand-in queued name for the rule test
_STANDIN = "repro_torch.example.queued_fn"
#: the port's stand-ins for the reference's PRNG ``key``
KEY_STANDINS = {"seed", "generator"}
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _port_modules():
    out = []
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        out.append(m.name)
    return sorted(out)


def _positional(sig):
    names = [p.name for p in sig.parameters.values() if p.kind in _POSITIONAL]
    return names[1:] if names[:1] == ["self"] else names


def _set_aside(name, queued=MESH_QUEUED):
    """The reference parameters set aside for the shared name ``name``
    (``queued``: the names whose mesh waits)."""
    if any(name == q or name.startswith(q + ".") for q in queued):
        return BY_DESIGN | {"mesh", "mesh_axis"}
    return BY_DESIGN


def _rule(port_obj, ref_obj, set_aside=BY_DESIGN):
    """None when a positional call binds alike, else a message."""
    try:
        ps, rs = inspect.signature(port_obj), inspect.signature(ref_obj)
    except (TypeError, ValueError):
        return None
    ref = _positional(rs)
    port = _positional(ps)
    if "key" in ref:
        i = ref.index("key")
        if i < len(port) and port[i] in KEY_STANDINS:
            ref = ref[:i] + [port[i]] + ref[i + 1:]
        else:
            ref = ref[:i] + ref[i + 1:]
    ref = [n for n in ref if n not in set_aside]
    if port != ref[:len(port)]:
        return f"port positional {port} is not a prefix of {ref}"
    return None


def _shared():
    """``(qualified name, port object, reference object)`` of every public
    function, class and class method the two packages share by name."""
    pairs = []
    for name in _port_modules():
        ref_name = "repro" + name[len("repro_torch"):]
        try:
            ref_mod = importlib.import_module(ref_name)
        except ImportError:
            continue
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if (attr.startswith("_")
                    or getattr(obj, "__module__", None) != name):
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            ref = getattr(ref_mod, attr, None)
            if ref is None or not callable(ref):
                continue
            pairs.append((f"{name}.{attr}", obj, ref))
            if inspect.isclass(obj) and inspect.isclass(ref):
                for m, fn in vars(obj).items():
                    rfn = getattr(ref, m, None)
                    if (not m.startswith("_") and inspect.isfunction(fn)
                            and callable(rfn)):
                        pairs.append((f"{name}.{attr}.{m}", fn, rfn))
    return pairs


#: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
#: devices) for later JAX processes: the walk leaves the environment as it
#: found it
_ENV = dict(os.environ)
SHARED = _shared()
os.environ.clear()
os.environ.update(_ENV)


def test_the_walk_finds_the_shared_names():
    names = {n for n, _, _ in SHARED}
    for want in ("repro_torch.launch.serve.Engine",
                 "repro_torch.core.lut_layers.pcilt_linear",
                 "repro_torch.configs.base.ModelConfig",
                 "repro_torch.kernels.ops.pcilt_fused_dwconv1d",
                 "repro_torch.nn.layers.dense_spec",
                 "repro_torch.models.transformer.block_apply",
                 "repro_torch.nn.ssm.mamba_block",
                 "repro_torch.optim.adamw.adamw_update",
                 "repro_torch.checkpoint.checkpoint.restore",
                 "repro_torch.launch.steps.make_train_step",
                 "repro_torch.models.mamba.MambaLM.loss"):
        assert want in names, want
    assert len(SHARED) > 150


@pytest.mark.parametrize("name,port,ref", SHARED,
                         ids=[n.removeprefix("repro_torch.")
                              for n, _, _ in SHARED])
def test_positional_parameters_bind_alike(name, port, ref):
    rule = _rule(port, ref, _set_aside(name))
    assert rule is None, f"{name}: {rule}"


def test_the_rule_catches_a_reordering():
    def ref(x, plan=None, path="gather"):
        pass

    def bad(x, path="gather", plan=None):
        pass

    def good(x, plan=None, *, path="gather"):
        pass

    def keyed(key, n, m):
        pass

    def seeded(seed, n, m):
        pass

    def extra(n, m, device=None):
        pass

    def ref_mesh(x, plan=None, path="gather", mesh=None, mesh_axis="model",
                 stacked=None):
        pass

    def no_mesh(x, plan=None, path="gather", stacked=None):
        pass

    assert _rule(bad, ref) is not None
    assert _rule(good, ref) is None
    assert _rule(seeded, keyed) is None
    assert _rule(extra, keyed) is not None
    # a mesh the port has ported binds in its place; a queued one is set
    # aside only for the queued names
    assert _rule(no_mesh, ref_mesh) is not None
    assert _rule(no_mesh, ref_mesh, _set_aside(_STANDIN, (_STANDIN,))) \
        is None
    assert _set_aside(_STANDIN + ".method", (_STANDIN,)) != BY_DESIGN
    assert _set_aside("repro_torch.core.lut_layers.pcilt_linear",
                      (_STANDIN,)) == BY_DESIGN
    assert _set_aside("repro_torch.nn.moe.moe_apply") == BY_DESIGN


def test_engine_positional_max_len():
    """``Engine(cfg, 64)``: a 64-token KV cache in both packages."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.serve import Engine as JEngine
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.launch.serve import Engine as TEngine

    jeng = JEngine(j_smoke("qwen3-0.6b"), 64, 2)
    teng = TEngine(t_smoke("qwen3-0.6b"), 64, 2, device="cpu")
    jk = jeng.cache["layers"]["sub0"]["k"]
    tk = teng.cache["layers"]["sub0"]["k"]
    assert tuple(tk.shape) == tuple(jk.shape)
    assert tk.shape[1] == 2 and tk.shape[2] == 64
    assert teng.slots == jeng.slots == 2


def test_engine_positional_mesh():
    """``Engine(cfg, 64, 2, mesh)``: the fourth positional argument is the
    mesh in both packages; the port's places its KV cache on it (its
    ``kv_heads`` over the two model devices) and serves the unsharded
    engine's tokens."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.serve import Engine as JEngine
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import Engine as TEngine, make_requests
    from repro_torch.nn.module import Placed

    jeng = JEngine(j_smoke("qwen3-0.6b"), 64, 2, None)
    assert jeng.mesh is None
    mesh = make_host_mesh(1, 2, devices=["cpu"] * 2)
    teng = TEngine(t_smoke("qwen3-0.6b"), 64, 2, mesh, device="cpu")
    assert teng.mesh is mesh
    k = teng.cache["layers"]["sub0"]["k"]
    assert isinstance(k, Placed) and tuple(k.shape) == (2, 2, 64, 2, 32)
    assert k.spec == (None, "data", None, "model", None)
    base = TEngine(t_smoke("qwen3-0.6b"), 64, 2, device="cpu")
    cfg = t_smoke("qwen3-0.6b")
    got = make_requests(cfg, 2, 4, 0, None)
    want = make_requests(cfg, 2, 4, 0, None)
    teng.run(got)
    base.run(want)
    assert [r.out for r in got] == [r.out for r in want]


def test_pcilt_linear_positional_plan():
    """The sixth positional argument is the ``plan`` in both packages."""
    from repro.core import QuantSpec as JQ
    from repro.core import SegmentPlan as JPlan
    from repro.core import build_grouped_tables as j_build
    from repro.core import pcilt_linear as j_linear
    from repro_torch.core import QuantSpec as TQ
    from repro_torch.core import SegmentPlan as TPlan
    from repro_torch.core import pcilt_linear as t_linear
    from repro_torch.interop import to_torch

    rng = np.random.default_rng(0)
    idx = np.array([[0, 2], [1, -1], [3, 3]], np.int32)
    w = (0.3 * rng.standard_normal((4, 5))).astype(np.float32)
    x = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    jplan = JPlan(idx)
    tabs = j_build(jnp.asarray(w), JQ(bits=2), 0.3, 2, plan=jplan)
    want = j_linear(jnp.asarray(x), tabs, JQ(bits=2), 0.3, 2, jplan)
    got = t_linear(torch.from_numpy(x), to_torch(np.asarray(tabs)),
                   TQ(bits=2), 0.3, 2, TPlan(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_pcilt_linear_positional_mesh():
    """The eighth and ninth positional arguments are ``mesh`` and
    ``mesh_axis`` in both packages: a mesh named by a positional axis
    shards (a plan then refuses, with the reference's error), an absent
    axis replicates."""
    from repro_torch.core import QuantSpec as TQ
    from repro_torch.core import SegmentPlan as TPlan
    from repro_torch.core import build_grouped_tables as t_build
    from repro_torch.core import pcilt_linear as t_linear
    from repro_torch.launch.mesh import make_decode_mesh

    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.integers(-3, 4, (8, 6)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (3, 8)).astype(np.float32))
    tabs = t_build(w, TQ(bits=2), 1.0, 2)
    mesh = make_decode_mesh(2, devices=["cpu"] * 2)
    want = t_linear(x, tabs, TQ(bits=2), 1.0, 2)
    for axis in ("model", "data"):  # "data" has size 1: replicated
        got = t_linear(x, tabs, TQ(bits=2), 1.0, 2, None, "gather", mesh,
                       axis)
        assert torch.equal(got, want)
    plan = TPlan(np.arange(8, dtype=np.int32).reshape(4, 2))
    with pytest.raises(ValueError, match="cannot be sharded"):
        t_linear(x, tabs, TQ(bits=2), 1.0, 2, plan, "gather", mesh, "model")


def test_model_config_positional_fields():
    """A positional config binds the same fields in both packages."""
    from repro.configs import ModelConfig as JConfig
    from repro_torch.configs import ModelConfig as TConfig

    args = ("m", "dense", 2, 64, 4, 2, 128, 256, 16, True, False, 0, 1e6,
            "rope")
    j, t = JConfig(*args), TConfig(*args)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "qkv_bias",
              "qk_norm", "window", "rope_theta", "pos_embed"):
        assert getattr(t, f) == getattr(j, f), f
    with pytest.raises(TypeError):
        TConfig(*args, None)  # the fields after pos_embed are keyword-only


def test_make_train_step_positional_mesh():
    """``make_train_step(cfg, mesh, ocfg, bf16_grads)``: the second
    positional argument is the mesh in both packages (None: one device,
    the same step's loss and gradient norm); the port's on a (1, 2) CPU
    mesh takes placed parameters and gives the same loss."""
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.steps import make_train_step as j_step
    from repro.models import build_model as j_build
    from repro.optim import AdamWConfig as JAdam
    from repro.optim import adamw_init as j_init
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.interop import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step as t_step
    from repro_torch.nn import module as tmod
    from repro_torch.optim import AdamWConfig as TAdam
    from repro_torch.optim import adamw_init as t_init
    from test_torch_donor import jax_donor

    jcfg = j_smoke("qwen3-0.6b")
    tcfg = t_smoke("qwen3-0.6b")
    specs = j_build(jcfg).param_specs()
    jp = jax_donor(specs, 0)
    nb = SyntheticLM(vocab=jcfg.vocab, seq_len=8, global_batch=2,
                     seed=1).batch(0)
    _, _, jm = jax.jit(j_step(jcfg, None, JAdam(), False))(
        jp, j_init(jp, JAdam()), {k: jnp.asarray(v) for k, v in nb.items()})
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    _, _, tm = t_step(tcfg, None, TAdam(), False)(tp, t_init(tp, TAdam()),
                                                    tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-2)
    mesh = make_host_mesh(1, 2, devices=["cpu"] * 2)
    placed = tmod.place(tp, tmod.shardings(_specs(tcfg), mesh))
    _, new_o, mm = t_step(tcfg, mesh, TAdam(), False)(
        placed, t_init(placed, TAdam()), tb)
    assert isinstance(new_o["m"]["embed"]["embedding"], tmod.Placed)
    np.testing.assert_allclose(float(mm["loss"]), float(tm["loss"]),
                               rtol=1e-2)


def _specs(cfg):
    from repro_torch.models import build_model

    return build_model(cfg).param_specs()


def test_calibrate_pcilt_positional_batch():
    """``MambaLM.calibrate_pcilt(params, batch)``: the second positional
    argument is the calibration batch in both packages (the reference's
    third, ``ctx``, is keyword-only in the port); the same absmaxes."""
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import build_model as j_build
    from repro.nn.layers import Ctx
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.interop import params_from_jax
    from repro_torch.models import build_model as t_build
    from test_torch_donor import jax_donor

    jm = j_build(j_smoke("mamba2-130m"))
    tm = t_build(t_smoke("mamba2-130m"))
    jp = jax_donor(jm.param_specs(), 0)
    tok = np.random.default_rng(4).integers(0, 256, (2, 16))
    want = jax.jit(lambda p, b: jm.calibrate_pcilt(p, b, Ctx()))(
        jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    with torch.no_grad():
        got = tm.calibrate_pcilt(
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            {"tokens": torch.from_numpy(tok)})
    for k in ("in", "out", "conv_in", "head_in"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-2, err_msg=k)


#: the dry run's shared names, each a positional call alike in both
DRYRUN_NAMES = ("repro_torch.launch.specs.input_specs",
                "repro_torch.launch.specs.batch_specs",
                "repro_torch.launch.specs.param_structs",
                "repro_torch.launch.specs.data_spec",
                "repro_torch.launch.mesh.make_production_mesh",
                "repro_torch.launch.dryrun.run_cell",
                "repro_torch.launch.dryrun.cell_path")


@pytest.mark.parametrize("name", DRYRUN_NAMES,
                         ids=[n.removeprefix("repro_torch.")
                              for n in DRYRUN_NAMES])
def test_dryrun_names_are_shared_and_bind_alike(name):
    found = {n: (p, r) for n, p, r in SHARED}
    assert name in found, name
    port, ref = found[name]
    assert _rule(port, ref, _set_aside(name)) is None
    rs, ps = inspect.signature(ref), inspect.signature(port)
    args = {"input_specs": ("a", "s", None, None, None, False),
            "batch_specs": ("cfg", "s", None, None),
            "param_structs": ("cfg", None),
            "data_spec": (None, None),
            "make_production_mesh": (),
            "run_cell": ("a", "s", True, None, "base"),
            "cell_path": ("a", "s", "pod16x16", "base")}[name.split(".")[-1]]
    assert list(rs.bind(*args).arguments) == list(ps.bind(*args).arguments)


def test_input_specs_positional_call():
    """``input_specs(arch, shape, mesh, cfg)``: the same leaves and shapes
    in both packages from one positional call."""
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.specs import input_specs as j_specs
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.launch.specs import input_specs as t_specs

    for shape in ("train_4k", "decode_32k"):
        want = jax.tree_util.tree_flatten_with_path(
            j_specs("qwen3-0.6b", shape, None, j_smoke("qwen3-0.6b")))[0]
        got = t_specs("qwen3-0.6b", shape, None, t_smoke("qwen3-0.6b"))

        def leaves(t, pre=""):
            if isinstance(t, dict):
                return [x for k, v in t.items()
                        for x in leaves(v, f"{pre}/{k}")]
            return [(pre, tuple(t.shape))]

        assert sorted(leaves(got)) == sorted(
            ("/" + "/".join(str(k.key) for k in p), tuple(v.shape))
            for p, v in want)
