"""The port's public signatures against the reference's.

For every public function and class that a module of ``repro_torch`` shares
(by name) with its counterpart in ``repro``, and every public method of such
a class, a positional call must bind the same parameters in both packages.
The rule, after setting aside the reference parameters the port leaves out
by design (``ctx``, ``axes``, and ``key`` where the port takes a ``seed`` or
``generator`` in its place), and ``mesh``/``mesh_axis`` of the names whose
mesh is still queued (:data:`MESH_QUEUED`: the dense ``Engine`` and steps,
the expert-parallel MoE):

* the port's positional parameters are a prefix of the reference's, in the
  reference's order;
* every port parameter after the first reference parameter the port lacks
  is keyword-only (which the prefix rule implies: a positional one there
  would break the prefix).

Then one positional call each of ``Engine``, ``pcilt_linear`` and
``ModelConfig`` in both packages, showing the same meaning (and
``pcilt_linear``'s positional ``mesh``).
"""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch

#: reference parameters the port leaves out by design
BY_DESIGN = {"ctx", "axes"}
#: the shared names whose ``mesh``/``mesh_axis`` wait for the port's
#: ``Ctx``/``row_parallel`` (the dense engine and steps) or for expert
#: parallelism (``moe_apply``)
MESH_QUEUED = ("repro_torch.launch.serve.Engine",
               "repro_torch.launch.steps.make_decode_step",
               "repro_torch.launch.steps.make_prefill_step",
               "repro_torch.launch.steps.make_train_step",
               "repro_torch.nn.moe.moe_apply")
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


def _set_aside(name):
    """The reference parameters set aside for the shared name ``name``."""
    if any(name == q or name.startswith(q + ".") for q in MESH_QUEUED):
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


SHARED = _shared()


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
    assert _rule(no_mesh, ref_mesh, _set_aside(MESH_QUEUED[0])) is None
    assert _set_aside("repro_torch.core.lut_layers.pcilt_linear") == BY_DESIGN


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
