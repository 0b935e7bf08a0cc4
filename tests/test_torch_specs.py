"""Port parity: the dry run's inputs (``repro_torch.launch.specs``) and
production meshes (``launch.mesh.make_production_mesh``) against the
reference's.

For every config of ``ARCHS`` and shape of ``SHAPES``, without a mesh and
on both production meshes (plus the ZeRO-1 overrides of a train shape and
the kvshard overrides of a decode shape on ``pod16x16``), every leaf of the
port's ``input_specs`` equals the reference's: its path, shape, dtype,
partition spec and the block a coordinate holds (against
``sharding.shard_shape``).  The reference side runs once, in a subprocess
with 512 forced host devices (``--xla_force_host_platform_device_count``),
and writes JSON; it also gives ``dryrun._skip_reason`` of every cell.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.dryrun import _skip_reason
from repro_torch.launch.specs import input_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (mesh name, variant name) -> the overrides of input_specs
ZERO1 = {"rule_overrides": {"embed": None, "opt_embed": ("data", "pod")},
         "zero1": True}
KVSHARD = {"rule_overrides": {"cache_seq": "model", "heads": None}}
CASES = [(a, s, m, "base") for a in ARCHS for s in SHAPES
         for m in ("none", "pod16x16", "pod2x16x16")] \
    + [(a, "train_4k", "pod16x16", "zero1") for a in ARCHS] \
    + [(a, "decode_32k", "pod16x16", "kvshard") for a in ARCHS]

_REF = r'''
import json, sys
import jax
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import input_specs
from repro.launch.dryrun import _skip_reason

cases = json.loads(sys.argv[1])
meshes = {"none": None, "pod16x16": make_production_mesh(),
          "pod2x16x16": make_production_mesh(multi_pod=True)}
variants = json.loads(sys.argv[2])

def entry(e):
    if e is None:
        return None
    return list(e) if isinstance(e, tuple) else e

out = {"leaves": {}, "skip": {}}
for arch, shape, mname, var in cases:
    v = variants[var]
    ro = v.get("rule_overrides")
    if ro:
        ro = {k: tuple(x) if isinstance(x, list) else x
              for k, x in ro.items()}
    tree = input_specs(arch, shape, meshes[mname], rule_overrides=ro,
                       zero1=v.get("zero1", False))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    rows = []
    for path, s in flat:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        sh = s.sharding
        spec = None if sh is None else [entry(e) for e in sh.spec]
        block = list(s.shape) if sh is None else list(
            sh.shard_shape(s.shape))
        rows.append([name, list(s.shape), str(s.dtype), spec, block])
    out["leaves"]["|".join((arch, shape, mname, var))] = rows
for arch in ARCHS:
    for shape in SHAPES:
        out["skip"][arch + "|" + shape] = _skip_reason(get_config(arch),
                                                       shape)
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    variants = {"base": {}, "zero1": ZERO1, "kvshard": KVSHARD}
    r = subprocess.run([sys.executable, "-c", _REF, json.dumps(CASES),
                        json.dumps(variants)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def meshes():
    meta = [torch.device("meta")]
    return {"none": None,
            "pod16x16": tmesh.make_production_mesh(devices=meta * 256),
            "pod2x16x16": tmesh.make_production_mesh(multi_pod=True,
                                                     devices=meta * 512)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flat(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _port_rows(arch, shape, mesh, var):
    v = {"base": {}, "zero1": ZERO1, "kvshard": KVSHARD}[var]
    tree = input_specs(arch, shape, mesh,
                       rule_overrides=v.get("rule_overrides"),
                       zero1=v.get("zero1", False))
    rows = []
    for name, t in _flat(tree):
        p = t.sharding
        assert t.device.type == "meta", name
        if p is None:
            spec, block = None, list(t.shape)
        else:
            spec = [_entry(e) for e in p.spec]
            block = [b - a for a, b in p.block_ranges(
                t.shape, p.block_index(mesh.coords[-1]))]
        rows.append([name, list(t.shape), str(t.dtype).removeprefix(
            "torch."), spec, block])
    return sorted(rows)


@pytest.mark.parametrize("arch,shape,mname,var", CASES,
                         ids=["-".join(c) for c in CASES])
def test_input_specs_match_the_reference(ref, meshes, arch, shape, mname,
                                         var):
    want = sorted(ref["leaves"]["|".join((arch, shape, mname, var))])
    got = _port_rows(arch, shape, meshes[mname], var)
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        if w[3] is not None:  # PartitionSpec drops no dim: pad to rank
            w[3] = w[3] + [None] * (len(w[1]) - len(w[3]))
        assert g == w, (g, w)


def test_skip_reasons_match(ref):
    for arch in ARCHS:
        from repro_torch.configs import get_config

        for shape in SHAPES:
            assert _skip_reason(get_config(arch), shape) == \
                ref["skip"][arch + "|" + shape], (arch, shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(multi_pod):
    n = 512 if multi_pod else 256
    m = tmesh.make_production_mesh(multi_pod=multi_pod,
                                   devices=[torch.device("meta")] * n)
    want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    assert (m.devices.shape, m.axis_names) == want
    assert m.shape == dict(zip(want[1], want[0]))
    assert len(m.coords) == n


def test_production_mesh_wants_its_cards():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 256:
        pytest.skip("this host has the cards")
    with pytest.raises(RuntimeError, match="256 CUDA cards"):
        tmesh.make_production_mesh()
