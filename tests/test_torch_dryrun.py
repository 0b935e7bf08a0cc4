"""Port parity: the dry run (``repro_torch.launch.dryrun``), its per-
coordinate operation analysis (``launch.op_analysis``) and the move record
(``nn.coords``).

* **Flops against the reference.**  The port's unsharded step on meta
  tensors counts exactly the dot flops the reference's ``analyze_hlo``
  finds in ``jax.jit(make_*_step(cfg, None)).lower(specs).compile()``, for
  the smoke configs of four families, prefill and decode; a train step
  within 1%.
* **Meta against a real run.**  A step on a meta (2, 2) mesh and the same
  step on a (2, 2) mesh of ``"cpu"`` devices with seeded weights count the
  same per coordinate: flops, moves by kind, argument bytes and peak live
  bytes (dense decode, MoE prefill with its all-to-all, a train step with
  ``explicit_rs``: reduce-scatter and the replica all-reduce).  The replica
  all-reduce is recorded on a meta mesh as on four distinct devices.
* **Moves against a hand count.**  ``row_parallel`` on (1, 4) sends three
  partials of ``[B, S, d]`` float32; ``compressed_pmean`` records the
  bytes of its ``stats["sent_bytes"]``.
* **One whole cell.**  ``run_cell`` on a smoke config gives every key, and
  ``main`` writes it.
"""

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import SHAPES, ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.op_analysis import HostReadError, analysis
from repro_torch.models import build_model
from repro_torch.nn import coords
from repro_torch.nn.layers import row_parallel
from repro_torch.nn.module import (Placed, TablePlacement, materialize,
                                   place, shape_structs, shardings)
from repro_torch.optim import AdamWConfig, adamw_init_specs

B, S, T = 2, 64, 64

# ---------------------------------------------------------------------------
# flops against the reference's analyze_hlo
# ---------------------------------------------------------------------------


def _ref_flops(arch, kind):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jcfg
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    make_train_step)
    from repro.models import build_model as jbuild
    from repro.nn.module import shape_structs as jstructs
    from repro.optim import AdamWConfig as JA, adamw_init_specs as jopt

    c = jcfg(arch)
    m = jbuild(c)
    p = jstructs(m.param_specs(), None)

    def batch(labels):
        n = S - (c.n_img_tokens or 0)
        b = {"tokens": jax.ShapeDtypeStruct((B, n), jnp.int32)}
        if labels:
            b["labels"] = b["tokens"]
            b["loss_mask"] = jax.ShapeDtypeStruct((B, n), jnp.float32)
        if c.encoder_layers:
            b["memory"] = jax.ShapeDtypeStruct((B, c.encoder_len, c.d_model),
                                               jnp.float32)
        return b

    if kind == "prefill":
        low = jax.jit(make_prefill_step(c, None)).lower(p, batch(False))
    elif kind == "decode":
        low = jax.jit(make_decode_step(c, None)).lower(
            p, jstructs(m.cache_specs(B, T), None),
            jax.ShapeDtypeStruct((B, 1), jnp.int32))
    else:
        oc = JA()
        low = jax.jit(make_train_step(c, None, oc)).lower(
            p, jstructs(jopt(m.param_specs(), oc), None), batch(True))
    return int(analyze_hlo(low.compile().as_text())["flops"])


def _port_flops(arch, kind):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    args = {"params": shape_structs(model.param_specs(), None)}

    def batch(labels):
        n = S - (cfg.n_img_tokens or 0)
        b = {"tokens": torch.empty((B, n), dtype=torch.int32, device="meta")}
        if labels:
            b["labels"] = b["tokens"]
            b["loss_mask"] = torch.empty((B, n), device="meta")
        if cfg.encoder_layers:
            b["memory"] = torch.empty((B, cfg.encoder_len, cfg.d_model),
                                      device="meta")
        return b

    if kind == "prefill":
        args["batch"] = batch(False)
    elif kind == "decode":
        args["cache"] = shape_structs(model.cache_specs(B, T), None)
        args["cache"]["pos"] = T - 1
        args["tokens"] = torch.empty((B, 1), dtype=torch.int32,
                                     device="meta")
    else:
        args["opt_state"] = shape_structs(
            adamw_init_specs(model.param_specs(), AdamWConfig()), None)
        args["batch"] = batch(True)
    r = dryrun.measure_step(dryrun.make_step(cfg, kind, None), kind, args,
                            None)
    assert r["crossed"] == 0 and list(r["per_coord"]) == ["-"]
    return r["cost"]["flops_per_device"]


FLOP_CASES = [(a, k) for a in ("qwen3-0.6b", "mamba2-130m",
                               "granite-moe-3b-a800m", "whisper-medium")
              for k in ("prefill", "decode")]


@pytest.mark.parametrize("arch,kind", FLOP_CASES,
                         ids=[f"{a}-{k}" for a, k in FLOP_CASES])
def test_unsharded_flops_equal_analyze_hlo(arch, kind):
    # every contraction is the reference's: no difference to name
    assert _port_flops(arch, kind) == _ref_flops(arch, kind)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_train_flops_within_one_percent(arch):
    want = _ref_flops(arch, "train")
    got = _port_flops(arch, "train")
    assert abs(got - want) <= 0.01 * want, (got, want)


# ---------------------------------------------------------------------------
# a meta mesh against a mesh of real devices
# ---------------------------------------------------------------------------


def _mesh_args(cfg, kind, mesh, dev):
    model = build_model(cfg)
    rules = tspecs.data_spec(mesh)
    ps = model.param_specs()

    def tree(specs, seed):
        if dev == "meta":
            return tspecs.step_args(shape_structs(specs, mesh, rules))
        return place(materialize(specs, seed, device="cpu"),
                     shardings(specs, mesh, rules))

    args = {"params": tree(ps, 0)}
    gen = torch.Generator().manual_seed(5)
    tok = torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                        dtype=torch.int32)
    if kind == "decode":
        args["cache"] = tree(model.cache_specs(4, 32), 1)
        args["cache"]["pos"] = 31
        args["tokens"] = tok[:, :1].to(dev)
    else:
        args["batch"] = {"tokens": tok.to(dev)}
    if kind == "train":
        args["batch"].update(labels=tok.to(dev),
                             loss_mask=torch.ones((4, 32), device=dev))
        osp = adamw_init_specs(ps, AdamWConfig())
        args["opt_state"] = {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree(osp["m"], 2), "v": tree(osp["v"], 3)}
    return args


MESH_CASES = [("qwen3-0.6b", "decode", "base"),
              ("granite-moe-3b-a800m", "prefill", "base"),
              ("qwen3-0.6b", "train", "rowrs")]


@pytest.mark.parametrize("arch,kind,variant", MESH_CASES,
                         ids=[f"{a}-{k}-{v}" for a, k, v in MESH_CASES])
def test_meta_mesh_counts_what_a_real_mesh_does(arch, kind, variant):
    cfg = get_smoke_config(arch)
    got = {}
    for dev in ("meta", "cpu"):
        mesh = make_host_mesh(2, 2, devices=[dev] * 4)
        r = dryrun.measure_step(dryrun.make_step(cfg, kind, mesh, variant),
                                kind, _mesh_args(cfg, kind, mesh, dev), mesh)
        assert r["crossed"] == 0, dev
        got[dev] = r["per_coord"]
    assert sorted(got["meta"]) == ["0,0", "0,1", "1,0", "1,1"]
    for c, m in got["meta"].items():
        k = got["cpu"][c]
        for key in ("flops", "argument_bytes", "temp_bytes",
                    "collective_bytes", "bytes_traffic_est", "coll"):
            assert m[key] == k[key], (c, key, m[key], k[key])
    kinds = {kd for v in got["meta"].values() for kd, x in v["coll"].items()
             if x["bytes"]}
    want = {"decode": {"all-gather", "all-reduce"},
            "prefill": {"all-to-all", "all-gather", "all-reduce"},
            "train": {"reduce-scatter", "all-reduce", "all-gather"}}[kind]
    assert want <= kinds, kinds


def _replicated_grad(mesh, distinct):
    """A float32 [8, 6] leaf replicated over a (2, 2) mesh: one tensor
    (``distinct=False``, a mesh of one device) or four (one a device)."""
    placement = TablePlacement(mesh, (None, None))
    if distinct:
        return Placed.place(torch.zeros((8, 6), device=mesh.devices[0, 0]),
                            placement)
    return Placed.build(placement, (8, 6), torch.float32,
                        lambda i, dev: torch.empty((8, 6), device=dev))


def test_replica_allreduce_recorded_on_meta_as_on_distinct_devices():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.steps import _allreduce_replicas

    meta = make_host_mesh(2, 2, devices=["meta"] * 4)
    g = _replicated_grad(meta, False)
    assert len(g.unique()) == 1
    with coords.recording_moves() as on_meta:
        _allreduce_replicas(g)
    with FakeTensorMode(allow_non_fake_inputs=True):
        cards = make_host_mesh(2, 2, devices=[f"cuda:{i}" for i in range(4)])
        gd = _replicated_grad(cards, True)
        assert len(gd.unique()) == 4
        with coords.recording_moves() as on_cards:
            _allreduce_replicas(gd)

    def key(log):
        return sorted((e["kind"], e["src"], e["dst"], e["bytes"])
                      for e in log)

    assert key(on_meta) == key(on_cards)
    assert len(on_meta) == 6 and {e["bytes"] for e in on_meta} == {8 * 6 * 4}


# ---------------------------------------------------------------------------
# hand counts
# ---------------------------------------------------------------------------


def test_row_parallel_sends_three_partials():
    from repro_torch.launch.steps import make_ctx

    mesh = make_host_mesh(1, 4, devices=["cpu"] * 4)
    ctx = make_ctx(mesh, explicit_rs=True)
    b, s, f, d = 2, 8, 16, 12
    gen = torch.Generator().manual_seed(3)
    x = Placed.place(torch.randn((b, s, f), generator=gen,
                                 dtype=torch.bfloat16),
                     TablePlacement(mesh, (None, None, "model")))
    w = Placed.place(torch.randn((f, d), generator=gen),
                     TablePlacement(mesh, ("model", None)))
    with coords.recording_moves() as log:
        y = row_parallel(x, w, "bsf,fd->bsd", ctx=ctx)
    assert y.shape == (b, s, d)
    into = [e for e in log if e["dst"] == (0, 0)]
    out = [e for e in log if e["src"] == (0, 0)]
    assert {e["kind"] for e in log} == {"reduce-scatter"}
    assert sorted(e["src"] for e in into) == [(0, 1), (0, 2), (0, 3)]
    assert sum(e["bytes"] for e in into) == 3 * b * s * d * 4
    assert sum(e["bytes"] for e in out) == 3 * b * (s // 4) * d * 2
    assert len(log) == 6


@pytest.mark.parametrize("scheme", ["int8", "bf16", "none"])
def test_compress_record_equals_sent_bytes(scheme):
    from repro_torch.optim import compress

    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    x = Placed.place(torch.randn((4, 1000),
                                 generator=torch.Generator().manual_seed(1)),
                     TablePlacement(mesh, ("data", None)))
    stats = {}
    with coords.recording_moves() as log:
        compress.compressed_pmean(x, "data", scheme, stats=stats)
    assert sum(e["bytes"] for e in log) == stats["sent_bytes"]
    assert {e["kind"] for e in log} == {"reduce-scatter", "all-gather"}


# ---------------------------------------------------------------------------
# the analysis, the depth probes and one whole cell
# ---------------------------------------------------------------------------


def test_a_host_read_of_a_meta_value_is_refused():
    x = torch.empty((4,), device="meta")
    with pytest.raises(HostReadError, match="_local_scalar_dense"):
        with analysis():
            int(x.sum())


def test_views_and_moves_keep_their_coordinates():
    mesh = make_host_mesh(1, 2, devices=["meta"] * 2)
    x = torch.empty((4, 8), device="meta")
    with analysis(mesh, (x,)) as a:
        with coords.at([(0, 1)]):
            y = x[:, :4].to("meta")  # a move of a view: (0, 0) -> (0, 1)
            z = y @ torch.empty((4, 3), device="meta")
    assert coords.coords_of(z) == frozenset({(0, 1)})
    rep = a.report()
    assert rep["per_coord"]["0,1"]["flops"] == 2 * 4 * 4 * 3
    assert rep["per_coord"]["0,0"]["coll"]["broadcast"] == \
        {"count": 1, "bytes": 4 * 4 * 4}
    assert rep["crossed"] == 0


@pytest.fixture
def small_shapes(monkeypatch):
    for name, sh in SHAPES.items():
        monkeypatch.setitem(SHAPES, name, ShapeConfig(
            name, 64 if sh.kind != "decode" else 32,
            4 if sh.global_batch > 1 else 1, sh.kind))


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_depth_probes_carry_to_the_full_depth(small_shapes, kind):
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), n_layers=4)
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    shape = "prefill_32k" if kind == "prefill" else "train_4k"
    full = dryrun.measure_cell(cfg, shape, mesh)
    probed = dryrun.measure_cell(cfg, shape, mesh, depths=(1, 2))
    exact = probed["depth"]["exact"]
    assert "flops" in exact and ("bytes_traffic_est" in exact) == \
        (kind != "train")
    for c, f in full["per_coord"].items():
        p = probed["per_coord"][c]
        for key in ("flops", "collective_bytes", "coll", "argument_bytes",
                    "output_bytes") + (("bytes_traffic_est",)
                                       if kind != "train" else ()):
            assert p[key] == f[key], (c, key)
    with pytest.raises(ValueError, match="do not step"):
        dryrun.measure_cell(cfg, shape, mesh, depths=(2, 5))


CELL_KEYS = ("status", "n_chips", "memory", "cost", "collectives",
             "collective_bytes_per_device", "top_collectives", "top_buffers",
             "model_flops_global", "n_active_params", "trace_s")


def test_run_cell_writes_every_key(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    cell = dryrun.run_cell("qwen3-0.6b", "decode_32k", False,
                           cfg=get_smoke_config("qwen3-0.6b"))
    assert cell["status"] == "ok", cell.get("traceback")
    path = dryrun.cell_path("qwen3-0.6b", "decode_32k", "pod16x16")
    with open(path, "w") as f:
        json.dump(cell, f)
    with open(path) as f:
        back = json.load(f)
    for key in CELL_KEYS:
        assert key in back, key
    assert back["n_chips"] == 256 and back["crossed"] == 0
    assert set(back["memory"]) == {"argument_bytes", "output_bytes",
                                   "temp_bytes", "alias_bytes",
                                   "total_nonalias_bytes"}
    assert set(back["cost"]) == {"flops_per_device",
                                 "bytes_traffic_est_per_device"}
    assert set(back["collectives"]) == set(coords.KINDS)
    m = back["memory"]
    assert m["total_nonalias_bytes"] >= m["argument_bytes"] > 0
    assert back["cost"]["flops_per_device"] > 0
    # every coordinate holds its cache block: 128 rows over 16 data rows
    assert back["spread"]["argument_bytes"][0] > 0
    assert "cost_raw" not in back and "lower_s" not in back


def test_main_writes_a_skipped_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    rc = dryrun.main(argv=["--arch", "qwen3-0.6b", "--shape", "long_500k",
                           "--force"])
    assert rc == 0
    with open(tmp_path / "qwen3-0_6b__long_500k__pod16x16.json") as f:
        cell = json.load(f)
    assert cell["status"] == "skipped"
    assert "0 ok, 1 skipped, 0 errors" in capsys.readouterr().out
