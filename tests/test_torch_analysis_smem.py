"""The Hopper resource verifier (``repro_torch.analysis.smem``), on the CPU.

* The tree is clean over the quick and the full sweep, every family
  checks launches, and the wrappers refuse no shape of the full sweep.
* Each rule fires on a seeded fault: a shrunk budget (SMEM001), a split
  with a cluster of 32 and a kernel past its launch bounds (SMEM002), a
  gapped tile function (SMEM003), an injected library whose plan or
  constants differ and an injected report that lacks a kernel, gives other
  static shared memory or too many registers, and launch bounds that
  drifted (SMEM004), a report whose registers break the heuristic's
  occupancy (SMEM005), a report with spills (SMEM006).
* Honest injected libraries and reports (built from the models) give no
  finding: SMEM004 compares, it does not just fire.
* No kernel runs: the launch path, the library loader and the design
  cache's timer are poisoned, and the launch and timing counts stay 0.
"""

import ctypes

import pytest

from repro_torch.analysis import run_all, smem
from repro_torch.analysis.__main__ import main
from repro_torch.kernels import autotune as atn
from repro_torch.kernels import build, ops
from repro_torch.kernels.ref import CRC_CHUNK_BYTES, CRC_LANE_BYTES, CRC_LEVELS


def _rules(fs):
    return sorted({f.rule for f in fs})


class ModelLibrary:
    """A kernel library that answers every ``*_config`` and ``*_plan``
    query from ``kernels.ops``' models, as the built libraries must
    (``perturb`` maps an entry point to a function editing its answer)."""

    def __init__(self, perturb=None):
        self.perturb = perturb or {}

    def _out(self, name, vals, out):
        vals = list(vals)
        if name in self.perturb:
            vals = self.perturb[name](vals)
        out[:] = vals
        return 0

    def pcilt_gemv_split_config(self, cfg):
        return self._out("pcilt_gemv_split_config", (
            ops.GEMV_ROWS, ops.GEMV_WARPS, ops.GEMV_SEG_BATCH,
            ops.GEMV_TARGET_BLOCKS, ops.GEMV_MAX_CLUSTER, ops.GEMV_MIN_SEGS,
            ops.GEMV_MAX_LANES, ops.GEMV_LANE_BYTES), cfg)

    def pcilt_gemv_split_plan(self, B, G, O, es, out):
        sp = ops.gemv_variant(B, G, O, es)
        return self._out("pcilt_gemv_split_plan",
                         (*sp, ops.gemv_smem_bytes(sp, G),
                          ops.gemv_slab(sp, G), ops.gemv_planes(sp)), out)

    def pcilt_gemv_staged_config(self, cfg):
        return self._out("pcilt_gemv_staged_config",
                         ops.STAGED_GEMV_CONFIG, cfg)

    def pcilt_gemv_staged_plan(self, B, G, V, O, es, out):
        p = ops.gemv_staged_plan(B, G, V, O, es)
        return self._out("pcilt_gemv_staged_plan",
                         (int(p.wide), p.rpt, p.rows, p.cols, p.rtiles,
                          p.ctiles, p.cluster, ops.gemv_staged_slab(p, G, V),
                          ops.gemv_staged_smem_bytes(p, G, V),
                          ops.gemv_staged_planes(p)), out)

    def pcilt_shared_gemv_split_config(self, cfg):
        return self._out("pcilt_shared_gemv_split_config", (
            ops.SHARED_ROWS, ops.SHARED_WARPS, ops.SHARED_LANE_BYTES,
            ops.SHARED_LOADS, ops.SHARED_TARGET_BLOCKS,
            ops.SHARED_MAX_CLUSTER, ops.SHARED_MIN_SEGS,
            ops.SHARED_BLOCKS_PER_SM, ops.SM_SMEM_BYTES,
            ops.BLOCK_RESERVED_SMEM), cfg)

    def pcilt_shared_gemv_split_plan(self, B, G, O, es, out):
        sp = ops.shared_gemv_variant(B, G, O, es)
        return self._out("pcilt_shared_gemv_split_plan",
                         (*sp, ops.shared_gemv_smem_bytes(sp, G),
                          ops.shared_gemv_slab(sp, G)), out)

    def pcilt_dwconv1d_tiled_config(self, cfg):
        return self._out("pcilt_dwconv1d_tiled_config", (
            ops.DW_TILED_THREADS, ops.DW_WIDE_LANES,
            ops.DW_TILED_TARGET_BLOCKS, ops.DW_TILED_MAX_TAPS,
            ops.DW_CLUSTER_BLOCKS), cfg)

    def pcilt_dwconv1d_tiled_plan(self, rows, C, wide, out):
        return self._out("pcilt_dwconv1d_tiled_plan",
                         ops.dwconv_tiled_grid(rows, C, bool(wide)), out)

    def pcilt_dwconv1d_staged_config(self, cfg):
        return self._out("pcilt_dwconv1d_staged_config", (
            ops.DW_CHANS, ops.DW_THREADS, ops.DW_UNROLL,
            ops.DW_TARGET_BLOCKS), cfg)

    def pcilt_dwconv1d_staged_plan(self, M, C, V, es, out):
        return self._out("pcilt_dwconv1d_staged_plan",
                         ops.dwconv_host_tiling(M, C, V, es), out)

    def pcilt_conv2d_staged_config(self, cfg):
        return self._out("pcilt_conv2d_staged_config", (
            ops.STAGED_PIX_TILE, ops.STAGED_COL_TILE, ops.STAGED_STAGES,
            ops.STAGED_OFF_RING, ops.STAGED_ROW_PITCH, ops.STAGED_MAX_V),
            cfg)

    def pcilt_gemv_host_staged_config(self, cfg):
        return self._out("pcilt_gemv_host_staged_config", (
            ops.HOST_ROW_TILE, ops.HOST_COL_TILE, ops.HOST_STAGES,
            ops.HOST_CHUNK, ops.HOST_OFF_RING, ops.HOST_MAX_V), cfg)

    def pcilt_crc32_config(self, cfg):
        return self._out("pcilt_crc32_config", (
            CRC_LANE_BYTES, CRC_CHUNK_BYTES, CRC_LEVELS, ops.CRC_COMBINE),
            cfg)


def _libraries(**perturb):
    lib = ModelLibrary(perturb)
    return dict.fromkeys(build.SOURCES, lib)


def _report(library, registers=32, spills=0, static=None, drop=()):
    """``ptxas -v`` text for a library: two template instances of each of
    its kernels, mangled as nvcc mangles a name in an anonymous
    namespace."""
    lines = ["ptxas info    : 0 bytes gmem"]
    for k, (_, lib, _, _, _) in smem.KERNELS.items():
        if lib != library or k in drop:
            continue
        smem_b = smem.STATIC_SMEM[k] if static is None else static
        for inst in ("IfLi16EE", "I13__nv_bfloat16Li8EE"):
            name = f"_ZN12_GLOBAL__N_1{len(k)}{k}{inst}vPKfPT_"
            lines += [
                f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    0 bytes stack frame, {spills} bytes spill stores, "
                f"{spills} bytes spill loads",
                f"ptxas info    : Used {registers} registers, used 1 "
                f"barriers, {smem_b} bytes smem, 400 bytes cmem[0]"]
    return "\n".join(lines)


def _reports(**kw):
    return {lib: _report(lib, **kw) for lib in build.SOURCES}


# ----------------------------------------------------------------------------
# the tree is clean
# ----------------------------------------------------------------------------


def test_the_tree_is_clean_over_the_quick_sweep():
    summary = {}
    fs = smem.verify_all("quick", summary=summary)
    assert fs == [], "\n".join(f.render() for f in fs)
    for fam in smem.FAMILIES():
        assert summary[fam.name]["launches"] > 0, fam.name


def test_the_tree_is_clean_over_the_full_sweep():
    summary = {}
    fs = smem.verify_all("full", summary=summary)
    assert fs == [], "\n".join(f.render() for f in fs)
    assert summary["gemv"]["shapes"] > 1000
    # every group-1 width is served (the split's cluster grows until a
    # block's offsets fit), and so is every shape past the split GEMVs'
    # old ceilings (the row walk, the slabs), so the wrapper refuses no
    # shape: not the gemv's, not the shared head's
    assert {fam: v["refused"] for fam, v in summary.items()
            if fam not in ("report", "kernels")} == dict.fromkeys(
        (f.name for f in smem.FAMILIES()), 0)
    assert summary["gemv"]["refused"] == summary["shared_gemv"]["refused"] \
        == 0
    assert run_all(passes=("smem",), sweep="quick") == []


@pytest.mark.parametrize("family,shapes,variant,slab", [
    ("gemv", smem.CEILING_GEMV, "gemv_variant", "gemv_slab"),
    ("shared_gemv", smem.CEILING_SHARED, "shared_gemv_variant",
     "shared_gemv_slab")])
def test_the_ceiling_shapes_are_checked_in_the_full_sweep(family, shapes,
                                                          variant, slab):
    """The full sweep holds the shapes past the split GEMVs' old ceilings
    (more than 65535 row chunks; a 16-block cluster's offsets in slabs),
    each admitted in its split design and checked clean, against an honest
    library's plans too."""
    fam = next(f for f in smem.FAMILIES() if f.name == family)
    full = {(s["B"], s["G"], s["O"], s["itemsize"]) for s in fam.sweep("full")}
    quick = {(s["B"], s["G"], s["O"], s["itemsize"])
             for s in fam.sweep("quick")}
    assert set(shapes) <= full and not set(shapes) & quick
    walks = slabs = 0
    for B, G, O, es in shapes:
        s = {"B": B, "G": G, "O": O, "itemsize": es}
        assert fam.designs(s)[0] == "split" and not fam.refused(s, "split")
        sp = getattr(ops, variant)(B, G, O, es)
        walks += sp.chunks > smem.MAX_GRID_YZ
        slabs += getattr(ops, slab)(sp, G) < -(-G // sp.cluster)
        (L,) = fam.launches(s, "split")
        assert L.grid[1] <= smem.MAX_GRID_YZ and L.grid[2] <= smem.MAX_GRID_YZ
        assert fam.cover(s, "split") == []
        assert fam.plan(ModelLibrary(), s) == []
    assert walks >= 2 and slabs >= 2


@pytest.mark.parametrize("sweep", ["quick", "full"])
def test_kernel_6_split_is_checked_over_the_sweep(sweep):
    """Kernel 6's split launches (the one-pass kernel, and in the full
    sweep the slab kernel and the grid's second plane) are modelled at
    every shape of the sweep, the heuristic's design at up to 64 rows, and
    check clean against honest libraries (kernel 9's split plans) and
    reports."""
    fam = next(f for f in smem.FAMILIES() if f.name == "gemv_host")
    shapes = list(fam.sweep(sweep))
    small = [s for s in shapes if s["M"] <= 64]
    assert small and all(fam.designs(s)[0] == "split" for s in small)
    assert all("split" in fam.designs(s) for s in shapes)
    summary = {}
    fs = smem.verify_all(sweep, families=["gemv_host"],
                         libraries=_libraries(), reports=_reports(),
                         summary=summary)
    assert fs == [], "\n".join(f.render() for f in fs)
    want = {"gemv_host_split_kernel"}
    if sweep == "full":
        want.add("gemv_host_split_slabs_kernel")
        planes = [ops.gemv_grid(ops.gemv_variant(M, G, O, es))[2]
                  for M, G, V, O, es in smem.CEILING_HOST]
        assert max(planes) == 2
    assert want <= set(summary["kernels"])
    assert summary["gemv_host"]["refused"] == 0
    rep = summary["report"]["gemv_host"]["gemv_host_split_kernel"]
    assert rep["instances"] == 2 and rep["spill_stores"] == 0


def test_kernel_6_split_past_its_budget_fires_smem001():
    """Under a budget shrunk below the split's shared memory, kernel 6's
    split kernel fires SMEM001, as kernel 9's does."""
    fs = smem.verify_all("quick", smem_budget=1024,
                         families=["gemv_host", "gemv"])
    hit = {f.message.split(" for ")[1].split(",")[0] for f in fs
           if f.rule == "SMEM001"}
    assert {"gemv_host_split_kernel", "gemv_split_kernel"} <= hit


def test_kernel_6_split_drift_fires_smem004(monkeypatch):
    """Kernel 6's library queried for the split's constants and plans:
    one that splits otherwise, or launch bounds that drifted, fire
    SMEM004."""
    def more_warps(vals):
        vals[2] += 1
        return vals

    fs = smem.verify_all("quick", families=["gemv_host"],
                         libraries=_libraries(
                             pcilt_gemv_split_plan=more_warps))
    assert _rules(fs) == ["SMEM004"] and "the split of B" in fs[0].message
    fs = smem.verify_all("quick", families=["gemv_host"],
                         libraries=_libraries(
                             pcilt_gemv_split_config=lambda v: v[:7] + [8]))
    assert _rules(fs) == ["SMEM004"] and "split constants" in fs[0].message
    monkeypatch.setitem(smem.KERNELS, "gemv_host_split_kernel",
                        ("pcilt_gemv.cu", "gemv_host", "32 * kWarps, 1", 128,
                         1))
    fs = smem.verify_all("quick", families=["gemv_host"])
    assert [f.symbol for f in fs if f.rule == "SMEM004"] == \
        ["gemv_host_split_kernel"]


def test_a_slab_that_skips_a_segment_fires_smem003(monkeypatch):
    real = ops.gemv_slab
    monkeypatch.setattr(ops, "gemv_slab", lambda sp, G: max(1, real(sp, G))
                        if G < 200000 else 0)
    fs = smem.verify_all("full", families=["gemv"])
    assert any(f.rule == "SMEM003" and "a slab of 0" in f.message
               for f in fs)


def test_honest_libraries_and_reports_give_no_finding():
    summary = {}
    fs = smem.verify_all("quick", libraries=_libraries(),
                         reports=_reports(), summary=summary)
    assert fs == [], "\n".join(f.render() for f in fs)
    rep = summary["report"]["gemv_stacked"]["gemv_split_kernel"]
    assert rep == {"registers": 32, "static_smem": 0, "spill_stores": 0,
                   "spill_loads": 0, "instances": 2}


def test_every_kernel_of_the_sources_is_modelled():
    import glob
    import os

    from repro_torch.analysis.lint import _blank, device_functions

    names = set()
    for path in glob.glob(os.path.join(smem._CSRC, "*.cu")):
        text = _blank(open(path).read())
        names |= {n for n, s, b, _ in device_functions(text)
                  if "__global__" in text[s:b]}
    assert names == set(smem.KERNELS)


# ----------------------------------------------------------------------------
# each rule fires
# ----------------------------------------------------------------------------


def test_a_shrunk_budget_fires_smem001():
    fs = smem.verify_all("quick", smem_budget=1024)
    assert "SMEM001" in _rules(fs)
    fams = {f.symbol for f in fs if f.rule == "SMEM001"}
    assert {"gemv", "shared_gemv", "conv", "gemv_host",
            "dwconv_host"} <= fams
    assert main(["--passes", "smem", "--smem-budget", "1024"]) == 1


def test_launch_limits_fire_smem002(monkeypatch):
    real = ops.gemv_variant

    def wide(B, G, O, es):
        return real(B, G, O, es)._replace(cluster=32)

    monkeypatch.setattr(ops, "gemv_variant", wide)
    fs = smem.verify_all("quick", families=["gemv"])
    msgs = [f.message for f in fs if f.rule == "SMEM002"]
    assert any("a cluster of 32 blocks, at most 16" in m for m in msgs)
    monkeypatch.setattr(ops, "gemv_variant", real)
    monkeypatch.setitem(smem.KERNELS, "dwconv1d_tiled_kernel",
                        ("pcilt_dwconv1d.cu", "dwconv1d", "kDwTiledThreads",
                         64, 1))
    fs = smem.verify_all("quick", families=["dwconv"])
    assert any("(__launch_bounds__)" in f.message for f in fs
               if f.rule == "SMEM002")


@pytest.mark.parametrize("family,name,gap", [
    ("conv", "staged_block_tile", 1000), ("gemv_host",
                                          "gemv_host_block_tile", 1000)])
def test_a_gapped_tile_function_fires_smem003(monkeypatch, family, name,
                                              gap):
    real = getattr(ops, name)

    def gapped(i, P, O):
        (p0, p1), cols = real(i, P, O)
        return (p0, min(p1, p0 + gap)), cols

    monkeypatch.setattr(ops, name, gapped)
    fs = smem.verify_all("quick", families=[family])
    assert _rules(fs) == ["SMEM003"]
    assert any("is covered by no part" in f.message for f in fs)


def test_overlapping_slices_fire_smem003(monkeypatch):
    monkeypatch.setattr(ops, "shared_gemv_slices", lambda sp, G: [
        (0, G // 2 + 1), (G // 2, G)] if sp.cluster == 2 else
        [(q * G // sp.cluster, (q + 1) * G // sp.cluster)
         for q in range(sp.cluster)])
    monkeypatch.setattr(ops, "shared_gemv_variant", lambda B, G, O, es: ops
                        .SharedSplit(4 if B >= 3 else B, 8, 2, 1024,
                                     -(-O // 1024), -(-B // 4)))
    fs = smem.verify_all("quick", families=["shared_gemv"])
    assert any("is covered twice" in f.message for f in fs
               if f.rule == "SMEM003")


def test_a_library_whose_plan_differs_fires_smem004():
    def more_warps(vals):
        vals[2] += 1
        return vals

    fs = smem.verify_all("quick", families=["gemv"],
                         libraries=_libraries(
                             pcilt_gemv_split_plan=more_warps))
    assert _rules(fs) == ["SMEM004"]
    assert "the split of B" in fs[0].message
    fs = smem.verify_all("quick", families=["crc"], libraries=_libraries(
        pcilt_crc32_config=lambda v: v[:3] + [512]))
    assert _rules(fs) == ["SMEM004"] and "CRC constants" in fs[0].message


def test_a_report_that_disagrees_fires_smem004():
    reps = {"dwconv1d": _report("dwconv1d", drop=("dwconv1d_staged_kernel",))}
    fs = smem.verify_all("quick", families=["dwconv_host"], reports=reps)
    assert any("has no kernel 'dwconv1d_staged_kernel'" in f.message
               for f in fs if f.rule == "SMEM004")
    reps = {"crc32": _report("crc32", static=8)}
    fs = smem.verify_all("quick", families=["crc"], reports=reps)
    assert any("bytes of static shared memory, the model" in f.message
               for f in fs if f.rule == "SMEM004")
    reps = {"conv2d": _report("conv2d", registers=200)}
    fs = smem.verify_all("quick", families=["conv"], reports=reps)
    assert any("registers times" in f.message for f in fs
               if f.rule == "SMEM004")


def test_launch_bounds_drift_fires_smem004(monkeypatch):
    monkeypatch.setitem(smem.KERNELS, "gemv_split_kernel",
                        ("pcilt_gemv_stacked.cu", "gemv_stacked",
                         "32 * kWarps, 2", 128, 2))
    fs = smem.verify_all("quick", families=["gemv"])
    assert [f.symbol for f in fs if f.rule == "SMEM004"] == \
        ["gemv_split_kernel"]


def test_registers_past_the_occupancy_fire_smem005():
    # shared_split_kernel asks for 2 blocks of 256 threads: 128 registers
    reps = {"shared_gemv": _report("shared_gemv", registers=129)}
    fs = smem.verify_all("quick", families=["shared_gemv"], reports=reps)
    assert "SMEM005" in _rules(fs)
    assert all(f.symbol == "shared_split_kernel" for f in fs
               if f.rule == "SMEM005")


def test_a_report_with_spills_fires_smem006():
    fs = smem.verify_all("quick", families=["gemv"],
                         reports={"gemv_stacked": _report("gemv_stacked",
                                                          spills=24)})
    assert _rules(fs) == ["SMEM006"]
    assert all(f.severity == "warning" for f in fs)
    assert main(["--passes", "smem"]) == 0


def test_parse_report_takes_the_most_of_the_instances():
    text = _report("crc32") + "\n" + _report("crc32", registers=40,
                                             spills=8)
    rep = smem.parse_report(text)
    assert set(rep) == {"crc_chunks_kernel", "crc_banked_kernel",
                        "crc_combine_kernel"}
    assert rep["crc_chunks_kernel"]["registers"] == 40
    assert rep["crc_chunks_kernel"]["spill_loads"] == 8
    assert rep["crc_chunks_kernel"]["instances"] == 4
    assert rep["crc_chunks_kernel"]["static_smem"] == \
        smem.STATIC_SMEM["crc_chunks_kernel"]


def test_an_unknown_sweep_or_family_is_refused():
    with pytest.raises(ValueError, match="unknown sweep"):
        smem.verify_all("huge")
    with pytest.raises(ValueError, match="unknown families"):
        smem.verify_all("quick", families=["vmem"])


# ----------------------------------------------------------------------------
# no kernel runs
# ----------------------------------------------------------------------------


def test_no_kernel_execution_happens(monkeypatch):
    def boom(*a, **k):  # pragma: no cover - failing path
        raise AssertionError("the verifier ran a kernel")

    for mod, name in ((ops, "_launch"), (ops, "_call"), (build, "library"),
                      (build, "build_all"), (atn, "tune_design"),
                      (atn, "cuda_timer")):
        monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(ctypes, "CDLL", boom)
    runs = atn.TIMING_RUNS
    launches = dict(ops.LAUNCHES)
    fs = smem.verify_all("quick", libraries=_libraries(), reports=_reports())
    assert fs == []
    assert atn.TIMING_RUNS == runs and ops.LAUNCHES == launches
