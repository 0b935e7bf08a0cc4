"""The port's static contract checker: ``repro_torch.analysis`` (its
``Finding``, baseline and CLI) and the lint (``analysis/lint.py``).

* ``Finding.fingerprint()`` and ``render()`` equal the reference's for the
  same fields; LINT001 finds the same bare assert in a fixture as the
  reference's ``lint_files``.
* A seeded fixture fires each rule (the CUDA rules on ``.cu`` fixtures,
  LINT003's launch rule and LINT004 on Python ones, LINT004 also on a copy
  of ``kernels/ops.py`` with a dimension dropped from a key); the tree is
  clean.
* The CLI's exit codes, the baseline, and ``RULES`` against the catalogue
  in ``docs/static_analysis_torch.md``.
"""

import os
import re

import pytest

from repro.analysis import Finding as JFinding
from repro.analysis import lint as jlint
from repro_torch.analysis import Baseline, Finding, lint, repo_root, run_all
from repro_torch.analysis import schema, smem
from repro_torch.analysis.__main__ import main

ROOT = repo_root()


def _rules(fs):
    return [f.rule for f in fs]


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


# ----------------------------------------------------------------------------
# Finding and the reference's
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("fields", [
    ("LINT001", "error", "src/a.py", 12, "bare assert ('x'); raise", "f"),
    ("SMEM003", "warning", "src/k.cu", 0, "gap; at B 4, G 8", ""),
    ("SCHEMA002", "error", "tiles.json", 0, "bad key: x", "k|B=1")])
def test_finding_fingerprint_and_render_equal_the_reference(fields):
    got, want = Finding(*fields), JFinding(*fields)
    assert got.fingerprint() == want.fingerprint()
    assert got.render() == want.render()
    moved = Finding(*fields[:3], fields[3] + 40, fields[4] + "; drifted",
                    fields[5])
    assert moved.fingerprint() == got.fingerprint()


def test_a_bad_severity_is_refused():
    with pytest.raises(ValueError, match="severity"):
        Finding("LINT001", "fatal", "a.py", 1, "m")


# ----------------------------------------------------------------------------
# LINT001
# ----------------------------------------------------------------------------

BARE = '''
def f(x):
    assert x.shape[0] == 4, "rows"
    return x
'''


def test_lint001_finds_the_reference_lints_bare_assert(tmp_path):
    path = _write(tmp_path, "mod.py", BARE)
    got = lint.lint_files([path], root=str(tmp_path))
    want = jlint.lint_files([path], root=str(tmp_path))
    assert _rules(got) == _rules(want) == ["LINT001"]
    assert [(f.path, f.line, f.message, f.symbol) for f in got] == \
        [(f.path, f.line, f.message, f.symbol) for f in want]


# ----------------------------------------------------------------------------
# LINT002 and LINT003 in device code
# ----------------------------------------------------------------------------

CU_CLEAN = r'''
// a comment with acc += nothing and printf("x")
template <typename T>
__global__ void __launch_bounds__(128, 1) good_kernel(const T* tab, T* out,
                                                      int n) {
  float acc[4];
  for (int k = 0; k < 4; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i & 3] += (float)tab[i];
  static_assert(sizeof(T) <= 4, "a table cell");
  out[threadIdx.x] = (T)acc[0];
}
__host__ __device__ inline int helper(int a) { int s = 0; s += a; return s; }
'''

CU_BAD = r'''
template <typename T>
__global__ void bad_kernel(const T* tab, T* out, int n) {
  T acc = 0;
  __nv_bfloat16 part;
  for (int i = 0; i < n; ++i) { acc += tab[i]; part += tab[i]; }
  printf("%d\n", n);
  assert(n > 0);
  int* p = new int[4];
  out[0] = acc;
}
__device__ void reduce(half& total, const half* v) { total += v[0]; }
'''


def test_clean_device_code_is_clean(tmp_path):
    path = _write(tmp_path, "good.cu", CU_CLEAN)
    assert lint.lint_files([path], root=str(tmp_path)) == []
    names = [d[0] for d in lint.device_functions(lint._blank(CU_CLEAN))]
    assert names == ["good_kernel", "helper"]


def test_lint002_and_lint003_fire_in_device_code(tmp_path):
    path = _write(tmp_path, "bad.cu", CU_BAD)
    fs = lint.lint_files([path], root=str(tmp_path))
    acc = sorted((f.symbol, f.message.split("'")[1]) for f in fs
                 if f.rule == "LINT002")
    assert acc == [("bad_kernel", "acc"), ("bad_kernel", "part"),
                   ("reduce", "total")]
    calls = sorted(f.message.split("'")[1] for f in fs
                   if f.rule == "LINT003")
    assert calls == ["assert", "new", "printf"]
    assert all(f.line > 0 for f in fs)


def test_lint002_fires_on_a_real_source_with_a_table_dtype_accumulator(
        tmp_path):
    src = open(os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                            "pcilt_gemv_stacked.cu")).read()
    decl = "    float acc[kRows][NV];"
    assert src.count(decl) == 1
    path = _write(tmp_path, "pcilt_gemv_stacked.cu",
                  src.replace(decl, "    T acc[kRows][NV];"))
    fs = lint.lint_files([path], root=str(tmp_path))
    assert [(f.rule, f.symbol) for f in fs] == [("LINT002",
                                                "gemv_split_kernel")]


# ----------------------------------------------------------------------------
# LINT003: host syncs ahead of a launch
# ----------------------------------------------------------------------------

LAUNCH = '''
import torch

def _launch(name, fn, x, *args):
    return fn(*args)

def _launch_thing(x, scale):
    s = scale.cpu()
    torch.cuda.synchronize()
    _launch("k", print, x, s)
    return x.item()

def pcilt_wrapper(x, out):
    def plain():
        return x.cpu()
    n = x.tolist()
    _launch("k", print, x, n)
    return out.cpu()
'''


def test_lint003_flags_host_syncs_ahead_of_a_launch(tmp_path):
    path = _write(tmp_path, "ops_like.py", LAUNCH)
    fs = [f for f in lint.lint_files([path], root=str(tmp_path))
          if f.rule == "LINT003"]
    got = sorted((f.symbol, f.message.split("'")[1]) for f in fs)
    assert got == [("_launch_thing", "scale.cpu"),
                   ("_launch_thing", "torch.cuda.synchronize"),
                   ("pcilt_wrapper", "x.tolist")]


# ----------------------------------------------------------------------------
# LINT004: the design-cache keys
# ----------------------------------------------------------------------------

KEYS = '''
def gemv_candidates(B, G, O, itemsize):
    return ["split"]

def _choose(key, dev, dtype, candidates, bench, autotune):
    return candidates()[0]

def _tune_plain(key, dev, dtype, candidates, plain, autotune):
    return None

def complete(x, tables):
    B, n = x.shape
    G, V, O = tables.shape
    es = tables.element_size()
    key = ("k", ("B", "G", "V", "O"), (B, G, V, O))
    return _choose(key, x.device, tables.dtype,
                   lambda: gemv_candidates(B, G, O, es), None, None)

def missing_o(x, tables):
    B, n = x.shape
    G, V, O = tables.shape
    key = ("k", ("B", "G"), (x.shape[0], G))
    return _choose(key, x.device, tables.dtype,
                   lambda: gemv_candidates(B, G, O, tables.element_size()),
                   None, None)

def _launch(x, tables, G, O, key=None):
    B, n = x.shape
    return _choose(key, x.device, tables.dtype,
                   lambda: gemv_candidates(B, G, O, 4), None, None)

def caller_ok(x, tables):
    G, V, O = tables.shape
    key = ("k", ("B", "G", "O"), (x.shape[0], G, O))
    return _launch(x, tables, G, O, key=key)

def caller_short(x, tables):
    G, V, O = tables.shape
    return _launch(x, tables, G, O, key=("k", ("G", "O"), (G, O)))

def bad_kwarg(x, tables):
    G, V, O = tables.shape
    key = ("k", ("G",), (G,))
    return _tune_plain(key, x.device, tables.dtype,
                       lambda: gemv_candidates(1, G, O, 4, rows=2), None,
                       None)
'''


def test_lint004_follows_keys_and_fires_on_missing_roots(tmp_path):
    path = _write(tmp_path, "keys.py", KEYS)
    fs = [f for f in lint.lint_files([path], root=str(tmp_path))
          if f.rule == "LINT004"]
    got = sorted((f.symbol, f.message.split(";")[0]) for f in fs)
    assert ("missing_o", "candidate generator gemv_candidates consumes "
            "parameter 'O' (arg 'O') whose shape roots never reach the "
            "design-cache key") in got
    assert ("_launch", "candidate generator gemv_candidates consumes "
            "parameter 'B' (arg 'B') whose shape roots never reach the "
            "design-cache key") in got  # via caller_short's key
    assert ("bad_kwarg", "gemv_candidates has no parameter 'rows' "
            "(signature introspection)") in got
    assert not [s for s, _ in got if s in ("complete", "caller_ok")]
    assert {s for s, _ in got} == {"missing_o", "_launch", "bad_kwarg"}
    assert any("caller_short" in f.message for f in fs)


def test_lint004_fires_on_the_real_ops_with_a_dimension_dropped(tmp_path):
    src = open(os.path.join(ROOT, "src", "repro_torch", "kernels",
                            "ops.py")).read()
    key = "(B, G, V, O, X, group, spec.bits))"
    assert src.count(key) == 1
    path = _write(tmp_path, "ops.py", src.replace(
        key, "(B, G, V, X, group, spec.bits))"))
    fs = [f for f in lint.lint_files([path], root=str(tmp_path))
          if f.rule == "LINT004"]
    assert {f.symbol for f in fs} == {"_shared_gemv"} and len(fs) == 2
    assert all("parameter 'O'" in f.message for f in fs)


# ----------------------------------------------------------------------------
# the tree, the catalogue, the CLI and the baseline
# ----------------------------------------------------------------------------


def test_repo_lint_is_clean():
    fs = lint.lint_tree(os.path.join(ROOT, "src", "repro_torch"), root=ROOT)
    assert fs == [], "\n".join(f.render() for f in fs)


def test_every_rule_has_a_catalogue_entry():
    with open(os.path.join(ROOT, "docs", "static_analysis_torch.md")) as f:
        doc = f.read()
    listed = set(re.findall(r"^\| `([A-Z]+\d{3})` \|", doc, re.M))
    rules = set(lint.RULES) | set(smem.RULES) | set(schema.RULES)
    assert listed == rules
    assert set(lint.RULES) == {"LINT001", "LINT002", "LINT003", "LINT004"}
    assert set(smem.RULES) == {f"SMEM00{i}" for i in range(1, 7)}
    assert set(schema.RULES) == {"SCHEMA001", "SCHEMA002"}


def _seed_repo(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(BARE)
    return str(tmp_path)


def test_cli_gates_then_baseline_accepts(tmp_path, capsys):
    root = _seed_repo(tmp_path)
    assert main(["--root", root, "--passes", "lint"]) == 1
    assert "LINT001 error" in capsys.readouterr().out
    assert main(["--root", root, "--passes", "lint",
                 "--write-baseline"]) == 0
    assert os.path.exists(os.path.join(root, ".analysis-baseline-torch.json"))
    assert main(["--root", root, "--passes", "lint"]) == 0
    assert "(baselined)" in capsys.readouterr().out
    (tmp_path / "src" / "repro_torch" / "two.py").write_text(BARE)
    assert main(["--root", root, "--passes", "lint"]) == 1  # a new finding


def test_cli_exit_codes_on_a_clean_tree_and_usage_errors(tmp_path, capsys):
    assert main(["--passes", "lint,schema"]) == 0
    assert main(["--passes", "lint,nope"]) == 2
    stale = tmp_path / "b.json"
    stale.write_text('{"version": 0, "accepted": []}')
    assert main(["--passes", "schema", "--baseline", str(stale)]) == 2
    assert "regenerate it" in capsys.readouterr().err


def test_baseline_round_trip(tmp_path):
    f = Finding("LINT001", "error", "a.py", 3, "bare assert ('x'); more", "g")
    b = Baseline.write(str(tmp_path / "b.json"), [f])
    assert Baseline.load(b.path).accepts(Finding(
        "LINT001", "error", "a.py", 30, "bare assert ('x'); other", "g"))


def test_run_all_rejects_an_unknown_pass():
    with pytest.raises(ValueError, match="unknown analysis passes"):
        run_all(passes=("lint", "vmem"))
