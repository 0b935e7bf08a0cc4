"""Lint of the port: its Python library and its CUDA sources (port of
``repro.analysis.lint``, re-targeted).

Four rules, each a convention the kernels depend on that only tests at
particular shapes exercised before:

* **LINT001 bare-assert** — no bare ``assert`` in ``src/repro_torch``: a
  typed ``ValueError`` names the offending shapes, and an ``assert``
  vanishes under ``python -O``.
* **LINT002 f32-accumulation** — in every ``__global__`` or ``__device__``
  body of ``kernels/csrc/*.cu`` and ``*.cuh``, an accumulator (a variable
  named ``acc*``, or any ``+=`` target) is declared ``float``, never ``T``,
  ``__nv_bfloat16`` or ``half``: the fetched cells are summed in float32
  and cast to the table dtype only at the store.  There is no C++ parser
  here, so the rule is lexical: comments and literals are blanked, device
  bodies found by brace matching, declarations by their type name.
* **LINT003 host-call** — no ``printf``, ``malloc``, ``free``, ``new`` or
  ``assert`` (``static_assert`` is allowed) in device code; and in
  ``kernels/ops.py``'s launch functions (each ``_launch*`` function and
  each function that calls ``_launch`` or ``_call``), no host sync on a
  tensor (``.item()``, ``.tolist()``, ``.cpu()``,
  ``torch.cuda.synchronize``) ahead of the launch: it would stall the host
  before the kernel is queued.  The rule reads the launch functions' own
  bodies (their nested plain-version closures, which run on the CPU,
  left out); a read of the result after the launch is the caller's.
* **LINT004 key-completeness** — at every ``_choose(key, ...)`` and
  ``_tune_plain(key, ...)`` site, every argument of the ``*_candidates``
  lambda roots, through local assignments and ``x.shape`` unpacking, to a
  value of the design-cache key: else two shapes that differ only in it
  share a cache entry and one runs the other's design.  The key is
  followed to where it is built: a tuple ``(kernel, names, values)``, a
  helper that returns one (``_gemv_key``, ``_conv_key``), or a parameter,
  then at every call site in the module; a key assigned in several
  branches roots to the union of their values, as any name assigned more
  than once does.  A generator's parameters are
  bound by ``inspect.signature`` on ``kernels.ops`` (else its definition in
  the module); ``itemsize`` and ``es`` (``x.element_size()``) are exempt,
  because the key's dtype keys them.
"""

from __future__ import annotations

import ast
import bisect
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import Finding, rel

__all__ = ["RULES", "lint_tree", "lint_files", "device_functions"]

RULES: Dict[str, str] = {
    "LINT001": "bare assert in library code (raise a typed ValueError "
               "naming the offending shapes)",
    "LINT002": "accumulator in CUDA device code not declared float (an "
               "acc* variable or a += target declared T, __nv_bfloat16 or "
               "half; lexical)",
    "LINT003": "host call in CUDA device code (printf, malloc, free, new, "
               "assert), or a host sync (.item(), .tolist(), .cpu(), "
               "torch.cuda.synchronize) ahead of the launch in a "
               "kernels.ops launch function",
    "LINT004": "design-cache key misses a shape symbol the *_candidates "
               "generator consumes",
}

#: the low-precision types an accumulator must not have (the table dtypes)
_LOW_TYPES = ("T", "__nv_bfloat16", "nv_bfloat16", "__half", "half",
              "__nv_bfloat162", "__half2", "half2")
#: calls that do not belong in device code
_DEVICE_HOST_CALLS = re.compile(
    r"\b(printf|malloc|free)\s*\(|\bnew\b|\bassert\s*\(")
#: method calls that read a tensor back to the host
_SYNC_METHODS = {"item", "tolist", "cpu"}
#: the functions whose call is a kernel launch in kernels.ops
_LAUNCH_CALLS = {"_launch", "_call"}
#: the functions that take a design-cache key and a candidates lambda
_CHOOSERS = {"_choose": 3, "_tune_plain": 3}
#: candidate-generator parameters the key's dtype covers
_KEY_EXEMPT_PARAMS = {"itemsize"}
_KEY_EXEMPT_NAMES = {"es"}


def _dot(node: ast.AST) -> str:
    """A Name/Attribute chain as ``a.b.c`` ('' when not a pure chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _Module:
    """One parsed Python source with its top-level functions."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.functions: Dict[str, ast.FunctionDef] = {
            n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


# ----------------------------------------------------------------------------
# LINT001 — bare assert
# ----------------------------------------------------------------------------


def _check_bare_assert(mod: _Module, root: str) -> List[Finding]:
    out = []
    enclosing: Dict[int, str] = {}
    for fn in ast.walk(mod.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(fn):
                enclosing.setdefault(id(sub), fn.name)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assert):
            cond = ast.unparse(node.test)
            out.append(Finding(
                "LINT001", "error", rel(mod.path, root), node.lineno,
                f"bare assert ({cond!r}) in library code; raise a typed "
                f"ValueError naming the offending shapes instead",
                symbol=enclosing.get(id(node), "<module>")))
    return out


# ----------------------------------------------------------------------------
# LINT003 (Python) — host syncs ahead of a launch
# ----------------------------------------------------------------------------


def _own_nodes(fdef: ast.AST):
    """The nodes of a function's body, its nested functions and lambdas
    left out."""
    stack = list(ast.iter_child_nodes(fdef))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _callee(node: ast.Call) -> str:
    return node.func.id if isinstance(node.func, ast.Name) else ""


def _check_launch_syncs(mod: _Module, root: str) -> List[Finding]:
    out = []
    for name, fdef in mod.functions.items():
        calls = [n for n in _own_nodes(fdef) if isinstance(n, ast.Call)]
        launches = [n for n in calls if _callee(n) in _LAUNCH_CALLS
                    or (_callee(n).startswith("_launch")
                        and _callee(n) in mod.functions)]
        if not (name.startswith("_launch") or launches):
            continue
        last = max(((n.end_lineno, n.end_col_offset) for n in launches),
                   default=None)
        for n in calls:
            sync = (isinstance(n.func, ast.Attribute)
                    and n.func.attr in _SYNC_METHODS
                    and not n.args) or _dot(n.func) == \
                "torch.cuda.synchronize"
            if not sync or (last is not None
                            and (n.lineno, n.col_offset) > last):
                continue
            what = _dot(n.func) or f".{n.func.attr}()"
            out.append(Finding(
                "LINT003", "error", rel(mod.path, root), n.lineno,
                f"host sync {what!r} ahead of the kernel launch; read "
                f"device values before the launch path or keep them on the "
                f"device", symbol=name))
    return out


# ----------------------------------------------------------------------------
# LINT004 — the design-cache key at every _choose / _tune_plain site
# ----------------------------------------------------------------------------


def _shape_attr(node: ast.AST) -> Optional[str]:
    """``x`` of an ``x.shape`` expression (None otherwise)."""
    if isinstance(node, ast.Attribute) and node.attr == "shape":
        return _dot(node.value) or None
    return None


def _const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)):
        return -node.operand.value
    return None


class _Scope:
    """One function body's shape atoms: ``('dim', base, i)`` for
    ``x.shape[i]`` (unpacked, indexed or sliced) and ``('name', n)`` for a
    parameter or other opaque name.  Every assignment of a name counts: a
    name assigned more than once roots to the union of its definitions
    (the branches of an ``if``)."""

    def __init__(self, fdef: ast.FunctionDef):
        args = fdef.args
        self.params = [a.arg for a in (args.posonlyargs + args.args)]
        self.kwonly = [a.arg for a in args.kwonlyargs]
        self.defs: Dict[str, List[ast.AST]] = {}
        self.dims: Dict[str, Tuple[str, str, int]] = {}
        self.shape_dims: Dict[str, Set[str]] = {}
        for node in ast.walk(fdef):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt, val = node.targets[0], node.value
            if isinstance(tgt, ast.Name):
                self._record(tgt.id, val)
            elif isinstance(tgt, ast.Tuple) and all(
                    isinstance(e, ast.Name) for e in tgt.elts):
                names = [e.id for e in tgt.elts]
                base = _shape_attr(val)
                start = 0
                if base is None and isinstance(val, ast.Subscript) \
                        and isinstance(val.slice, ast.Slice):
                    base = _shape_attr(val.value)
                    lo = val.slice.lower
                    start = 0 if lo is None else (_const_int(lo) or 0)
                if base is not None:
                    for i, n in enumerate(names):
                        self._dim(n, base, start + i)
                elif isinstance(val, ast.Tuple) and len(val.elts) == len(
                        names):
                    for n, v in zip(names, val.elts):
                        self._record(n, v)
                else:  # from a call: every target roots to its arguments
                    for n in names:
                        self.defs.setdefault(n, []).append(val)

    def _dim(self, name, base, i):
        self.dims[name] = ("dim", base, i)
        self.shape_dims.setdefault(base, set()).add(name)

    def _record(self, name: str, val: ast.AST) -> None:
        if isinstance(val, ast.Subscript):
            base = _shape_attr(val.value)
            i = _const_int(val.slice)
            if base is not None and i is not None:
                self._dim(name, base, i)
                return
        self.defs.setdefault(name, []).append(val)

    def roots(self, expr: ast.AST, seen: Optional[Set[str]] = None
              ) -> Set[tuple]:
        """The atoms of an expression."""
        seen = set() if seen is None else seen
        if isinstance(expr, ast.Subscript):
            base = _shape_attr(expr.value)
            if base is not None:
                i = _const_int(expr.slice)
                if i is not None:
                    return {("dim", base, i)}
                if isinstance(expr.slice, ast.Slice):
                    lo = expr.slice.lower
                    hi = expr.slice.upper
                    a = 0 if lo is None else _const_int(lo)
                    b = None if hi is None else _const_int(hi)
                    if a is not None and b is not None:
                        return {("dim", base, i) for i in range(a, b)}
                    return {("name", base)}
        if isinstance(expr, ast.Name):
            return self.roots_of_name(expr.id, seen)
        out: Set[tuple] = set()
        for child in ast.iter_child_nodes(expr):
            out |= self.roots(child, seen)
        return out

    def roots_of_name(self, name: str, seen: Set[str]) -> Set[tuple]:
        if name in self.dims:
            return {self.dims[name]}
        if name in seen or name not in self.defs:
            return {("name", name)}
        seen = seen | {name}
        out: Set[tuple] = set()
        for val in self.defs[name]:
            out |= self.roots(val, seen)
        return out


def _bind(params: List[str], call: ast.Call,
          kwonly: Iterable[str] = ()) -> Dict[str, ast.AST]:
    """A call's argument expressions by parameter name."""
    out = {}
    for p, a in zip(params, call.args):
        if not isinstance(a, ast.Starred):
            out[p] = a
    for kw in call.keywords:
        if kw.arg:
            out[kw.arg] = kw.value
    return out


def _translate(atoms: Set[tuple], binding: Dict[str, ast.AST],
               caller: "_Scope") -> Set[tuple]:
    """Atoms of a callee's scope as the caller's: a parameter's atoms are
    its argument's, ``p.shape[i]`` of a parameter bound to a name ``x`` is
    ``x.shape[i]``."""
    out: Set[tuple] = set()
    for a in atoms:
        if a[0] == "name" and a[1] in binding:
            out |= caller.roots(binding[a[1]])
        elif a[0] == "dim" and a[1] in binding:
            arg = binding[a[1]]
            if isinstance(arg, ast.Name):
                out.add(("dim", arg.id, a[2]))
            else:
                out |= caller.roots(arg)
        else:
            out.add(a)
    return out


class _KeyResolver:
    """The value atoms of a design-cache key expression, in the scope of
    the function that builds it, followed into key helpers and up to the
    call sites of a function that takes the key as a parameter."""

    def __init__(self, mod: _Module):
        self.mod = mod
        self.scopes: Dict[str, _Scope] = {}

    def scope(self, fname: str) -> _Scope:
        if fname not in self.scopes:
            self.scopes[fname] = _Scope(self.mod.functions[fname])
        return self.scopes[fname]

    def values(self, fname: str, expr: ast.AST, depth: int = 0
               ) -> List[Tuple[str, Set[tuple], Dict, str]]:
        """``[(scope function, key atoms, binding to the original scope,
        where)]``: one entry a resolution (a key parameter gives one a call
        site; ``binding`` maps the original function's parameters to
        argument expressions of the scope function's)."""
        sc = self.scope(fname)
        if depth > 6:
            return []
        if isinstance(expr, ast.Tuple) and len(expr.elts) == 3:
            return [(fname, sc.roots(expr.elts[2]), {}, fname)]
        if isinstance(expr, ast.Call) and _callee(expr) in self.mod.functions:
            return self._helper(fname, expr)
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in sc.defs:  # every assignment's values, merged
                atoms: Set[tuple] = set()
                for val in sc.defs[name]:
                    for _, a, _, _ in self.values(fname, val, depth + 1):
                        atoms |= a
                return [(fname, atoms, {}, fname)]
            if name in sc.params or name in sc.kwonly:
                return self._up(fname, name, depth)
        return []

    def _helper(self, fname: str, call: ast.Call):
        """A key built by a module helper: its returned tuple's values,
        the helper's atoms translated to the caller's.  ``_gemv_key(kname,
        with_stats, names, *values)``: the values are its arguments from
        the fourth on."""
        sc = self.scope(fname)
        hname = _callee(call)
        helper = self.mod.functions[hname]
        if helper.args.vararg is not None:
            n = len(helper.args.args)
            atoms: Set[tuple] = set()
            for a in call.args[n:]:
                atoms |= sc.roots(a.value if isinstance(a, ast.Starred)
                                  else a)
            return [(fname, atoms, {}, fname)]
        hs = self.scope(hname)
        rets = [n.value for n in ast.walk(helper)
                if isinstance(n, ast.Return) and n.value is not None]
        binding = _bind(hs.params, call)
        out = []
        for r in rets:
            for _, atoms, _, _ in self.values(hname, r):
                out.append((fname, _translate(atoms, binding, sc), {},
                            fname))
        return out

    def _up(self, fname: str, param: str, depth: int):
        """A key that is ``fname``'s parameter: resolved at each call of
        ``fname`` in the module that passes it."""
        out = []
        callee_scope = self.scope(fname)
        for cname, cdef in self.mod.functions.items():
            for call in ast.walk(cdef):
                if not (isinstance(call, ast.Call)
                        and _callee(call) == fname):
                    continue
                binding = _bind(callee_scope.params, call)
                arg = binding.get(param)
                if arg is None or (isinstance(arg, ast.Constant)
                                   and arg.value is None):
                    continue
                for sname, atoms, _, _ in self.values(cname, arg,
                                                      depth + 1):
                    out.append((sname, atoms, binding,
                                f"{cname}:{call.lineno}"))
        return out


def _generator_params(mod: _Module, name: str) -> List[str]:
    """A ``*_candidates`` generator's parameter names: by
    ``inspect.signature`` on ``kernels.ops``, else from its definition in
    the module (empty when neither has it)."""
    import inspect

    from repro_torch.kernels import ops as _ops
    fn = getattr(_ops, name, None)
    if callable(fn):
        return list(inspect.signature(fn).parameters)
    if name in mod.functions:
        a = mod.functions[name].args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return []


def _exempt(pname: str, arg: ast.AST) -> bool:
    if pname in _KEY_EXEMPT_PARAMS:
        return True
    if isinstance(arg, ast.Name) and arg.id in _KEY_EXEMPT_NAMES:
        return True
    return (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute)
            and arg.func.attr == "element_size") or (
        isinstance(arg, ast.Attribute) and arg.attr == "itemsize")


def _covered(atom: tuple, key: Set[tuple], scope: _Scope) -> bool:
    if atom in key:
        return True
    if atom[0] == "name":  # a whole array whose every unpacked dim is keyed
        dims = scope.shape_dims.get(atom[1])
        if dims:
            return all(scope.dims[d] in key for d in dims)
    return False


def _check_keys(mod: _Module, root: str) -> List[Finding]:
    out = []
    resolver = _KeyResolver(mod)
    for fname, fdef in mod.functions.items():
        sc = resolver.scope(fname)
        for call in ast.walk(fdef):
            if not (isinstance(call, ast.Call)
                    and _callee(call) in _CHOOSERS):
                continue
            i = _CHOOSERS[_callee(call)]
            binding = _bind(["key", "dev", "dtype", "candidates"], call)
            lam = binding.get("candidates")
            if len(call.args) > i:
                lam = call.args[i]
            if not (isinstance(lam, ast.Lambda)
                    and isinstance(lam.body, ast.Call)
                    and _dot(lam.body.func).endswith("_candidates")):
                continue
            gen = lam.body
            gname = _dot(gen.func).rsplit(".", 1)[-1]
            params = _generator_params(mod, gname)
            bound: List[Tuple[str, ast.AST]] = []
            for k, a in enumerate(gen.args):
                bound.append((params[k] if k < len(params) else f"arg{k}", a))
            for kw in gen.keywords:
                if kw.arg and params and kw.arg not in params:
                    out.append(Finding(
                        "LINT004", "error", rel(mod.path, root), gen.lineno,
                        f"{gname} has no parameter {kw.arg!r} (signature "
                        f"introspection)", symbol=fname))
                elif kw.arg:
                    bound.append((kw.arg, kw.value))
            resolved = resolver.values(fname, call.args[0]) \
                if call.args else []
            if not resolved:
                out.append(Finding(
                    "LINT004", "error", rel(mod.path, root), call.lineno,
                    f"the design-cache key of this {_callee(call)} site "
                    f"cannot be followed to its values; build it as "
                    f"(kernel, names, values)", symbol=fname))
                continue
            for sname, key, up, where in resolved:
                scope = resolver.scope(sname)
                for pname, arg in bound:
                    if _exempt(pname, arg):
                        continue
                    atoms = sc.roots(arg)
                    if up:
                        atoms = _translate(atoms, up, scope)
                    missing = sorted(str(a) for a in atoms
                                     if not _covered(a, key, scope))
                    if missing:
                        out.append(Finding(
                            "LINT004", "error", rel(mod.path, root),
                            gen.lineno,
                            f"candidate generator {gname} consumes "
                            f"parameter {pname!r} (arg {ast.unparse(arg)!r})"
                            f" whose shape roots never reach the design-"
                            f"cache key; two shapes differing only in it "
                            f"would share an entry; missing roots: "
                            f"{missing}; key built at {where}",
                            symbol=fname))
    return out


# ----------------------------------------------------------------------------
# The CUDA sources (lexical)
# ----------------------------------------------------------------------------


def _blank(src: str) -> str:
    """Comments and string/char literals replaced by spaces (newlines
    kept, so offsets and line numbers hold)."""
    out = list(src)
    i, n = 0, len(src)

    def wipe(a, b):
        for k in range(a, b):
            if out[k] != "\n":
                out[k] = " "

    while i < n:
        c = src[i]
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            wipe(i, j)
            i = j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
            wipe(i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            wipe(i + 1, min(j, n))
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _match(text: str, i: int, open_: str, close: str) -> int:
    """The index just past the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


_QUALIFIED = re.compile(r"\b(__global__|__device__)\b")
_IDENT_PAREN = re.compile(r"([A-Za-z_]\w*)\s*\(")
_SKIP_CALLS = {"__launch_bounds__", "__align__", "__cluster_dims__",
               "alignas", "decltype"}


def device_functions(text: str) -> List[Tuple[str, int, int, int]]:
    """``[(name, signature start, body start, body end)]`` of every
    function definition marked ``__global__`` or ``__device__`` in a
    blanked source (a declaration without a body is skipped)."""
    out = []
    pos = 0
    while True:
        m = _QUALIFIED.search(text, pos)
        if m is None:
            return out
        pos = m.end()
        name = None
        j = m.end()
        while True:
            f = _IDENT_PAREN.search(text, j)
            if f is None:
                break
            stop = text.find(";", j)
            if 0 <= stop < f.start():  # a declaration of a variable
                break
            p = f.end() - 1
            end = _match(text, p, "(", ")")
            if f.group(1) in _SKIP_CALLS:
                j = end
                continue
            name, j = f.group(1), end
            break
        if name is None:
            continue
        k = j
        while k < len(text) and text[k] not in "{;":
            k += 1
        if k >= len(text) or text[k] == ";":
            continue
        end = _match(text, k, "{", "}")
        out.append((name, m.start(), k, end))
        pos = end


_DECL = re.compile(
    r"\b(" + "|".join(re.escape(t) for t in ("float", "double")
                      + _LOW_TYPES) + r")\b\s*(?:\(\s*&|&)?\s*([A-Za-z_]\w*)")
_PLUS_EQ = re.compile(r"([A-Za-z_]\w*)\s*(?:\[[^\]\n]*\]\s*)*\+=")
_ACC = re.compile(r"\b(acc\w*)\b")


def _lint_cuda(path: str, root: str) -> List[Finding]:
    with open(path) as f:
        text = _blank(f.read())
    lines = [0]
    for i, c in enumerate(text):
        if c == "\n":
            lines.append(i + 1)

    def line_of(i):
        return bisect.bisect_right(lines, i)

    out = []
    where = rel(path, root)
    for name, sig, b0, b1 in device_functions(text):
        region = text[sig:b1]
        types: Dict[str, str] = {}
        for d in _DECL.finditer(region):
            types.setdefault(d.group(2), d.group(1))
        body = text[b0:b1]
        accs = {m.group(1): b0 + m.start() for m in _ACC.finditer(body)}
        for m in _PLUS_EQ.finditer(body):
            accs.setdefault(m.group(1), b0 + m.start())
        for var, at in sorted(accs.items(), key=lambda kv: kv[1]):
            t = types.get(var)
            if t in _LOW_TYPES:
                out.append(Finding(
                    "LINT002", "error", where, line_of(at),
                    f"accumulator {var!r} is declared {t}, not float; sum "
                    f"the cells in float32 and cast to the table dtype at "
                    f"the store", symbol=name))
        for m in _DEVICE_HOST_CALLS.finditer(body):
            call = m.group(1) or m.group(0).split("(")[0].strip()
            out.append(Finding(
                "LINT003", "error", where, line_of(b0 + m.start()),
                f"host call {call!r} in device code; device code keeps no "
                f"host side effects (a static_assert or a returned error "
                f"code instead)", symbol=name))
    return out


# ----------------------------------------------------------------------------
# Driver
# ----------------------------------------------------------------------------


def lint_files(paths: Iterable[str], root: Optional[str] = None
               ) -> List[Finding]:
    """Lint an explicit set of files (``.py``, and ``.cu``/``.cuh`` for the
    device rules); returns every finding."""
    out: List[Finding] = []
    for path in paths:
        if path.endswith((".cu", ".cuh")):
            out.extend(_lint_cuda(path, root))
            continue
        with open(path) as f:
            mod = _Module(path, ast.parse(f.read(), filename=path))
        out.extend(_check_bare_assert(mod, root))
        out.extend(_check_launch_syncs(mod, root))
        out.extend(_check_keys(mod, root))
    return out


def lint_tree(src_root: str, root: Optional[str] = None) -> List[Finding]:
    """Lint every ``.py`` file under ``src_root`` (the library: tests and
    scripts keep other conventions) and every CUDA source under it."""
    paths = []
    for dirpath, _dirnames, filenames in os.walk(src_root):
        for fn in sorted(filenames):
            if fn.endswith((".py", ".cu", ".cuh")):
                paths.append(os.path.join(dirpath, fn))
    return lint_files(sorted(paths), root=root)
