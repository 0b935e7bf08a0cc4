"""Base layers (port of ``repro.nn.layers``): the sharding context
:class:`Ctx`, dense / embedding / norms, :func:`row_parallel` and the
position encodings.  Pure functions ``f(params, x) -> y`` over parameter
dicts built from :mod:`repro_torch.nn.module` specs.

A :class:`Ctx` carries the mesh (``launch.mesh.Mesh``, one process over an
explicit device list) and the logical-to-mesh rules.  Without a mesh every
layer runs whole on its tensors' device.  With one, the parameters and
caches are :class:`~repro_torch.nn.module.Placed` leaves and the layers run
Megatron-style per-shard bodies: a mesh *row* (one coordinate of every
axis but ``"model"``) takes the batch block the ``"batch"`` rule gives it,
and its ``"model"`` shards compute the column-parallel projections over
their local heads and mlp columns, attend over their local heads and KV,
and feed the row-parallel ``wo``/``wd`` (the embedding and the logits are
vocab-parallel).  Partial sums move to the row's first device and are
added there in float32, in shard order, and cast once (no atomics).  A
weight whose ``embed`` dim is cut over the data axes (FSDP) is joined on
the shard's device before use (:meth:`Ctx.weight`).  The residual stream
between the parallel regions lives on the row's first device; an MoE
layer's all-to-all cuts a row's sequence over the model shards and joins
it again (:meth:`Ctx.split_seq`, :meth:`Ctx.join_seq`).

Activation constraints: the port realises the ``"batch"`` (rows), the
``"heads"``/``"kv_heads"``/``"mlp"``/``"ssm_heads"`` (the shards' local
interiors), ``"vocab"`` (vocab-parallel logits) and ``"cache_seq"`` (a
time-sharded KV cache, merged by log-sum-exp) layouts through the per-shard
bodies; :meth:`Ctx.constrain` itself returns its input, so ``"seq_sp"``
(the reference's sequence parallelism of the residual stream, a hint to
XLA's partitioner) is a no-op, as is any constraint on a replicated
activation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import coords
from .module import (ParamSpec, Placed, ShardingRules, TablePlacement,
                     logical_to_partition_spec)

__all__ = ["Ctx", "dense_spec", "dense", "embed_spec", "embed",
           "rmsnorm_spec", "rmsnorm", "layernorm_spec", "layernorm", "rope",
           "sinusoidal_positions", "row_parallel", "row_parallel_rows",
           "Rows", "column_parallel",
           "assemble", "vocab_embed", "vocab_logits"]


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Execution context: mesh + rules (None: one device, no sharding).
    ``decode`` (a decode step) is kept for the reference's signature only:
    nothing in the port reads it.  ``explicit_rs`` routes the blocks'
    row-parallel ``wo``/``wd`` through :func:`row_parallel`
    (:func:`row_parallel_rows`; ``make_train_step(explicit_rs=True)``)."""

    mesh: Any = None
    rules: Optional[ShardingRules] = None
    decode: bool = False
    explicit_rs: bool = False

    def constrain(self, x, *logical_axes):
        """The reference's sharding constraint: returns ``x`` (the port
        realises activation layouts in its per-shard bodies, see the
        module docstring)."""
        return x

    @property
    def data_axes(self) -> Tuple[str, ...]:
        if self.mesh is None:
            return ()
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    # -- the per-shard machinery (a mesh only) -------------------------------

    @property
    def tp(self) -> int:
        """The ``"model"`` axis's size (1 without one)."""
        return int(self.mesh.shape.get("model", 1))

    def rows(self) -> List[Tuple[int, ...]]:
        """Every mesh coordinate with its ``"model"`` coordinate 0, in
        order: the rows."""
        k = self._model_dim()
        return [c for c in self.mesh.coords if k is None or c[k] == 0]

    def _model_dim(self) -> Optional[int]:
        names = self.mesh.axis_names
        return names.index("model") if "model" in names else None

    def coord(self, row, j: int) -> Tuple[int, ...]:
        """Shard ``j`` of ``row``'s model axis."""
        k = self._model_dim()
        if k is None:
            return tuple(row)
        c = list(row)
        c[k] = j
        return tuple(c)

    def device(self, row, j: int = 0) -> torch.device:
        return self.mesh.devices[self.coord(row, j)]

    def at(self, row, j: int = 0):
        """The scope of shard ``j`` of ``row`` (``nn.coords.at``): the code
        in the block runs at that coordinate."""
        return coords.at((self.coord(row, j),))

    def shards(self, row, n: int):
        """``range(n)``, the caller's loop body for ``j`` run at shard
        ``j`` of ``row`` (its per-shard body)."""
        for j in range(n):
            with coords.at((self.coord(row, j),)):
                yield j

    def pspec(self, logical_axes, shape) -> Tuple:
        return logical_to_partition_spec(logical_axes, shape, self.rules)

    def batch_block(self, row, B: int) -> Tuple[int, int]:
        """``(start, stop)`` of the batch ``row`` takes (the ``"batch"``
        rule; the whole batch when it replicates)."""
        memo = self._batch_memo
        if B not in memo:
            entry = self.pspec(("batch",), (B,))[0]
            memo[B] = None if entry is None else \
                TablePlacement(self.mesh, (entry,))
        p = memo[B]
        if p is None:
            return 0, B
        n = p.dim_blocks(0)
        i = p.block_index(self.coord(row, 0))[0]
        return i * (B // n), (i + 1) * (B // n)

    @functools.cached_property
    def _batch_memo(self):
        return {}

    def splits(self, p: Placed, dim: int) -> int:
        """Blocks of ``p``'s dim ``dim`` along the model axis: the shards
        of a parallel region (1 when it replicates there)."""
        entry = p.spec[dim]
        if entry is None:
            return 1
        if entry != "model":
            raise NotImplementedError(
                f"dim {dim} of a weight is cut over {entry!r}; the per-shard "
                f"bodies split tensor-parallel dims over 'model' only")
        return self.tp

    def weight(self, p: Placed, row, j: int, dtype=None) -> torch.Tensor:
        """Shard ``j`` of ``row``'s block of weight ``p``, its FSDP dims
        joined on the shard's device (each block cast to ``dtype`` first,
        when given)."""
        return p.gather(self.coord(row, j), self.data_axes, dtype)

    def split_seq(self, row, x: torch.Tensor) -> List[torch.Tensor]:
        """``row``'s ``[b, S, ...]`` cut along the sequence into ``tp``
        contiguous pieces, piece ``j`` on shard ``j``'s device (``S`` a
        multiple of ``tp``)."""
        n = x.shape[1] // self.tp
        return [x[:, j * n:(j + 1) * n].to(self.device(row, j))
                for j in self.shards(row, self.tp)]

    def join_seq(self, row, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """The pieces of :meth:`split_seq` joined in order on ``row``'s
        first device."""
        dev = self.device(row)
        with self.at(row), coords.kind("all-gather"):
            return torch.cat([p.to(dev) for p in pieces], 1)

    def split_rows(self, t: torch.Tensor) -> "Rows":
        """A batch-leading tensor cut into the rows' batch blocks, each on
        its row's first device."""
        B = t.shape[0]
        out = {}
        for row in self.rows():
            blk = t[slice(*self.batch_block(row, B))]
            with self.at(row):
                out[row] = blk.to(self.device(row))
        return Rows(out, B)

    def join_rows(self, xs: "Rows") -> torch.Tensor:
        """The rows' batch blocks joined in batch order on the mesh's first
        device."""
        row0 = self.rows()[0]
        dev = self.device(row0)
        blocks = {}
        for row, x in dict.items(xs):
            blocks.setdefault(self.batch_block(row, xs.batch), x)
        with self.at(row0), coords.kind("all-gather"):
            return torch.cat([blocks[k].to(dev) for k in sorted(blocks)], 0)

    def from_shards(self, placement: TablePlacement, shape, dtype,
                    pieces) -> Placed:
        """A placed leaf whose block at mesh coordinate ``c`` is
        ``pieces[(row, j)]`` of ``c``'s row and model shard (shard 0 where
        the leaf does not split over ``"model"``), taken from the first
        coordinate holding that block (its replicas hold equal pieces)."""
        k = self._model_dim()
        split = k is not None and "model" in placement.spec
        first = {}
        for c in self.mesh.coords:
            first.setdefault(placement.block_index(c), c)

        def block(index, dev):
            c = first[index]
            return pieces[(self.coord(c, 0), c[k] if split else 0)] \
                .to(dev, dtype)

        return Placed.build(placement, shape, dtype, block)

    def reduce(self, parts: Sequence[torch.Tensor], row, dtype,
               kind: str = "all-reduce") -> torch.Tensor:
        """Partial sums added in float32, in shard order, on ``row``'s
        first device, then cast once to ``dtype`` (the parts' moves
        recorded as ``kind``)."""
        dev = self.device(row)
        with self.at(row), coords.kind(kind):
            acc = parts[0].to(dev, torch.float32)
            for p in parts[1:]:
                acc = acc + p.to(dev, torch.float32)
            return acc.to(dtype)


class Rows(dict):
    """Activations under a mesh: each row's batch block (row -> tensor on
    the row's first device), with the global ``batch`` size.  Iterating
    :meth:`items` runs the loop body for each row at the row's first
    coordinate (``nn.coords.at``)."""

    def __init__(self, items, batch: int):
        super().__init__(items)
        self.batch = int(batch)

    def items(self):
        for row, x in dict.items(self):
            with coords.at((row,)):
                yield row, x

    def map(self, fn) -> "Rows":
        return Rows({r: fn(r, x) for r, x in self.items()}, self.batch)


def column_parallel(ctx, row, p, x, dtype, dim: int = 1):
    """Column-parallel ``dense(p, x, dtype)`` of one mesh row:
    ``[((lo, hi), y)]``, one piece a shard of the kernel's dim ``dim`` (its
    head or mlp columns), each on its shard's device (one piece on the
    row's first device when the dim replicates)."""
    k = p["kernel"]
    n = ctx.splits(k, dim)
    size = k.shape[dim] // n
    out = []
    for j in ctx.shards(row, n):
        local = {"kernel": ctx.weight(k, row, j)}
        if "bias" in p:
            local["bias"] = ctx.weight(p["bias"], row, j)
        y = dense(local, x.to(ctx.device(row, j)), dtype)
        out.append(((j * size, (j + 1) * size), y))
    return out


def assemble(pieces, lo: int, hi: int, dev, dim: int):
    """Columns ``[lo, hi)`` of dim ``dim`` out of pieces ``[((a, b), t)]``
    in column order, joined on ``dev``; where pieces overlap (shards that
    computed the same columns) the first holding a column gives it."""
    parts = []
    at = lo
    with coords.kind("all-gather"):
        for (a, b), t in pieces:
            s0, s1 = max(at, a), min(hi, b)
            if s0 < s1:
                parts.append(t.narrow(dim, s0 - a, s1 - s0).to(dev))
                at = s1
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

def vocab_embed(ctx: Ctx, emb: Placed, tokens: "Rows", dtype) -> "Rows":
    """The vocab-parallel lookup of each row's tokens in a placed
    ``[V, d]`` embedding: each shard's rows (ids outside its block give
    zeros) added in float32 on the row's first device, then cast."""
    n = ctx.splits(emb, 0)
    size = emb.shape[0] // n

    def lookup(row, tok):
        if n == 1:
            return ctx.weight(emb, row, 0).to(dtype)[tok]
        parts = []
        for j in ctx.shards(row, n):
            w = ctx.weight(emb, row, j)
            local = tok.to(w.device) - j * size
            ok = (local >= 0) & (local < size)
            parts.append(w[local.clamp(0, size - 1)].float() * ok[..., None])
        return ctx.reduce(parts, row, dtype)

    return tokens.map(lookup)


def vocab_logits(ctx: Ctx, w: Placed, xs: "Rows", dtype,
                 tied: bool) -> "Rows":
    """The vocab-parallel head of each row: the tied ``[V, d]`` embedding
    (``x @ E.T``) or an ``[d, V]`` kernel, each shard's columns joined on
    the row's first device."""
    def head(row, t):
        if tied:
            parts = [t.to(ctx.device(row, j))
                     @ ctx.weight(w, row, j).to(dtype).T
                     for j in ctx.shards(row, ctx.splits(w, 0))]
        else:
            parts = [y for _, y in column_parallel(ctx, row, {"kernel": w},
                                                   t, dtype)]
        dev = ctx.device(row)
        with coords.kind("all-gather"):
            return torch.cat([p.to(dev) for p in parts], -1)

    return xs.map(head)


def dense_spec(d_in: int, d_out, *, axes, bias: bool = False,
               dtype=torch.float32, init: str = "fan_in"):
    """Kernel ``[d_in, *d_out]`` (``d_out`` an int or a tuple) over the
    logical ``axes`` (one a dim), with a zero bias ``[*d_out]`` over
    ``axes[1:]`` when ``bias``."""
    out_shape = (d_out,) if isinstance(d_out, int) else tuple(d_out)
    p = {"kernel": ParamSpec((d_in, *out_shape), dtype, init,
                             axes=tuple(axes))}
    if bias:
        p["bias"] = ParamSpec(out_shape, dtype, "zeros",
                              axes=tuple(axes[1:]))
    return p


def dense(params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [..., d_in] @ kernel [d_in, *rest] -> [..., *rest]`` in
    ``compute_dtype`` (plus the bias, cast alike)."""
    k = params["kernel"].to(compute_dtype)
    y = x.to(compute_dtype) @ k.reshape(k.shape[0], -1)
    y = y.reshape(*x.shape[:-1], *k.shape[1:])
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def row_parallel(x, w, eq: str, w_gather_axes=("data", "pod"), *,
                 ctx: Ctx):
    """The explicit Megatron-SP row-parallel contraction (the reference's
    ``rowrs``): ``y = einsum(eq, x, w)`` whose contraction dims are cut
    over ``"model"`` (``x`` a :class:`~repro_torch.nn.module.Placed`
    activation ``[B, S, contract...]`` with its dim 2 so cut and its batch
    over the data axes; ``w`` a placed weight ``[contract..., d_out]`` with
    its dim 0 so cut and its last dim over ``w_gather_axes``, joined before
    use).  Each shard's einsum runs on its device (``w`` cast to ``x``'s
    dtype, the products summed in float32); the partial sums are added in
    float32 in shard order on the row's first device, cast once to
    ``x.dtype``, and the sum is split over the sequence onto the model
    devices: a placed ``[B, S, d_out]`` with spec ``(batch, "model",
    None)``.  Differentiable through autograd.

    Returns None where the reference does: no mesh, ``explicit_rs`` off, a
    model axis of 1, or a sequence the model axis does not divide."""
    if ctx.mesh is None or not ctx.explicit_rs:
        return None
    tp = ctx.tp
    S = x.shape[1]
    if tp == 1 or S % tp or S < tp:
        return None
    gather = tuple(a for a in w_gather_axes if a in ctx.mesh.axis_names)
    blocks = {}
    out_dim = None
    for row in ctx.rows():
        parts = []
        for j in ctx.shards(row, tp):
            c = ctx.coord(row, j)
            xl = x.local(c)
            wl = w.gather(c, gather).to(xl.dtype)
            parts.append(torch.einsum(eq, xl.float(), wl.float()))
        total = ctx.reduce(parts, row, x.dtype, kind="reduce-scatter")
        out_dim = total.shape[-1]
        n = S // tp
        with coords.kind("reduce-scatter"):
            for j in ctx.shards(row, tp):
                blocks[ctx.coord(row, j)] = \
                    total[:, j * n:(j + 1) * n].to(ctx.device(row, j))
    spec = (x.spec[0], "model", None)
    return Placed(TablePlacement(ctx.mesh, spec), (x.shape[0], S, out_dim),
                  x.dtype, blocks)


def row_parallel_rows(ctx: Ctx, pieces, w: Placed, eq: str, shape, dtype):
    """A block's row-parallel region (attention ``wo``, MLP ``wd``)
    through :func:`row_parallel` when ``ctx.explicit_rs`` selects it:
    ``pieces`` maps each row to its shards' contraction inputs ``[((lo,
    hi), t)]`` (dim 2 cut over ``"model"``), assembled into a placed
    activation of ``shape``; the sequence-split result is joined back into
    each row's ``[b, S, d_out]`` on the row's first device.  None where
    :func:`row_parallel` declines (and where the region does not split),
    so the caller runs its own reduction."""
    if not ctx.explicit_rs or ctx.splits(w, 0) == 1:
        return None
    spec = (ctx.pspec(("batch",), shape[:1])[0], None, "model") \
        + (None,) * (len(shape) - 3)
    blocks = {ctx.coord(row, j): t for row, ps in pieces.items()
              for j, (_, t) in enumerate(ps)}
    y = row_parallel(Placed(TablePlacement(ctx.mesh, spec), shape, dtype,
                            blocks), w, eq, ctx=ctx)
    if y is None:
        return None
    out = {}
    for row in pieces:
        with ctx.at(row), coords.kind("all-gather"):
            out[row] = torch.cat([y.local(ctx.coord(row, j))
                                  .to(ctx.device(row))
                                  for j in range(ctx.tp)], 1)
    return out


def embed_spec(vocab: int, d: int, dtype=torch.float32):
    # 1/sqrt(d) init keeps tied logits ~unit variance at init
    return {"embedding": ParamSpec((vocab, d), dtype, "embed", d ** -0.5,
                                   axes=("vocab", "embed"))}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token ids ``[...]`` -> embeddings ``[..., d]``."""
    return params["embedding"].to(dtype)[tokens]


def rmsnorm_spec(d: int, dtype=torch.float32):
    return {"scale": ParamSpec((d,), dtype, "ones", axes=(None,))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_spec(d: int, dtype=torch.float32):
    return {"scale": ParamSpec((d,), dtype, "ones", axes=(None,)),
            "bias": ParamSpec((d,), dtype, "zeros", axes=(None,))}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The float32 mean, then the mean of the squared deviations, then
    ``rsqrt``, scale and bias; the result in ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.square(x32 - mu).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over split halves: ``x [..., S, H, D]`` (D even),
    ``positions [..., S]``; angles in float32, the result in ``x.dtype``."""
    half = x.shape[-1] // 2
    # the float32 exponent, then the power rounded once to float32 (as the
    # reference's float32 pow gives it; torch's float32 pow is off by an ulp
    # at some exponents)
    expo = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(float(theta), expo.double()).float()
    ang = positions.float()[..., None] * freq  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def sinusoidal_positions(length: int, d: int, offset=0, *,
                         device=None) -> torch.Tensor:
    """``[length, d]`` float32 position embeddings of positions ``offset``
    .. ``offset + length - 1``: ``[sin, cos]`` of ``pos * freq`` with ``freq
    = 10000 ** (-i / max(d // 2 - 1, 1))``."""
    pos = torch.arange(length, dtype=torch.float32, device=device) + offset
    half = d // 2
    # the float32 exponent, the power rounded once to float32 (as in rope)
    expo = -torch.arange(half, dtype=torch.float32, device=device) \
        / max(half - 1, 1)
    freq = torch.pow(10000.0, expo.double()).float()
    ang = pos[:, None] * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)
