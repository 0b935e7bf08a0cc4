"""Mamba2 language model (port of ``repro.models.mamba``).

Pre-norm residual Mamba2 blocks over a tied embedding.  The layer stack is
stored stacked (``[L, ...]`` per parameter, as the reference scans it) and
:meth:`MambaLM.loss`, :meth:`MambaLM.prefill` and :meth:`MambaLM.decode_step`
walk it with a Python loop, handing each layer views of its parameters and
its index into the PCILT stacks — never a copy.  The loss runs each block
under ``cfg.remat_policy``.

PCILT bundle (``build_pcilt``): conv tables ``[L, C, V]``, one
``[L, G, V, O]`` stack per projection (with ``paired``, one segment-major
paired ``[G2, L, V2, O]`` stack) with host float32 scales ``[L]``, and the
shared-pool logits head; tables are built one layer (or a few pool rows) at
a time into preallocated stacks, so peak memory stays close to the tables
themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (QuantSpec, SharedGroupedTables,
                              ShardedTables, build_dwconv_tables,
                              build_grouped_tables, build_paired_tables,
                              build_paired_stacked_tables,
                              build_shared_grouped_tables, fake_quant,
                              mesh_shard_count, pcilt_linear,
                              scale_from_amax)
from repro_torch.nn.layers import (Rows, embed, embed_spec, rmsnorm,
                                   rmsnorm_spec, vocab_embed, vocab_logits)
from repro_torch.nn.module import (ParamSpec, Placed, layer_view,
                                   pcilt_table_sharding, remat, stack_specs)
from repro_torch.nn.ssm import (PROJ_NAMES, mamba_block, mamba_decode,
                                mamba_spec, ssm_cache_specs)

__all__ = ["MambaLM", "layer_view", "HEAD_WEIGHT_BITS"]

#: weight bits of the quantized logits head (the reference's default)
HEAD_WEIGHT_BITS = 4


@dataclasses.dataclass
class MambaLM:
    cfg: Any

    def param_specs(self):
        cfg = self.cfg
        block = {"ln": rmsnorm_spec(cfg.d_model, cfg.param_dtype),
                 "mixer": mamba_spec(cfg, cfg.param_dtype)}
        p = {"embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                 cfg.param_dtype),
             "blocks": stack_specs(block, cfg.n_layers),
             "ln_f": rmsnorm_spec(cfg.d_model, cfg.param_dtype)}
        if not cfg.tie_embeddings:
            p["lm_head"] = {"kernel": ParamSpec(
                (cfg.d_model, cfg.padded_vocab), cfg.param_dtype, "fan_in",
                axes=("embed", "vocab"))}
        return p

    def cache_specs(self, batch: int, max_len: Optional[int] = None):
        """Decode cache: per-layer ``conv``/``ssd`` state, whose size does
        not depend on ``max_len``, and the reference's ``pos`` (a 0-d
        tensor, which a caller may replace by a host int; the step does
        not read it)."""
        return {"layers": ssm_cache_specs(self.cfg, batch, self.cfg.n_layers),
                "pos": ParamSpec((), torch.int32, "zeros", axes=())}

    def _head_kernel(self, params) -> torch.Tensor:
        """The head's ``[d, Vp]`` float32 kernel (a placed one joined on
        its mesh's first device)."""
        if self.cfg.tie_embeddings:
            return _whole(params["embed"]["embedding"]).float().T
        return _whole(params["lm_head"]["kernel"]).float()

    def _logits(self, params, x):
        return x @ self._head_kernel(params).to(self.cfg.dtype)

    def loss(self, params, batch, *, ctx=None):
        """The training loss over ``batch`` (``tokens``, ``labels [B, S]``,
        optional ``loss_mask``): ``(ce + 1e-4 * z, {"ce", "z"})``.  Each
        block runs under ``cfg.remat_policy``; the values do not depend on
        it.  Under a mesh (placed parameters) the blocks run their
        per-shard bodies, the rows' final states are joined on the mesh's
        first device and the head is vocab-parallel there."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], ctx)

        def blk(x, p):
            return _add(x, mamba_block(p["mixer"], cfg,
                                       _norm(p["ln"], cfg, x, ctx), ctx=ctx))

        blk = remat(blk, cfg.remat_policy)
        for l in range(cfg.n_layers):
            x = blk(x, layer_view(params["blocks"], l))
        x = _norm(params["ln_f"], cfg, x, ctx)
        return _ce(self, params, x, batch, ctx)

    def prefill(self, params, batch, *, ctx=None):
        """Full-sequence dense pass over ``batch["tokens"] [B, S]``: the last
        position's logits ``[B, Vp]`` and the decode-ready cache of each
        layer's final ``conv`` (the raw pre-conv tail) and ``ssd`` states,
        constant-size whatever S is; :meth:`decode_step` and
        ``PCILTMambaDecode.step`` take it as is.  Under a mesh (placed
        parameters) the blocks run their per-shard bodies and the cache
        comes back placed by the cache rules."""
        cfg = self.cfg
        stack = Placed.stack if _mesh(ctx) else torch.stack
        x = self._embed(params, batch["tokens"], ctx)
        convs, ssds = [], []
        for l in range(cfg.n_layers):
            p = layer_view(params["blocks"], l)
            y, st = mamba_block(p["mixer"], cfg, _norm(p["ln"], cfg, x, ctx),
                                return_state=True, ctx=ctx)
            x = _add(x, y)
            convs.append(st["conv"])
            ssds.append(st["ssd"])
        x = _norm(params["ln_f"], cfg, x, ctx)
        logits = self._head(params, _last(x), ctx)[:, 0]
        return logits, {"layers": {"conv": stack(convs), "ssd": stack(ssds)}}

    # -- calibration and the PCILT build ------------------------------------

    def calibrate_pcilt(self, params, batch, *, ctx=None):
        """One full-sequence pass over a calibration batch (``batch["tokens"]
        [B, S]``) capturing the per-layer absmax of every activation the
        PCILT decode quantizes: ``{"in": [L], "out": [L], "conv_in": [],
        "head_in": []}`` (float32).  Under a ``ctx`` with a mesh the pass
        runs on the placed parameters through the per-shard bodies, each
        absmax maxed over the rows and shards on the mesh's first
        device."""
        cfg = self.cfg
        h = self._embed(params, batch["tokens"], ctx)
        ins, outs, convs = [], [], []
        for l in range(cfg.n_layers):
            p = layer_view(params["blocks"], l)
            xn = _norm(p["ln"], cfg, h, ctx)
            y, calib = mamba_block(p["mixer"], cfg, xn, return_calib=True,
                                   ctx=ctx)
            ins.append(_absmax(xn, ctx))
            outs.append(calib["wo_in"])
            convs.append(calib["conv_in"])
            h = _add(h, y)
        head_in = _absmax(_norm(params["ln_f"], cfg, h, ctx), ctx)
        return {"in": torch.stack(ins), "out": torch.stack(outs),
                "conv_in": torch.stack(convs).max(), "head_in": head_in}

    def build_pcilt(self, params, scale, proj_scales=None, *, mesh=None,
                    mesh_axis: str = "model", table_dtype=torch.float32,
                    head_scale=None, record_integrity: bool = True,
                    paired: bool = False):
        """Offline PCILT build for the decode loop (requires ``cfg.pcilt``).

        ``scale`` is the conv input's float32 scale; ``proj_scales``
        ``{"in": [L], "out": [L]}`` adds a stacked ``[L, G, V, O]`` table
        per projection (``table_dtype`` float32 or bfloat16, built in
        float32 and cast once, fetched by the ``"fused"`` path; a caller may
        set the bundle's ``"path"`` to ``"dense_fq"`` for the oracle) or,
        with ``paired``, a segment-major paired ``[G2, L, V2, O]`` stack;
        ``head_scale`` adds the shared-pool head.  With ``mesh`` each
        projection stack is built straight into its segment shards over
        ``mesh_axis`` (``core.pcilt.ShardedTables``: ``[L, G/D, V, O]``
        blocks, or ``[G2/D, L, V2, O]`` paired), layer by layer, so the
        whole stack never exists beside its shards; the conv tables and the
        head stay whole, as in the reference.  Placed parameters (a mesh's)
        are read one layer at a time, each layer's weight joined on the
        mesh's first device for its tables (the head's kernel once).
        The bundle carries its conversion-time CRC-32 record unless
        ``record_integrity`` is False (the caller then records it)."""
        from repro_torch.core.serving import pcilt_integrity

        cfg = self.cfg
        if cfg.pcilt is None:
            raise ValueError(
                "MambaLM.build_pcilt requires cfg.pcilt (a configs.base."
                "PCILTConfig supplying act_bits/group for the table build)")
        spec = QuantSpec(bits=cfg.pcilt.act_bits, symmetric=True)
        conv_w = params["blocks"]["mixer"]["conv_w"]  # [L, k, C]
        L, k, C = conv_w.shape
        scale = _f32(scale)
        tables = torch.empty((L, C, 1 << (spec.bits * k)), dtype=torch.float32,
                             device=conv_w.device)
        for l in range(L):
            tables[l] = build_dwconv_tables(_at(conv_w, l), spec, scale)
        out = {"tables": tables, "scale": scale, "spec": spec}
        if proj_scales is not None:
            out["proj"] = self._build_proj_pcilt(params, spec, proj_scales,
                                                 table_dtype, paired, mesh,
                                                 mesh_axis)
        if head_scale is not None:
            out["head"] = self._build_head_pcilt(params, _f32(head_scale))
        if record_integrity:
            out["integrity"] = pcilt_integrity(out)
        return out

    def _build_proj_pcilt(self, params, spec, proj_scales, table_dtype,
                          paired=False, mesh=None, mesh_axis="model"):
        group = self.cfg.pcilt.group
        tabs, scales = {}, {}
        for name in PROJ_NAMES:
            ks = params["blocks"]["mixer"][name]["kernel"]  # [L, n, O]
            s = proj_scales["out" if name == "wo" else "in"]
            s_l = s.detach().cpu().float() if torch.is_tensor(s) else \
                torch.tensor(np.asarray(s, np.float32))
            scales[name] = s_l
            if paired and isinstance(ks, Placed):  # one layer joined a time
                L, n, O = ks.shape
                t = torch.empty((-(-n // (2 * group)), L,
                                 1 << (2 * spec.bits * group), O),
                                dtype=table_dtype, device=ks.device)
                for l in range(L):
                    t[:, l] = build_paired_tables(_at(ks, l).float(), spec,
                                                  float(s_l[l]), group)
            elif paired:  # pads n to the pair width itself (zero weights)
                t = build_paired_stacked_tables(ks, spec, s_l, group,
                                                dtype=table_dtype)
            if paired:
                D = mesh_shard_count(mesh, mesh_axis, t.shape[0])
                # [G2/D, L, V2, O] blocks: views of t on t's device
                tabs[name] = t if D == 1 else ShardedTables.place(
                    t, pcilt_table_sharding(mesh, t.shape[0], ndim=4,
                                            mesh_axis=mesh_axis, seg_axis=0))
                continue
            L, n, O = ks.shape
            pad_n = (-n) % group
            G = (n + pad_n) // group
            D = mesh_shard_count(mesh, mesh_axis, G)
            devs = mesh.axis_devices(mesh_axis) if D > 1 else [ks.device]
            blocks = [torch.empty((L, G // D, 1 << (spec.bits * group), O),
                                  dtype=table_dtype, device=dev)
                      for dev in devs]
            for l in range(L):
                wf = _at(ks, l).float()
                if pad_n:  # group-alignment slots from zero weights
                    wf = torch.cat([wf, wf.new_zeros((pad_n, O))], 0)
                t_l = build_grouped_tables(wf, spec, float(s_l[l]), group)
                for d, b in enumerate(blocks):
                    b[l].copy_(t_l[d * (G // D):(d + 1) * (G // D)])
                del t_l
            tabs[name] = blocks[0] if D == 1 else ShardedTables(
                blocks, 1, mesh, mesh_axis)
        return {"tables": tabs, "scales": scales, "spec": spec,
                "group": group, "path": "fused", "paired": paired,
                "mesh": mesh, "mesh_axis": mesh_axis}

    def _build_head_pcilt(self, params, head_scale: float):
        """Shared-pool PCILT over the logits head, its weights quantized to
        ``HEAD_WEIGHT_BITS`` (so segments can repeat and dedupe); the
        quantized kernel rides along as the head's dense oracle."""
        cfg = self.cfg
        group = cfg.pcilt.group
        k = self._head_kernel(params)
        wspec = QuantSpec(bits=HEAD_WEIGHT_BITS, symmetric=True)
        w_scale = scale_from_amax(k.abs().max(), wspec)
        kq = fake_quant(k, wspec, w_scale)
        n = kq.shape[0]
        pad = (-n) % group
        kp = torch.cat([kq, kq.new_zeros((pad, kq.shape[1]))], 0) if pad else kq
        spec = QuantSpec(bits=cfg.pcilt.act_bits, symmetric=True)
        shared = build_shared_grouped_tables(kp, spec, head_scale, group)
        return {"pool": shared.pool, "seg_idx": shared.seg_idx,
                "group": group, "spec": spec, "scale": head_scale,
                "kernel_q": kq, "n": n + pad}

    # -- decode -------------------------------------------------------------

    def _head_logits(self, head, x, ok: bool = True):
        """Last-position logits ``[B, d] -> [B, Vp]`` through the shared-pool
        head, or its dense fake-quant oracle when ``ok`` is False."""
        cfg = self.cfg
        if not ok:
            xq = fake_quant(x.float(), head["spec"], head["scale"])
            return (xq @ head["kernel_q"]).to(cfg.dtype)
        pad = head["n"] - x.shape[-1]
        xx = x.float()
        if pad:  # group-alignment slots (zero weights -> zero tables)
            xx = torch.cat([xx, xx.new_zeros((*xx.shape[:-1], pad))], -1)
        shared = SharedGroupedTables(pool=head["pool"], seg_idx=head["seg_idx"],
                                     group=head["group"])
        return pcilt_linear(xx, shared, head["spec"], head["scale"],
                            head["group"], path="shared").to(cfg.dtype)

    def _embed(self, params, tokens, ctx):
        """Token embeddings; under a mesh the rows' blocks, vocab-parallel."""
        if _mesh(ctx):
            return vocab_embed(ctx, params["embed"]["embedding"],
                               ctx.split_rows(tokens), self.cfg.dtype)
        return embed(params["embed"], tokens, self.cfg.dtype)

    def _head(self, params, x, ctx) -> torch.Tensor:
        """The dense head's logits; under a mesh vocab-parallel over the
        rows, joined on the mesh's first device."""
        cfg = self.cfg
        if not _mesh(ctx):
            return self._logits(params, x)
        if cfg.tie_embeddings:
            out = vocab_logits(ctx, params["embed"]["embedding"], x,
                               cfg.dtype, tied=True)
        else:
            out = vocab_logits(ctx, params["lm_head"]["kernel"], x,
                               cfg.dtype, tied=False)
        return ctx.join_rows(out)

    def decode_step(self, params, cache, tokens: torch.Tensor, pcilt=None,
                    layer_ok: Optional[Sequence[bool]] = None,
                    head_ok: Optional[bool] = None, with_stats: bool = False,
                    *, ctx=None):
        """One decode step: tokens ``[B, 1]`` -> ``(logits [B, Vp],
        new_cache)``, plus the per-layer saturation stats
        ``{"in"|"conv"|"out": {"count" [L] int32, "ratio" [L] float32}}``
        with ``with_stats``.

        ``layer_ok`` (``L`` host bools) and ``head_ok`` (host bool) demote a
        layer's fetches, or the head's, to their dense fake-quant oracles;
        all-healthy runs exactly the unmasked computation.

        Under a ``ctx`` with a mesh the parameters and cache are placed:
        the layers run their per-shard bodies (``nn.ssm``), the bundle's
        tables are fetched where the bundle holds them, and the logits come
        back whole on the mesh's first device."""
        cfg = self.cfg
        if pcilt is None and (layer_ok is not None or head_ok is not None
                              or with_stats):
            raise ValueError("layer_ok/head_ok/with_stats concern PCILT "
                             "fetches; they require a pcilt bundle")
        stack = Placed.stack if _mesh(ctx) else torch.stack
        x = self._embed(params, tokens, ctx)
        proj = None if pcilt is None else pcilt.get("proj")
        if proj is not None:  # host float32 scales -> python floats, once
            scales = {k: v.tolist() for k, v in proj["scales"].items()}
        convs, ssds = [], []
        sat = {g: ([], []) for g in ("in", "conv", "out")}
        for l in range(cfg.n_layers):
            p = layer_view(params["blocks"], l)
            st = {"conv": layer_view(cache["layers"]["conv"], l),
                  "ssd": layer_view(cache["layers"]["ssd"], l)}
            pc = None
            if pcilt is not None:
                ok = True if layer_ok is None else bool(layer_ok[l])
                pc = {"tables": pcilt["tables"][l], "scale": pcilt["scale"],
                      "spec": pcilt["spec"], "ok": ok}
                if proj is not None:
                    pc["proj"] = {
                        "tables": proj["tables"], "spec": proj["spec"],
                        "group": proj["group"], "path": proj["path"],
                        "paired": proj.get("paired", False),
                        "mesh": proj.get("mesh"),
                        "mesh_axis": proj.get("mesh_axis", "model"),
                        "layer": l, "ok": ok,
                        "scale": {k: v[l] for k, v in scales.items()}}
            res = mamba_decode(p["mixer"], cfg, _norm(p["ln"], cfg, x, ctx),
                               st, pcilt=pc, with_stats=with_stats, ctx=ctx)
            y, st2 = res[:2]
            x = _add(x, y)
            for g, (count, ratio) in (res[2] if with_stats else {}).items():
                sat[g][0].append(count)
                sat[g][1].append(ratio)
            convs.append(st2["conv"])
            ssds.append(st2["ssd"])
        x = _norm(params["ln_f"], cfg, x, ctx)
        head = None if pcilt is None else pcilt.get("head")
        if head is None:
            logits = self._head(params, x, ctx)[:, -1]
        else:
            xl = (ctx.join_rows(x) if _mesh(ctx) else x)[:, -1]
            logits = self._head_logits(head, xl.to(head["pool"].device),
                                       True if head_ok is None else head_ok)
        new_cache = dict(cache, layers={"conv": stack(convs),
                                        "ssd": stack(ssds)})
        if with_stats:
            stats = {g: {"count": torch.stack(c), "ratio": torch.stack(r)}
                     for g, (c, r) in sat.items()}
            return logits, new_cache, stats
        return logits, new_cache


def _mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def _absmax(x, ctx):
    """``max |x|`` in float32, of a tensor or over the rows of a
    ``nn.layers.Rows`` (on the mesh's first device)."""
    if not isinstance(x, Rows):
        return x.abs().max().float()
    dev = ctx.device(ctx.rows()[0])
    return torch.stack([t.abs().max().float().to(dev)
                        for t in x.values()]).max()


def _ce(model, params, x, batch, ctx):
    """The chunked vocabulary loss of the final normed states ``x`` (a
    tensor, or the rows' blocks joined on the mesh's first device with the
    head vocab-parallel there): ``(ce + 1e-4 * z, {"ce", "z"})``."""
    from .transformer import chunked_ce_loss

    cfg = model.cfg
    if _mesh(ctx):
        x = ctx.join_rows(x)
        row0 = ctx.rows()[0]

        def logits_fn(xc):
            return model._head(params, Rows({row0: xc}, xc.shape[0]), ctx)
    else:
        def logits_fn(xc):
            return model._logits(params, xc)
    labels = batch["labels"].to(x.device)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    ce, z = chunked_ce_loss(logits_fn, x, labels, mask.float().to(x.device),
                            cfg.loss_chunk)
    return ce + 1e-4 * z, {"ce": ce, "z": z}


def _norm(p, cfg, x, ctx):
    """RMSNorm of a tensor, or of each row's block under a mesh."""
    if not _mesh(ctx):
        return rmsnorm(p, x, cfg.norm_eps)
    return x.map(lambda row, t: rmsnorm(
        {"scale": ctx.weight(p["scale"], row, 0).to(t.device)}, t,
        cfg.norm_eps))


def _add(x, y):
    """``x + y`` of tensors or of ``nn.layers.Rows``."""
    if isinstance(x, Rows):
        return x.map(lambda row, t: t + y[row])
    return x + y


def _last(x):
    """The last position ``[:, -1:]`` of a tensor or of each row."""
    if isinstance(x, Rows):
        return x.map(lambda _, t: t[:, -1:])
    return x[:, -1:]


def _whole(t):
    """A tensor, or a placed leaf joined on its mesh's first device."""
    return t.join() if isinstance(t, Placed) else t


def _at(stack, l: int) -> torch.Tensor:
    """Layer ``l`` of a stacked leaf, whole (a placed stack's layer joined
    on its mesh's first device: one layer at a time, never the stack)."""
    return _whole(layer_view(stack, l))


def _f32(v) -> float:
    """A scale as the float32 value the kernels take, held as a host float."""
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return float(np.float32(np.asarray(v)))
