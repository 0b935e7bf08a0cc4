"""Mamba2 (state-space duality) blocks: chunked full-sequence pass and O(1)
decode (port of ``repro.nn.ssm``).

PCILT conv frontend: :func:`build_pcilt_conv` turns a layer's ``conv_w``
into per-channel ``[C, V]`` tables; :func:`mamba_block` (``pcilt=``) then
fetches the whole signal through the fused kernel with CAUSAL padding (the
signal padded with 0.0, the zero point's value), and the decode step the
``[B, k, C]`` window as a VALID conv.  On a CUDA tensor the fused kernel
takes float32 activations (``cfg.dtype=torch.float32``, as the PCILT
serving configs set it) and raises for any other.

Full-PCILT decode: with a PCILT bundle the depthwise conv frontend is one
fused table fetch per channel over the ``[B, k, C]`` window
(``pcilt_depthwise_conv1d(path="fused", padding="VALID")``) and the six
projections ``wz/wx/wB/wC/wdt/wo`` are layer-stacked table fetches
(``pcilt_linear(stacked=layer[, paired])``): the ``[L, G, V, O]`` stacks,
or the segment-major paired ``[G2, L, V2, O]`` ones, stay where they are
and only the layer index moves.

Demotion: a layer whose health bit (a host bool) is False runs its conv and
projections on the dense fake-quant oracle instead — chosen on the host, so
taking it costs no device synchronisation.  ``with_stats`` returns the
saturation ``(count, ratio)`` of each distinct quantizer (``"in"``,
``"conv"``, ``"out"``); the oracle branch computes the same statistics on
the side, so a demoted layer keeps reporting them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core import (QuantSpec, build_dwconv_tables, fake_quant,
                              pcilt_depthwise_conv1d, pcilt_linear,
                              quantize_with_stats)
from .layers import dense, dense_spec, rmsnorm, rmsnorm_spec
from .module import ParamSpec

__all__ = ["mamba_spec", "mamba_block", "mamba_decode", "ssm_cache_specs",
           "build_pcilt_conv", "PROJ_NAMES"]

#: the decode projections a full-PCILT conversion turns into table fetches
PROJ_NAMES = ("wz", "wx", "wB", "wC", "wdt", "wo")


def _zero_stats(device):
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def build_pcilt_conv(params, cfg, scale):
    """One layer's conv frontend as PCILTs: ``conv_w [k, C]`` -> per-channel
    tables ``[C, 2**(act_bits*k)]`` on a symmetric ``cfg.pcilt.act_bits``
    grid (the conv input is a signed pre-activation stream).  ``scale`` is
    the calibrated per-tensor scale of that input.  Returns the ``pcilt=``
    dict :func:`mamba_block` and :func:`mamba_decode` take."""
    if cfg.pcilt is None:
        raise ValueError(
            "build_pcilt_conv requires cfg.pcilt (a configs.base.PCILTConfig "
            "supplying act_bits/group for the table build); got None — set "
            "cfg = dataclasses.replace(cfg, pcilt=PCILTConfig(...)) before "
            "converting, or run the conv dense with pcilt=None")
    spec = QuantSpec(bits=cfg.pcilt.act_bits, symmetric=True)
    tables = build_dwconv_tables(params["conv_w"], spec, scale)
    return {"tables": tables, "scale": scale, "spec": spec}


def _proj(params, name, x, cfg, proj, with_stats: bool = False):
    """One decode projection: the stacked table fetch, the dense fake-quant
    oracle (``proj["path"] == "dense_fq"`` or a demoted layer), or the plain
    dense matmul (no bundle).

    ``proj`` is the per-layer view of the bundle: the full stacks (sharded
    over ``proj["mesh"]`` when it has one), this layer's index and host
    scales, the spec, group, path and health bit."""
    if proj is None or name not in proj["tables"]:
        out = dense(params[name], x, cfg.dtype)
        return (out, *_zero_stats(x.device)) if with_stats else out
    scale = proj["scale"][name]
    spec = proj["spec"]

    def _oracle(xx):
        xq = fake_quant(xx.float(), spec, scale)
        out = dense(params[name], xq, torch.float32).to(cfg.dtype)
        if with_stats:
            _, count, ratio = quantize_with_stats(xx, spec, scale)
            return out, count, ratio
        return out

    if proj.get("path", "fused") == "dense_fq" or not proj.get("ok", True):
        return _oracle(x)
    tables = proj["tables"][name]
    paired = bool(proj.get("paired"))
    # covered reduction width: dense stacks are [L, G, V, O] (G*group),
    # paired stacks segment-major [G2, L, V2, O] (G2*2*group, the phantom
    # segment included)
    want = (tables.shape[0] * 2 * proj["group"] if paired
            else tables.shape[1] * proj["group"])
    pad = want - x.shape[-1]
    if pad:  # group-alignment slots: table rows built from zero weights
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], -1)
    out = pcilt_linear(x, tables, spec, scale, proj["group"],
                       path=proj.get("path", "fused"),
                       mesh=proj.get("mesh"),
                       mesh_axis=proj.get("mesh_axis", "model"),
                       stacked=proj["layer"], paired=paired,
                       return_stats=with_stats)
    if with_stats:
        out, count, ratio = out
        return out.to(cfg.dtype), count, ratio
    return out.to(cfg.dtype)


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def mamba_spec(cfg, dtype=torch.float32):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, conv_ch = _dims(cfg)
    GN = s.n_groups * s.d_state
    return {
        "wz": dense_spec(d, d_inner, dtype=dtype),
        "wx": dense_spec(d, d_inner, dtype=dtype),
        "wB": dense_spec(d, GN, dtype=dtype),
        "wC": dense_spec(d, GN, dtype=dtype),
        "wdt": dense_spec(d, H, dtype=dtype),
        "conv_w": ParamSpec((s.conv_kernel, conv_ch), dtype, "fan_in"),
        "conv_b": ParamSpec((conv_ch,), dtype, "zeros"),
        "A_log": ParamSpec((H,), dtype, "zeros"),
        "dt_bias": ParamSpec((H,), dtype, "zeros"),
        "D": ParamSpec((H,), dtype, "ones"),
        "norm": rmsnorm_spec(d_inner, dtype),
        "wo": dense_spec(d_inner, d, dtype=dtype),
    }


def _conv1d(params, cfg, x, conv_state=None, pcilt=None,
            with_stats: bool = False):
    """Causal depthwise conv over ``[B, T, C]``; returns ``(y, new_state)``
    (plus ``count, ratio`` with ``with_stats``).  With ``pcilt`` the conv is
    a fused table fetch: of the ``[B, k, C]`` window as a VALID conv in
    decode (``conv_state`` given), of the whole signal with CAUSAL padding
    in the full-sequence pass (``new_state`` None there)."""
    k = cfg.ssm.conv_kernel
    w = params["conv_w"].to(x.dtype)  # [k, C]
    if conv_state is not None:
        window = torch.cat([conv_state.to(x.dtype), x], 1)  # [B, k, C]
        win = window[:, -k:]
        if pcilt is None:
            y = torch.einsum("bkc,kc->bc", win, w)[:, None]
            count, ratio = _zero_stats(x.device)
        elif pcilt.get("ok", True):
            y = pcilt_depthwise_conv1d(
                win.contiguous(), params["conv_w"], pcilt["spec"],
                pcilt["scale"], tables=pcilt["tables"], path="fused",
                padding="VALID", return_stats=with_stats)
            if with_stats:
                y, count, ratio = y
            y = y.to(x.dtype)
        else:  # demoted: the dense fake-quant oracle
            wq = fake_quant(win.float(), pcilt["spec"], pcilt["scale"])
            y = torch.einsum("bkc,kc->bc", wq,
                             params["conv_w"].float())[:, None].to(x.dtype)
            if with_stats:
                _, count, ratio = quantize_with_stats(win, pcilt["spec"],
                                                      pcilt["scale"])
        new_state = window[:, -(k - 1):]
        y = y + params["conv_b"].to(x.dtype)
        if with_stats:
            return y, new_state, count, ratio
        return y, new_state
    if pcilt is not None:
        y = pcilt_depthwise_conv1d(
            x.contiguous(), params["conv_w"], pcilt["spec"], pcilt["scale"],
            tables=pcilt["tables"], path="fused", padding="CAUSAL",
            return_stats=with_stats)
        if with_stats:
            y, count, ratio = y
        y = y.to(x.dtype) + params["conv_b"].to(x.dtype)
        return (y, None, count, ratio) if with_stats else (y, None)
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = sum(pad[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    y = y + params["conv_b"].to(x.dtype)
    if with_stats:
        return (y, None, *_zero_stats(x.device))
    return y, None


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """SSD over full sequences, mixed precision as in the reference: the
    O(T) operands are rounded to bf16 where the reference keeps them in
    bf16, every contraction accumulates in float32 (bf16 products are exact
    in float32), the decay cumsums and the state recurrence run float32.

    xh ``[B,T,H,P]``; dt ``[B,T,H]``; A ``[H]``; Bm, Cm ``[B,T,H,N]``.
    Returns y ``[B,T,H,P]`` (bf16) and the final state ``[B,H,N,P]`` (f32).
    """
    f32, cd = torch.float32, torch.bfloat16
    Bsz, T, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    C_ = T // Q

    def r(t):  # [B,T,...] -> [B,C,Q,...]
        return t.reshape(Bsz, C_, Q, *t.shape[2:])

    def up(t):  # a bf16 operand entering a float32-accumulated contraction
        return t.to(f32)

    xh, dt, Bm, Cm = r(xh.to(cd)), r(dt.to(f32)), r(Bm.to(cd)), r(Cm.to(cd))
    a = dt * A                                        # [B,C,Q,H] log-decay
    cum = torch.cumsum(a, 2)
    li = cum[..., :, None, :]
    lj = cum[..., None, :, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                 device=xh.device))[None, None, :, :, None]
    # the mask goes inside the exp: above the diagonal li - lj > 0 grows
    # with the chunk and overflows exp, whose gradient there (inf times a
    # zero cotangent) is NaN; exp(-inf) is 0 with a zero gradient.  The
    # values are the reference's where(mask, exp(li - lj), 0)
    L = torch.exp(torch.where(mask, li - lj, float("-inf")))

    xdt = (xh * dt[..., None].to(cd)).to(cd)          # [B,C,Q,H,P] bf16
    scores = torch.einsum("bcihn,bcjhn->bcijh", up(Cm), up(Bm)) * L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", up(scores.to(cd)), up(xdt))

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    Bd = (Bm * decay_to_end[..., None].to(cd)).to(cd)
    S = torch.einsum("bcjhn,bcjhp->bchnp", up(Bd), up(xdt))
    chunk_decay = torch.exp(a.sum(2))                 # [B,C,H]

    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=xh.device)
    h_enter = []
    for c in range(C_):
        h_enter.append(h.to(cd))  # the state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_enter = torch.stack(h_enter, 1)                 # [B,C,H,N,P] bf16

    Ce = (Cm * torch.exp(cum)[..., None].to(cd)).to(cd)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", up(Ce), up(h_enter))
    y = (y_intra + y_inter).to(cd).reshape(Bsz, T, H, P)
    return y, h


def _split_heads(cfg, x_in, B_in, C_in):
    s = cfg.ssm
    _, H, _ = _dims(cfg)
    Bsz, T = x_in.shape[:2]
    xh = x_in.reshape(Bsz, T, H, s.head_dim)
    rep = H // s.n_groups
    Bm = B_in.reshape(Bsz, T, s.n_groups, s.d_state).repeat_interleave(rep, 2)
    Cm = C_in.reshape(Bsz, T, s.n_groups, s.d_state).repeat_interleave(rep, 2)
    return xh, Bm, Cm


def _finish(params, cfg, y, xh, z, proj=None, with_stats: bool = False):
    """``D`` skip, gate, norm and the output projection; returns ``(out,
    wo_input)`` (plus the ``wo`` stats with ``with_stats``)."""
    d_inner, _, _ = _dims(cfg)
    Bsz, T = y.shape[:2]
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bsz, T, d_inner)
    y = y * F.silu(z.to(y.dtype))
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return _proj(params, "wo", y, cfg, proj, with_stats=with_stats), y


def mamba_block(params, cfg, x: torch.Tensor, return_state: bool = False,
                pcilt=None, return_calib: bool = False):
    """Full-sequence Mamba2 block (training, prefill, calibration).
    ``x [B, T, d] -> [B, T, d]``; ``return_state`` adds the decode-ready
    ``{"conv", "ssd"}`` state, ``pcilt`` (from :func:`build_pcilt_conv`)
    routes the conv frontend through the fused PCILT kernel, and
    ``return_calib`` adds the absmax of the conv input and of the ``wo``
    input."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    z = dense(params["wz"], x, cfg.dtype)
    xi = dense(params["wx"], x, cfg.dtype)
    Bi = dense(params["wB"], x, cfg.dtype)
    Ci = dense(params["wC"], x, cfg.dtype)
    dt = dense(params["wdt"], x, cfg.dtype).float()

    xBC = torch.cat([xi, Bi, Ci], -1)
    conv_tail = xBC[:, -(s.conv_kernel - 1):]
    conv_in_amax = xBC.abs().max().float() if return_calib else None
    xBC, _ = _conv1d(params, cfg, xBC, pcilt=pcilt)
    xBC = F.silu(xBC)
    xi, Bi, Ci = torch.split(xBC, [d_inner, s.n_groups * s.d_state,
                                   s.n_groups * s.d_state], -1)

    dt = F.softplus(dt + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh, Bm, Cm = _split_heads(cfg, xi, Bi, Ci)
    y, h_final = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    out, wo_in = _finish(params, cfg, y.to(cfg.dtype), xh, z)
    results = []
    if return_state:
        results.append({"conv": conv_tail.float(), "ssd": h_final.float()})
    if return_calib:
        results.append({"conv_in": conv_in_amax,
                        "wo_in": wo_in.abs().max().float()})
    return (out, *results) if results else out


def mamba_decode(params, cfg, x: torch.Tensor, state: Dict, pcilt=None,
                 with_stats: bool = False):
    """One-token step.  ``x [B, 1, d]``; ``state {conv [B, k-1, C],
    ssd [B, H, N, P]}``.  ``pcilt`` is the per-layer view of a PCILT bundle
    (conv tables, scale, spec, health bit and the ``"proj"`` view).

    Returns ``(out, new_state)``, plus the stats dict
    ``{"in"|"conv"|"out": (count, ratio)}`` with ``with_stats``: ``wx``
    stands in for the five projections that share the block-input grid."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    proj = None if pcilt is None else pcilt.get("proj")
    stats = {}
    z = _proj(params, "wz", x, cfg, proj)
    xi = _proj(params, "wx", x, cfg, proj, with_stats=with_stats)
    if with_stats:
        xi, count, ratio = xi
        stats["in"] = (count, ratio)
    Bi = _proj(params, "wB", x, cfg, proj)
    Ci = _proj(params, "wC", x, cfg, proj)
    dt = _proj(params, "wdt", x, cfg, proj).float()

    xBC = torch.cat([xi, Bi, Ci], -1)
    conv = _conv1d(params, cfg, xBC, state["conv"], pcilt=pcilt,
                   with_stats=with_stats)
    if with_stats:
        xBC, conv_state, count, ratio = conv
        stats["conv"] = (count, ratio)
    else:
        xBC, conv_state = conv
    xBC = F.silu(xBC)
    xi, Bi, Ci = torch.split(xBC, [d_inner, s.n_groups * s.d_state,
                                   s.n_groups * s.d_state], -1)

    dt = F.softplus(dt + params["dt_bias"].float())[:, 0]  # [B, H]
    A = -torch.exp(params["A_log"].float())
    xh, Bm, Cm = _split_heads(cfg, xi, Bi, Ci)
    xh1, Bm1, Cm1 = xh[:, 0].float(), Bm[:, 0].float(), Cm[:, 0].float()

    dA = torch.exp(dt * A[None])                      # [B, H]
    h = state["ssd"].float()
    h = h * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bm1 * dt[..., None], xh1)
    y = torch.einsum("bhn,bhnp->bhp", Cm1, h)[:, None]  # [B, 1, H, P]
    out, _ = _finish(params, cfg, y.to(cfg.dtype), xh, z, proj=proj,
                     with_stats=with_stats)
    new_state = {"conv": conv_state.to(state["conv"].dtype),
                 "ssd": h.to(state["ssd"].dtype)}
    if with_stats:
        out, count, ratio = out
        stats["out"] = (count, ratio)
        return out, new_state, stats
    return out, new_state


def ssm_cache_specs(cfg, batch: int, n_layers: int):
    s = cfg.ssm
    _, H, conv_ch = _dims(cfg)
    return {
        "conv": ParamSpec((n_layers, batch, s.conv_kernel - 1, conv_ch),
                          torch.float32, "zeros"),
        "ssd": ParamSpec((n_layers, batch, H, s.d_state, s.head_dim),
                         torch.float32, "zeros"),
    }
