"""Plain PyTorch reference of mamba2-130m decode under full PCILT
(arXiv:2405.21060 for the network; arXiv:2104.01681 for the tables).

Pre-norm residual Mamba2 blocks over a tied embedding.  Under full PCILT
every activation that meets a weight is fake-quantized first, on a
symmetric ``act_bits`` grid with one scale a tensor:

* the normed block input before ``wz``, ``wx``, ``wB``, ``wC`` and ``wdt``
  (one scale a layer, ``"in"``);
* the ``[B, k, C]`` window of the depthwise conv frontend (one scale for
  every layer, ``"conv"``);
* the gated, normed inner stream before ``wo`` (one scale a layer,
  ``"out"``);
* the final normed state before the head, whose weight, the tied
  embedding, is fake-quantized to ``head_weight_bits`` (``"head"``).

A table fetch sums pre-computed products of a code and a weight, so it
equals the matmul of the fake-quantized activation up to the order of the
float32 sums.  The scales are the absmax of each activation over a dense
full-sequence pass on the calibration tokens, over the grid's span; that
pass computes the state-space duality in chunks, with its operands rounded
to bfloat16 where the published kernel keeps them in bfloat16 and every
contraction summed in float32.  Everything else is float32.  This module
imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .quant import fake_quant, scale_from_amax

PROJ_IN = ("wz", "wx", "wB", "wC", "wdt")


def dims(cfg: Dict):
    d_inner = cfg["expand"] * cfg["d_model"]
    heads = d_inner // cfg["head_dim"]
    gn = cfg["n_groups"] * cfg["d_state"]
    return d_inner, heads, gn, d_inner + 2 * gn


def padded_vocab(cfg: Dict) -> int:
    return cfg["vocab"] + (-cfg["vocab"]) % cfg["pad_vocab_to"]


def layout(cfg: Dict) -> List[tuple]:
    """``(path, shape, init, std)`` of every parameter.  ``"normal"`` leaves
    are ``std`` times a standard normal draw; the projections, the conv
    and the head follow the fan-in rule over the stacked layer axis and the
    input width together, the embedding ``d ** -0.5``."""
    L, d, k = cfg["n_layers"], cfg["d_model"], cfg["conv_kernel"]
    di, H, gn, C = dims(cfg)

    def fan(*shape):
        n = 1
        for s in shape[:-1]:
            n *= s
        return n ** -0.5

    out = [("embed/embedding", (padded_vocab(cfg), d), "normal", d ** -0.5),
           ("blocks/ln/scale", (L, d), "ones", None)]
    for name, o in (("wz", di), ("wx", di), ("wB", gn), ("wC", gn),
                    ("wdt", H)):
        out.append((f"blocks/mixer/{name}/kernel", (L, d, o), "normal",
                    fan(L, d, o)))
    out += [("blocks/mixer/conv_w", (L, k, C), "normal", fan(L, k, C)),
            ("blocks/mixer/conv_b", (L, C), "zeros", None),
            ("blocks/mixer/A_log", (L, H), "zeros", None),
            ("blocks/mixer/dt_bias", (L, H), "zeros", None),
            ("blocks/mixer/D", (L, H), "ones", None),
            ("blocks/mixer/norm/scale", (L, di), "ones", None),
            ("blocks/mixer/wo/kernel", (L, di, d), "normal", fan(L, di, d)),
            ("ln_f/scale", (d,), "ones", None)]
    return out


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _layer(params, l: int) -> Dict[str, torch.Tensor]:
    m = params["blocks"]["mixer"]
    p = {n: m[n]["kernel"][l] for n in PROJ_IN + ("wo",)}
    p.update(conv_w=m["conv_w"][l], conv_b=m["conv_b"][l],
             A_log=m["A_log"][l], dt_bias=m["dt_bias"][l], D=m["D"][l],
             norm=m["norm"]["scale"][l], ln=params["blocks"]["ln"]["scale"][l])
    return p


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Full-sequence state-space duality in chunks: xh ``[B,T,H,P]``, dt
    ``[B,T,H]``, A ``[H]``, Bm/Cm ``[B,T,H,N]`` -> y ``[B,T,H,P]`` in
    bfloat16.  The O(T) operands are rounded to bfloat16, every contraction
    sums float32 products, the decay sums and the state run in float32."""
    f32, cd = torch.float32, torch.bfloat16
    Bsz, T, H, P = xh.shape
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    nc = T // Q

    def r(t):
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xh, dt, Bm, Cm = r(xh.to(cd)), r(dt.to(f32)), r(Bm.to(cd)), r(Cm.to(cd))
    a = dt * A
    cum = torch.cumsum(a, 2)
    li = cum[..., :, None, :]
    lj = cum[..., None, :, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                 device=xh.device))[None, None, :, :, None]
    Lm = torch.exp(torch.where(mask, li - lj, float("-inf")))
    xdt = (xh * dt[..., None].to(cd)).to(cd)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cm.to(f32), Bm.to(f32)) * Lm
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(cd).to(f32),
                           xdt.to(f32))
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    Bd = (Bm * decay_to_end[..., None].to(cd)).to(cd)
    S = torch.einsum("bcjhn,bcjhp->bchnp", Bd.to(f32), xdt.to(f32))
    chunk_decay = torch.exp(a.sum(2))
    h = torch.zeros((Bsz, H, Bm.shape[-1], P), dtype=f32, device=xh.device)
    h_enter = []
    for c in range(nc):
        h_enter.append(h.to(cd))
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_enter = torch.stack(h_enter, 1)
    Ce = (Cm * torch.exp(cum)[..., None].to(cd)).to(cd)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ce.to(f32),
                           h_enter.to(f32))
    return (y_intra + y_inter).to(cd).reshape(Bsz, T, H, P)


def _heads(cfg, xi, Bi, Ci):
    _, H, _, _ = dims(cfg)
    Bsz, T = xi.shape[:2]
    rep = H // cfg["n_groups"]
    xh = xi.reshape(Bsz, T, H, cfg["head_dim"])
    Bm = Bi.reshape(Bsz, T, cfg["n_groups"], cfg["d_state"]) \
        .repeat_interleave(rep, 2)
    Cm = Ci.reshape(Bsz, T, cfg["n_groups"], cfg["d_state"]) \
        .repeat_interleave(rep, 2)
    return xh, Bm, Cm


@torch.no_grad()
def calibrate(params, cfg: Dict, tokens: torch.Tensor) -> Dict:
    """The scales of every quantized activation from a dense full-sequence
    pass over ``tokens [B, T]``: ``{"in": [L], "out": [L], "conv": float,
    "head": float}`` (float32 values as host floats)."""
    bits, eps, k = cfg["act_bits"], cfg["norm_eps"], cfg["conv_kernel"]
    di, H, gn, _ = dims(cfg)
    h = params["embed"]["embedding"].float()[tokens]
    ins, outs, convs = [], [], []
    for l in range(cfg["n_layers"]):
        p = _layer(params, l)
        xn = rmsnorm(p["ln"], h, eps)
        z, xi, Bi, Ci, dt = (xn @ p[n].float() for n in PROJ_IN)
        xBC = torch.cat([xi, Bi, Ci], -1)
        convs.append(xBC.abs().max())
        T = xBC.shape[1]
        pad = F.pad(xBC, (0, 0, k - 1, 0))
        w = p["conv_w"].float()
        xBC = sum(pad[:, i:i + T] * w[i][None, None] for i in range(k))
        xBC = F.silu(xBC + p["conv_b"].float())
        xi, Bi, Ci = torch.split(xBC, [di, gn, gn], -1)
        dt = F.softplus(dt + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        xh, Bm, Cm = _heads(cfg, xi, Bi, Ci)
        y = ssd_chunked(xh, dt, A, Bm, Cm, cfg["chunk"]).float()
        y = (y + p["D"].float()[None, None, :, None] * xh).reshape(
            *y.shape[:2], di)
        y = rmsnorm(p["norm"], y * F.silu(z), eps)
        ins.append(xn.abs().max())
        outs.append(y.abs().max())
        h = h + y @ p["wo"].float()
    head = rmsnorm(params["ln_f"]["scale"], h, eps).abs().max()

    def sc(a):
        return scale_from_amax(a, bits, True)

    return {"in": sc(torch.stack(ins)).cpu().tolist(),
            "out": sc(torch.stack(outs)).cpu().tolist(),
            "conv": float(sc(torch.stack(convs).max())),
            "head": float(sc(head))}


class Decoder:
    """The fake-quantized decode step, one token a row, from a zero state."""

    def __init__(self, params, cfg: Dict, scales: Dict):
        self.p, self.cfg, self.s = params, cfg, scales
        k = params["embed"]["embedding"].float().T  # [d, Vp], tied
        wbits = cfg["head_weight_bits"]
        self.head_w = fake_quant(k, wbits, True,
                                 scale_from_amax(k.abs().max(), wbits, True))

    def zero_state(self, batch: int, device) -> Dict:
        cfg = self.cfg
        _, H, _, C = dims(cfg)
        L = cfg["n_layers"]
        return {"conv": torch.zeros((L, batch, cfg["conv_kernel"] - 1, C),
                                    device=device),
                "ssd": torch.zeros((L, batch, H, cfg["d_state"],
                                    cfg["head_dim"]), device=device)}

    @torch.no_grad()
    def step(self, tokens: torch.Tensor, state: Dict):
        """``tokens [B]`` -> ``(logits [B, Vp], new state)``."""
        cfg, s = self.cfg, self.s
        bits, eps = cfg["act_bits"], cfg["norm_eps"]
        di, H, gn, _ = dims(cfg)
        x = self.p["embed"]["embedding"].float()[tokens]  # [B, d]
        convs, ssds = [], []
        for l in range(cfg["n_layers"]):
            p = _layer(self.p, l)
            xq = fake_quant(rmsnorm(p["ln"], x, eps), bits, True, s["in"][l])
            z, xi, Bi, Ci, dt = (xq @ p[n].float() for n in PROJ_IN)
            xBC = torch.cat([xi, Bi, Ci], -1)
            window = torch.cat([state["conv"][l], xBC[:, None]], 1)
            wq = fake_quant(window, bits, True, s["conv"])
            xBC = torch.einsum("bkc,kc->bc", wq, p["conv_w"].float()) \
                + p["conv_b"].float()
            convs.append(window[:, 1:])
            xi, Bi, Ci = torch.split(F.silu(xBC), [di, gn, gn], -1)
            dt = F.softplus(dt + p["dt_bias"].float())  # [B, H]
            A = -torch.exp(p["A_log"].float())
            xh, Bm, Cm = (t[:, 0] for t in _heads(cfg, xi[:, None],
                                                  Bi[:, None], Ci[:, None]))
            h = state["ssd"][l] * torch.exp(dt * A)[..., None, None] \
                + torch.einsum("bhn,bhp->bhnp", Bm * dt[..., None], xh)
            ssds.append(h)
            y = torch.einsum("bhn,bhnp->bhp", Cm, h) \
                + p["D"].float()[None, :, None] * xh
            y = rmsnorm(p["norm"], y.reshape(-1, di) * F.silu(z), eps)
            x = x + fake_quant(y, bits, True, s["out"][l]) @ p["wo"].float()
        xf = rmsnorm(self.p["ln_f"]["scale"], x, eps)
        logits = fake_quant(xf, bits, True, s["head"]) @ self.head_w
        return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}

    def teacher_forced(self, seqs: Sequence[Sequence[int]], device):
        """Feed each token sequence from a zero state, all rows at once;
        returns each row's logits ``[len(seq) - 1, Vp]`` (the logits after
        token ``i`` predict token ``i + 1``)."""
        n = max(len(q) for q in seqs)
        toks = torch.zeros((len(seqs), n), dtype=torch.long)
        for r, q in enumerate(seqs):
            toks[r, :len(q)] = torch.as_tensor(list(q))
        toks = toks.to(device)
        state = self.zero_state(len(seqs), device)
        out = []
        for i in range(n - 1):
            logits, state = self.step(toks[:, i], state)
            out.append(logits)
        allp = torch.stack(out, 1) if out else torch.zeros(
            (len(seqs), 0, self.head_w.shape[1]), device=device)
        return [allp[r, :len(q) - 1] for r, q in enumerate(seqs)]
