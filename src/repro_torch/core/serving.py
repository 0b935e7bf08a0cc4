"""PCILT serving conversion (port of parts of ``repro.core.serving``): the
Mamba decode path and the converted single layers.

:class:`PCILTLinear` / :func:`convert_kernel` convert one ``[d_in, d_out]``
projection (dense grouped tables and/or an extension-3 pool) and
:class:`PCILTDwConv1d` / :func:`convert_dwconv` one depthwise-conv1d
frontend; each call runs one fetch path.

:class:`PCILTConv2d` / :func:`convert_conv_kernel` hoist a convolution's
table build out of serving: the filter is flattened and aligned to the
segment grid and its dense tables (or, with ``shared=True``, its
extension-3 pool) are built once; a call runs one fetch path.
Each converted layer, and :class:`PCILTMambaDecode`, has the reference's
``tune``: it records the winning kernel design of its shapes in the design
cache (``kernels.autotune``).

With ``mesh=`` (a ``launch.mesh.Mesh``) a converted layer is tensor
parallel: its dense tables are cut into ``[G/D, V, O]`` blocks placed on
the mesh axis's devices at conversion (``core.pcilt.ShardedTables``), its
shared pool into a ``ShardedSharedPool``; every call runs the sharded
routes of ``core.lut_layers``, and ``tune`` tunes the local shard's shape.
:func:`convert_mamba_decode` shards the projection stacks alike (the
conv tables and the head stay whole, as in the reference); the integrity
record of a sharded bundle equals the unsharded one's byte for byte (each
layer's shard CRCs chained in shard order), and the monitor's
recalibration writes each shard's block on its own device.

:func:`convert_mamba_decode` is the once-per-lifetime build: calibrate on a
prefill pass, build the conv, projection and head tables, record their
CRC-32s, and wrap the bundle in a :class:`PCILTMambaDecode` that verifies the
record at load; ``paired=True`` builds segment-major paired projection
stacks (two segments per fetch).  On a card every CRC runs in the CRC
kernel (``kernels.ops.pcilt_crc32``).

:class:`HealthMonitor` keeps a converted decode healthy while it serves:
one layer's CRC a tick, a rotating dense-oracle probe, the saturation
sentinel, demotion to the dense oracle and online recalibration (the
reference's, whole).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .lut_layers import (_layer_of, build_dwconv_tables, flatten_filters,
                         mesh_shard_count, pcilt_conv2d,
                         pcilt_depthwise_conv1d, pcilt_linear)
from .pcilt import (SharedGroupedTables, ShardedSharedPool, ShardedTables,
                    build_grouped_tables, build_paired_tables,
                    build_shared_grouped_tables, checksums, layer_checksum,
                    shard_shared_grouped_tables, stacked_checksums,
                    table_checksum)
from .quantization import (QuantSpec, calibrate, dequantize, fake_quant,
                           quantize, scale_from_amax)

log = logging.getLogger("repro_torch.serving")

__all__ = ["pcilt_integrity", "PCILTMambaDecode", "HealthMonitor",
           "convert_mamba_decode",
           "PCILTLinear", "convert_kernel", "PCILTConv2d",
           "convert_conv_kernel", "PCILTDwConv1d", "convert_dwconv",
           "pcilt_apply", "mlp_table_bytes"]


def _place_sharded_pool(sp: ShardedSharedPool, mesh,
                        mesh_axis: str) -> ShardedSharedPool:
    """Each local pool and pointer block on its device of the mesh axis (no
    device holds the global pool)."""
    devs = mesh.axis_devices(mesh_axis)
    return ShardedSharedPool(
        pools=[p.to(d) for p, d in zip(sp.pools, devs)],
        seg_idx=[i.to(d) for i, d in zip(sp.seg_idx, devs)],
        group=sp.group, shard_cards=sp.shard_cards)


def _proj_axis(proj: Dict) -> int:
    """The layer axis of a bundle's projection stacks: 0 for layer-major
    ``[L, G, V, O]``, 1 for segment-major paired ``[G2, L, V2, O]``."""
    return 1 if proj.get("paired") else 0


def _stacks(pcilt: Dict) -> List[Tuple[str, Any, int]]:
    """``(name, stack, layer axis)`` of a bundle's conv and projection
    stacks, in the order of its integrity record."""
    out = [("conv", pcilt["tables"], 0)]
    proj = pcilt.get("proj")
    if proj is not None:
        axis = _proj_axis(proj)
        out += [(name, t, axis) for name, t in proj["tables"].items()]
    return out


def _layer_weight(params, name: str, layer: int) -> torch.Tensor:
    """Layer ``layer`` of a projection's stacked kernel, whole (a placed
    kernel joined on its first device: the tables it feeds are whole)."""
    k = params["blocks"]["mixer"][name]["kernel"]
    if hasattr(k, "blocks"):
        return k.select(0, layer).join()
    return k[layer]


def pcilt_integrity(pcilt: Dict) -> Dict:
    """Conversion-time CRC-32 record of every table of a Mamba PCILT bundle,
    per layer for the stacked arrays (the same record, byte for byte, as
    the reference's for the same tables)."""
    integ: Dict[str, Any] = {}
    for name, t, axis in _stacks(pcilt):
        crcs = stacked_checksums(t, axis)
        if name == "conv":
            integ["conv"] = crcs
        else:
            integ.setdefault("proj", {})[name] = crcs
    head = pcilt.get("head")
    if head is not None:
        pool, seg_idx = checksums([head["pool"], head["seg_idx"]])
        integ["head"] = {"pool": pool, "seg_idx": seg_idx}
    return integ


class PCILTMambaDecode:
    """A converted Mamba decode path: the bundle plus its step.

    ``step(params, cache, tokens, layer_ok, head_ok, with_stats)`` mirrors
    ``MambaLM.decode_step``; ``layer_ok``/``head_ok`` are host bools
    (all-healthy by default).  The bundle's integrity record is verified at
    load (``verify=True``) and on demand.  The step reads the bundle's
    tables and scales at every call (PyTorch runs eagerly: there is no
    compiled executor closing over them), so a table swapped or rewritten
    in place is served from the next step on."""

    def __init__(self, model, pcilt: Dict, *, ctx=None, verify: bool = True):
        self.model = model
        self.pcilt = pcilt
        #: the sharding context of the step: with a mesh the parameters and
        #: cache a step takes are placed (``nn.module.place``) and the SSD
        #: and conv state and the recurrence run per shard; the tables stay
        #: as the bundle holds them
        self.ctx = ctx
        if "integrity" not in pcilt:
            pcilt["integrity"] = pcilt_integrity(pcilt)
        if verify:
            bad = self.verify_integrity()
            if bad:
                raise RuntimeError(
                    f"PCILT bundle failed integrity verification at load "
                    f"(corrupted tables): {bad}")

    def rehoist(self, verify: bool = False) -> None:
        """The reference rebuilds its jitted executors here after a table
        swap; the port has none to rebuild, so this only verifies the whole
        bundle against its record when asked (``verify=True``, the
        recalibration hot swap's check), raising on a breach."""
        if verify:
            bad = self.verify_integrity()
            if bad:
                raise RuntimeError(
                    f"PCILT bundle failed integrity verification at rehoist "
                    f"(corrupted tables): {bad}")

    def step(self, params, cache, tokens, layer_ok=None, head_ok=None,
             with_stats: bool = False):
        return self.model.decode_step(params, cache, tokens, pcilt=self.pcilt,
                                      layer_ok=layer_ok, head_ok=head_ok,
                                      with_stats=with_stats, ctx=self.ctx)

    def _recorded(self, name: str) -> List[int]:
        integ = self.pcilt["integrity"]
        return integ["conv"] if name == "conv" else integ["proj"][name]

    def verify_layer(self, layer: int) -> List[Tuple]:
        """Checksum one layer's conv + projection tables against the record
        (one CRC launch on the card for all of them); returns the breached
        ``(name, layer)`` sites (empty = clean)."""
        stacks = _stacks(self.pcilt)
        got = checksums([(t, layer, axis) for _, t, axis in stacks])
        return [(name, int(layer)) for (name, _, _), crc in zip(stacks, got)
                if crc != self._recorded(name)[layer]]

    def verify_head(self) -> List[Tuple]:
        """Checksum the shared-pool head (pool values + pointers, one CRC
        launch on the card)."""
        head = self.pcilt.get("head")
        if head is None:
            return []
        integ = self.pcilt["integrity"]["head"]
        got = checksums([head["pool"], head["seg_idx"]])
        return [(f"head.{k}",) for k, crc in zip(("pool", "seg_idx"), got)
                if crc != integ[k]]

    def verify_integrity(self) -> List[Tuple]:
        """Every layer of every stack plus the head; returns all breached
        sites, layer by layer as :meth:`verify_layer` orders them."""
        stacks = _stacks(self.pcilt)
        got = [stacked_checksums(t, axis) for _, t, axis in stacks]
        bad = [(name, l) for l in range(len(got[0]))
               for (name, _, _), crcs in zip(stacks, got)
               if crcs[l] != self._recorded(name)[l]]
        return bad + self.verify_head()

    def table_bytes(self) -> int:
        """Bytes of the conv and projection stacks (the reference's count;
        the head's pool is not included)."""
        total = _nbytes(self.pcilt["tables"])
        proj = self.pcilt.get("proj")
        if proj is not None:
            total += sum(_nbytes(t) for t in proj["tables"].values())
        return total

    def tune(self, batch=1) -> None:
        """Tune, and record in the design cache, the design of each kernel
        a decode step launches at this batch: the conv frontend's fused
        dwconv on the assembled ``[B, k, C]`` window (``VALID``), and each
        projection's stacked GEMV at layer 0 (the key does not depend on
        the layer), on the segment-major paired stack for a paired bundle.
        ``batch`` is an int or a tuple of them (the stacked keys carry the
        batch).  Each kernel is tuned with and without its saturation
        counters: the two run under different key families.  Under a mesh
        each projection tunes one shard's block (``[L, G/D, V, O]``,
        ``[G2/D, L, V2, O]``): the shape each device's kernel runs, so
        caches tuned at different ``D`` never share a key.  On the CPU this
        consults the cache and times nothing."""
        from repro_torch.kernels import ops

        batches = (batch,) if isinstance(batch, int) else tuple(batch)
        conv_t = self.pcilt["tables"]  # [L, C, V]
        k = self.model.cfg.ssm.conv_kernel
        dev = conv_t.device
        for b in batches:
            win = torch.zeros((b, k, conv_t.shape[1]), dtype=torch.float32,
                              device=dev)
            for stats in (False, True):
                ops.pcilt_fused_dwconv1d(win, conv_t[0], self.pcilt["spec"],
                                         _f32(self.pcilt["scale"]), k,
                                         padding="VALID", autotune=True,
                                         with_stats=stats)
        proj = self.pcilt.get("proj")
        if proj is None or proj.get("path") != "fused":
            return
        group = proj["group"]
        paired = bool(proj.get("paired"))
        for name, t in proj["tables"].items():
            seg_axis = 0 if paired else 1
            G = t.shape[seg_axis]
            D = mesh_shard_count(proj.get("mesh"),
                                 proj.get("mesh_axis", "model"), G)
            # under a mesh: one shard's block, the shape each device runs
            local = t.shards[0] if isinstance(t, ShardedTables) else \
                t.narrow(seg_axis, 0, G // D).contiguous()
            scale = _f32(proj["scales"][name][0])
            for b in batches:
                for stats in (False, True):
                    if paired:
                        x = torch.zeros((b, G // D * 2 * group),
                                        dtype=torch.float32,
                                        device=local.device)
                        ops.pcilt_fused_gemv_paired_stacked(
                            x, local, 0, proj["spec"], scale, group,
                            autotune=True, with_stats=stats)
                    else:
                        x = torch.zeros((b, G // D * group),
                                        dtype=torch.float32,
                                        device=local.device)
                        ops.pcilt_fused_gemv_stacked(
                            x, local, 0, proj["spec"], scale, group,
                            autotune=True, with_stats=stats)


def _f32(v) -> float:
    """A scale (a host scalar or a 0-d/one-element tensor) as a float."""
    return float(v.reshape(()).item()) if torch.is_tensor(v) else float(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class HealthMonitor:
    """Amortized health checking and graceful degradation for a converted
    Mamba decode (port of the reference's, whole).

    A PCILT fetch is exact against the dense matmul on the quantized grid,
    so any deviation is corruption, not noise.  The monitor holds per-layer
    (and head) health masks and once a tick checks **one** still-healthy
    layer (round-robin):

    * **checksum** — :meth:`PCILTMambaDecode.verify_layer` CRCs the layer's
      conv and projection tables against the conversion-time record (on
      the card through the CRC kernel);
    * **dense-oracle probe** (every ``oracle_every``-th clean check) — a
      fixed probe activation through the layer's ``gather`` fetch against
      the fake-quant dense matmul, the projection rotating;
    * every ``n_layers`` ticks the head's pool and pointers are CRC'd.

    On a breach the layer alone (or the head) is demoted: its host mask bit
    is cleared and the next step runs it on the exact dense oracle.
    ``last_verified`` holds the newest tick each layer passed at, bounding
    how far a rollback must rewind.

    Calibration-drift sentinel: :meth:`observe_saturation` turns the
    monitored step's in-kernel saturation counters into per (grid, layer)
    rates and EWMAs; ``sat_hard`` on the rate (``"saturated"``) or
    ``sat_drift`` on the EWMA (``"drifting"``) demotes the layer (event
    ``kind="drift"``) and queues it on :attr:`drift_pending`;
    :meth:`recalibrate_layer` then rebuilds its projections at the observed
    range in place in the resident stacks, re-records their CRCs and
    repromotes it, within ``max_recalibrations``; the ``"conv"`` grid and
    an exhausted budget stay demoted (``drift_sticky``).  The first
    recalibration sets :attr:`tainted`."""

    #: the quantizer grids a monitored step reports, in ``mamba_decode``'s
    #: order
    SAT_GRIDS = ("in", "conv", "out")

    def __init__(self, decode: PCILTMambaDecode, params, *,
                 oracle_every: int = 4, oracle_batch: int = 1,
                 oracle_tol: float = 5e-3, seed: int = 0,
                 sat_hard: float = 0.25, sat_drift: float = 0.02,
                 sat_alpha: float = 0.2, headroom: float = 1.05,
                 max_recalibrations: int = 2):
        cfg = decode.model.cfg
        self.decode = decode
        self.params = params
        self.oracle_every = oracle_every
        self.oracle_tol = oracle_tol
        self.n_layers = int(cfg.n_layers)
        self.layer_ok = np.ones(self.n_layers, bool)
        self.head_ok = True
        #: newest tick each layer passed verification at (-1 = never)
        self.last_verified = np.full(self.n_layers, -1, np.int64)
        self.head_last_verified = -1
        self.checks = 0
        self.events: List[Dict] = []
        rng = np.random.default_rng(seed)
        d_inner = cfg.ssm.expand * cfg.d_model
        conv_ch = d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        self._probe = (0.3 * rng.normal(
            size=(oracle_batch, cfg.d_model))).astype(np.float32)
        # wo reads the gated inner stream, not the block input
        self._probe_out = (0.3 * rng.normal(
            size=(oracle_batch, d_inner))).astype(np.float32)
        self._oracle_rr = 0
        self.sat_hard = float(sat_hard)
        self.sat_drift = float(sat_drift)
        self.sat_alpha = float(sat_alpha)
        self.headroom = float(headroom)
        self.max_recalibrations = int(max_recalibrations)
        #: saturable elements per decode row per grid (count -> rate)
        self._sat_elems = {"in": int(cfg.d_model),
                           "conv": int(cfg.ssm.conv_kernel * conv_ch),
                           "out": int(d_inner)}
        self.sat_last = {g: np.zeros(self.n_layers) for g in self.SAT_GRIDS}
        self.sat_ewma = {g: np.zeros(self.n_layers) for g in self.SAT_GRIDS}
        #: running peak |x|/scale per (grid, layer) since its last
        #: recalibration: the range a rebuild re-scales to
        self.sat_peak = {g: np.zeros(self.n_layers) for g in self.SAT_GRIDS}
        #: (layer, grid) pairs demoted for drift, awaiting recalibration
        self.drift_pending: List[Tuple[int, str]] = []
        self.recalibrations = np.zeros(self.n_layers, np.int64)
        #: True once a recalibration rewrote tables
        self.tainted = False

    # -- masks / state -------------------------------------------------------

    def ok_masks(self) -> Tuple[np.ndarray, bool]:
        """The host ``(layer_ok, head_ok)`` of the next decode step."""
        return self.layer_ok.copy(), bool(self.head_ok)

    @property
    def degraded(self) -> bool:
        return (not bool(self.layer_ok.all())) or not self.head_ok

    def demote(self, kind: str, layer: Optional[int], tick: int,
               reason: str) -> Dict:
        """Clear one health bit: the next step runs that layer (or the
        head) on its dense oracle."""
        if kind == "head":
            self.head_ok = False
        else:
            self.layer_ok[int(layer)] = False
        ev = {"kind": kind, "layer": None if layer is None else int(layer),
              "tick": int(tick), "reason": reason}
        self.events.append(ev)
        log.warning("health breach at tick %d: %s layer=%s (%s) — demoted "
                    "to dense oracle", tick, kind, layer, reason)
        return ev

    # -- checks --------------------------------------------------------------

    def check_outputs(self, logits: torch.Tensor) -> bool:
        """NaN/Inf gate on a step's logits (True = healthy)."""
        return bool(torch.isfinite(logits).all())

    def _oracle_check(self, layer: int, name: str = "wx") -> bool:
        """Probe one layer's ``name`` table fetch (the literal ``gather``
        path) against the fake-quant dense matmul."""
        proj = self.decode.pcilt.get("proj")
        if proj is None or name not in proj["tables"]:
            return True
        t = proj["tables"][name]  # [L, G, V, O] (paired: [G2, L, V2, O])
        spec, group = proj["spec"], proj["group"]
        paired = bool(proj.get("paired"))
        scale = float(proj["scales"][name][layer])
        x = self._probe_out if name == "wo" else self._probe
        n = t.shape[0] * 2 * group if paired else t.shape[1] * group
        pad = n - x.shape[-1]
        xx = np.concatenate(
            [x, np.zeros((x.shape[0], pad), x.dtype)], -1) if pad else x
        got = pcilt_linear(torch.from_numpy(xx).to(t.device), t, spec, scale,
                           group, path="gather", stacked=int(layer),
                           paired=paired)
        k = _layer_weight(self.params, name, layer)
        xt = torch.from_numpy(x).to(k.device)
        want = fake_quant(xt, spec, scale) @ k.float()
        return bool(torch.allclose(got.float(), want, rtol=self.oracle_tol,
                                   atol=self.oracle_tol))

    def _next_probe_name(self) -> str:
        """Round-robin over the converted projections for the oracle probe
        (``wx`` when none converted)."""
        from repro_torch.nn.ssm import PROJ_NAMES

        proj = self.decode.pcilt.get("proj")
        names = tuple(n for n in PROJ_NAMES
                      if proj is not None and n in proj["tables"]) or ("wx",)
        name = names[self._oracle_rr % len(names)]
        self._oracle_rr += 1
        return name

    def on_tick(self, tick: int, sat=None, rows: int = 1) -> List[Dict]:
        """One tick's health pass; returns the breach events (empty =
        clean).  ``sat`` (the monitored step's counters, host arrays or
        tensors) feeds the drift sentinel first, so a ``"saturated"`` step
        is demoted on the tick whose outputs it indicts."""
        tick = int(tick)
        breaches: List[Dict] = []
        if sat is not None:
            breaches.extend(self.observe_saturation(tick, sat, rows))
        candidates = [l for l in range(self.n_layers) if self.layer_ok[l]]
        if candidates:
            l = candidates[tick % len(candidates)]
            bad = self.decode.verify_layer(l)
            if bad:
                breaches.append(self.demote(
                    "layer", l, tick, f"checksum breach: {bad}"))
            else:
                self.checks += 1
                if self.oracle_every and \
                        self.checks % self.oracle_every == 0:
                    name = self._next_probe_name()
                    if not self._oracle_check(l, name):
                        breaches.append(self.demote(
                            "layer", l, tick,
                            f"dense-oracle divergence ({name})"))
            if self.layer_ok[l]:
                self.last_verified[l] = tick
        if self.head_ok and self.decode.pcilt.get("head") is not None and \
                tick % max(self.n_layers, 1) == 0:
            bad = self.decode.verify_head()
            if bad:
                breaches.append(self.demote(
                    "head", None, tick, f"checksum breach: {bad}"))
            else:
                self.head_last_verified = tick
        return breaches

    # -- calibration-drift sentinel ------------------------------------------

    def saturation_state(self, grid: str, layer: int) -> str:
        """``"healthy"`` / ``"drifting"`` (EWMA past ``sat_drift``) /
        ``"saturated"`` (last rate past ``sat_hard``)."""
        if self.sat_last[grid][layer] >= self.sat_hard:
            return "saturated"
        if self.sat_ewma[grid][layer] >= self.sat_drift:
            return "drifting"
        return "healthy"

    def observe_saturation(self, tick: int, sat, rows: int) -> List[Dict]:
        """Feed one monitored step's counters ``{"in"|"conv"|"out":
        {"count" [L], "ratio" [L]}}`` into the sentinel: rates are counts
        over ``rows`` times the grid's elements; a healthy layer whose rate
        breaches ``sat_hard`` or whose EWMA breaches ``sat_drift`` is
        demoted (``kind="drift"``, with grid, state, rate, EWMA and peak
        ratio) and queued on :attr:`drift_pending`."""
        tick = int(tick)
        breaches: List[Dict] = []
        for grid, st in sat.items():
            counts = _host(st["count"]).astype(np.int64)
            ratios = _host(st["ratio"]).astype(np.float64)
            rates = counts / float(max(int(rows), 1) * self._sat_elems[grid])
            a = self.sat_alpha
            self.sat_last[grid] = rates
            self.sat_ewma[grid] = (1.0 - a) * self.sat_ewma[grid] + a * rates
            self.sat_peak[grid] = np.maximum(self.sat_peak[grid], ratios)
            for l in range(self.n_layers):
                if not self.layer_ok[l]:
                    continue
                state = self.saturation_state(grid, l)
                if state == "healthy":
                    continue
                if state == "saturated":
                    reason = (f"saturation {grid} rate={rates[l]:.4f} >= "
                              f"sat_hard={self.sat_hard}")
                else:
                    reason = (f"saturation {grid} "
                              f"ewma={self.sat_ewma[grid][l]:.4f} >= "
                              f"sat_drift={self.sat_drift}")
                ev = self.demote("drift", l, tick, reason)
                ev.update(grid=grid, state=state, rate=float(rates[l]),
                          ewma=float(self.sat_ewma[grid][l]),
                          ratio=float(self.sat_peak[grid][l]))
                self.drift_pending.append((l, grid))
                breaches.append(ev)
        return breaches

    def recalibrate_layer(self, layer: int, grid: str, tick: int) -> Dict:
        """Rebuild one drift-demoted layer's projections at the observed
        range and repromote it.

        The new absmax is the peak ``|x|/scale`` ratio times the old scale,
        times ``headroom``; the grid's projections (``"in"``: the five
        block-input ones; ``"out"``: ``wo``) are rebuilt with conversion's
        arithmetic and written **in place** into the resident stacks (the
        layer's slice), their CRCs re-recorded on the tables' device, their
        host scales updated, and the whole bundle verified
        (``rehoist(verify=True)``).  The ``"conv"`` grid (one scale for
        every layer) and a layer past ``max_recalibrations`` stay demoted
        (``drift_sticky``)."""
        l, tick = int(layer), int(tick)

        def _sticky(reason: str) -> Dict:
            ev = {"kind": "drift_sticky", "layer": l, "tick": tick,
                  "grid": grid, "reason": reason}
            self.events.append(ev)
            log.warning("drift at layer %d stays demoted: %s", l, reason)
            return ev

        proj = self.decode.pcilt.get("proj")
        if grid == "conv":
            return _sticky("conv grid shares one global scale across layers "
                           "— per-layer hot-swap impossible; demoted to the "
                           "dense oracle")
        if proj is None:
            return _sticky("no converted projections to rebuild")
        if self.recalibrations[l] >= self.max_recalibrations:
            return _sticky(
                f"recalibration budget exhausted "
                f"({int(self.recalibrations[l])}/{self.max_recalibrations})")
        spec, group = proj["spec"], proj["group"]
        paired = bool(proj.get("paired"))
        integ = self.decode.pcilt["integrity"]["proj"]
        names = ("wo",) if grid == "out" else tuple(
            n for n in proj["tables"] if n != "wo")
        new_amax = float(self.sat_peak[grid][l]) * self.headroom
        new_scales: Dict[str, float] = {}
        with torch.no_grad():
            for name in names:
                old_scale = float(proj["scales"][name][l])
                new_scale = float(scale_from_amax(
                    torch.tensor(new_amax * old_scale, dtype=torch.float32),
                    spec))
                wf = _layer_weight(self.params, name, l).float()
                t = proj["tables"][name]
                if paired:  # segment-major [G2, L, V2, O]: the layer's slice
                    new = build_paired_tables(wf, spec, new_scale, group)
                else:
                    pad_n = (-wf.shape[0]) % group
                    if pad_n:  # group-alignment slots, as conversion
                        wf = torch.cat([wf, wf.new_zeros((pad_n, wf.shape[1]))],
                                       0)
                    new = build_grouped_tables(wf, spec, new_scale, group)
                # in place; a sharded stack's blocks each on its device
                _layer_of(t, l, _proj_axis(proj)).copy_(new.to(t.dtype))
                integ[name][l] = layer_checksum(t, l, _proj_axis(proj))
                proj["scales"][name][l] = new_scale
                new_scales[name] = float(proj["scales"][name][l])
        self.decode.rehoist(verify=True)
        self.recalibrations[l] += 1
        self.tainted = True
        self.layer_ok[l] = True
        self.last_verified[l] = tick
        self.sat_ewma[grid][l] = 0.0
        self.sat_last[grid][l] = 0.0
        self.sat_peak[grid][l] = 0.0
        ev = {"kind": "recalibrate", "layer": l, "tick": tick, "grid": grid,
              "amax_ratio": new_amax, "scales": new_scales,
              "attempt": int(self.recalibrations[l])}
        self.events.append(ev)
        log.warning("recalibrated layer %d grid %r at tick %d: new scales "
                    "%s — repromoted", l, grid, tick, new_scales)
        return ev

    def recalibrate_pending(self, tick: int) -> List[Dict]:
        """Drain :attr:`drift_pending` between ticks: one
        :meth:`recalibrate_layer` per queued (layer, grid), deduplicated."""
        events: List[Dict] = []
        seen = set()
        pending, self.drift_pending = self.drift_pending, []
        for l, grid in pending:
            if (l, grid) in seen:
                continue
            seen.add((l, grid))
            events.append(self.recalibrate_layer(l, grid, tick))
        return events

    def saturation_summary(self) -> Dict:
        """Per-tick telemetry: worst rate, EWMA and peak ratio per grid,
        recalibrations, pending drift responses, taint."""
        return {
            "rate": {g: float(self.sat_last[g].max(initial=0.0))
                     for g in self.SAT_GRIDS},
            "ewma": {g: float(self.sat_ewma[g].max(initial=0.0))
                     for g in self.SAT_GRIDS},
            "peak_ratio": {g: float(self.sat_peak[g].max(initial=0.0))
                           for g in self.SAT_GRIDS},
            "recalibrations": int(self.recalibrations.sum()),
            "pending": len(self.drift_pending),
            "tainted": bool(self.tainted),
        }


def convert_mamba_decode(model, params, calib_tokens: torch.Tensor, *,
                         ctx=None, mesh=None, mesh_axis: str = "model",
                         table_dtype=torch.float32, paired: bool = False,
                         head: Optional[str] = None,
                         timings: Optional[Dict[str, float]] = None,
                         device="cuda") -> PCILTMambaDecode:
    """Offline full-PCILT conversion of a ``MambaLM`` decode step on
    ``device`` (where ``params`` must lie): calibrate on ``calib_tokens
    [B, S]``, build the conv and projection stacks (segment-major paired
    stacks with ``paired``; with ``head="shared"`` also the shared-pool
    head), record the CRC-32s, verify them at load.  With ``mesh=`` the
    projection stacks are built straight into their segment shards over
    ``mesh_axis`` (``MambaLM.build_pcilt``).  With ``timings`` (a dict) the
    seconds of each phase are stored there.  ``ctx`` is the sharding
    context the returned decode steps under (``PCILTMambaDecode(ctx=)``);
    given placed parameters (``nn.module.place`` on ``ctx``'s mesh) the
    calibration runs under ``ctx`` on them (``MambaLM.calibrate_pcilt(...,
    ctx=)``: the per-shard bodies, never a joined tree) and the tables are
    built from its absmaxes one layer's weights at a time, on the mesh's
    first device."""
    import time

    from repro_torch.interop import resolve_device

    dev = params["embed"]["embedding"].device
    if dev.type != resolve_device(device).type:
        raise ValueError(f"params lie on {dev}, not on the conversion "
                         f"device {device}")
    cfg = model.cfg
    if cfg.pcilt is None:
        raise ValueError(
            "convert_mamba_decode requires model.cfg.pcilt (a configs.base."
            "PCILTConfig supplying act_bits/group for the table build)")
    if head is not None and head != "shared":
        raise ValueError(f"head= accepts None or 'shared', got {head!r}")
    t = {} if timings is None else timings
    spec = QuantSpec(bits=cfg.pcilt.act_bits, symmetric=True)

    def lap(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t[name] = time.perf_counter() - t0

    from repro_torch.nn.module import Placed

    placed = isinstance(params["embed"]["embedding"], Placed)
    if placed and (ctx is None or ctx.mesh is None):
        raise ValueError("placed parameters need the ctx of their mesh")
    t0 = time.perf_counter()
    with torch.no_grad():
        amax = model.calibrate_pcilt(params, {"tokens": calib_tokens.to(dev)},
                                     ctx=ctx if placed else None)
    lap("calibrate_s", t0)

    def to_scale(a):
        return scale_from_amax(a.float(), spec).cpu()

    proj_scales = None
    if cfg.pcilt.apply_to_gemv:
        proj_scales = {"in": to_scale(amax["in"]), "out": to_scale(amax["out"])}
    t0 = time.perf_counter()
    with torch.no_grad():
        pcilt = model.build_pcilt(
            params, to_scale(amax["conv_in"]), proj_scales=proj_scales,
            table_dtype=table_dtype,
            head_scale=to_scale(amax["head_in"]) if head == "shared" else None,
            record_integrity=False, paired=paired, mesh=mesh,
            mesh_axis=mesh_axis)
    lap("build_s", t0)
    t0 = time.perf_counter()
    pcilt["integrity"] = pcilt_integrity(pcilt)
    lap("crc_record_s", t0)
    t0 = time.perf_counter()
    dec = PCILTMambaDecode(model, pcilt, ctx=ctx, verify=True)
    lap("verify_s", t0)
    return dec


class _TabledLayer:
    """What a converted linear or conv layer holds: dense grouped tables
    ``[G, V, O]`` and/or an extension-3 shared pool.  A shared-only layer
    runs ``"shared"`` or ``"gather"``; a dense-only one every other path.
    With ``mesh=`` the layer is tensor parallel: at construction (the
    offline step) the dense tables are cut into ``[G/D, V, O]`` blocks on
    the mesh axis's devices and the pool into a ``ShardedSharedPool``
    (``shard_pools``; the global pool stays as ``shared``); a mesh axis that
    does not divide ``G`` replicates."""

    def __init__(self, tables: Optional[torch.Tensor],
                 shared: Optional[SharedGroupedTables], mesh=None,
                 mesh_axis: str = "model"):
        if tables is None and shared is None:
            raise ValueError(f"{type(self).__name__} needs dense tables, a "
                             f"shared pool, or both")
        self.tables = tables
        self.shared = shared
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.shard_pools: Optional[ShardedSharedPool] = None
        D = self.shard_count
        if D > 1:
            if shared is not None:
                self.shard_pools = _place_sharded_pool(
                    shard_shared_grouped_tables(shared, D), mesh, mesh_axis)
            if tables is not None:
                from repro_torch.nn.module import pcilt_table_sharding

                self.tables = ShardedTables.place(tables, pcilt_table_sharding(
                    mesh, tables.shape[0], mesh_axis=mesh_axis))

    @property
    def n_segments(self) -> int:
        if self.tables is not None:
            return self.tables.shape[0]
        return self.shared.n_segments

    @property
    def shard_count(self) -> int:
        """Segment shards on the layer's mesh (1: replicated)."""
        return mesh_shard_count(self.mesh, self.mesh_axis, self.n_segments)

    def table_bytes(self) -> int:
        """Bytes of the representation this layer deploys (the shared pool
        when present)."""
        if self.shared is not None:
            return self.shared.pool_bytes()
        return _nbytes(self.tables)

    def per_device_table_bytes(self) -> int:
        """Table bytes each device holds under the layer's mesh: the padded
        local pool of a shared layer, ``1/D`` of the dense tables, all of
        them when replicated."""
        if self.shard_pools is not None:
            return self.shard_pools.local_pool_bytes()
        return -(-self.table_bytes() // self.shard_count)

    def _tables_for(self, path: str):
        if path == "shared" or (self.tables is None and path == "gather"):
            if self.shared is None:
                raise ValueError(
                    "no shared pool on this layer; convert with shared=True")
            return self.shard_pools if self.shard_pools is not None \
                else self.shared
        if self.tables is None:
            raise ValueError(
                f"shared-only {type(self).__name__} executes path='shared' "
                f"or 'gather', not {path!r}")
        return self.tables


class PCILTLinear(_TabledLayer):
    """A converted projection: dense grouped tables ``[G, V, O]`` and/or an
    extension-3 shared pool, plus the activation quantizer.  A call runs
    :func:`~repro_torch.core.lut_layers.pcilt_linear` on one path
    (``"fused"`` is one kernel launch; under a mesh one a shard, then the
    reduction)."""

    def __init__(self, tables: Optional[torch.Tensor], spec: QuantSpec,
                 scale, group: int,
                 shared: Optional[SharedGroupedTables] = None, mesh=None,
                 mesh_axis: str = "model"):
        #: conversion-time CRC-32 record (before placement, which moves
        #: bytes and never rewrites them), verified by verify_integrity
        self.integrity: Dict[str, int] = {}
        if tables is not None:
            self.integrity["tables"] = table_checksum(tables)
        if shared is not None:
            self.integrity["pool"] = table_checksum(shared.pool)
            self.integrity["seg_idx"] = table_checksum(shared.seg_idx)
        super().__init__(tables, shared, mesh, mesh_axis)
        self.spec = spec
        self.scale = scale
        self.group = group

    def verify_integrity(self) -> Dict[str, bool]:
        """Each held table's checksum against the conversion-time record
        (sharded tables: their shards' CRCs chained); False marks a
        corrupted one."""
        cur = {}
        if self.tables is not None:
            cur["tables"] = table_checksum(self.tables)
        if self.shared is not None:
            cur["pool"] = table_checksum(self.shared.pool)
            cur["seg_idx"] = table_checksum(self.shared.seg_idx)
        return {k: cur[k] == v for k, v in self.integrity.items()}

    def _pad_x(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.n_segments * self.group - x.shape[-1]
        if pad:  # group-alignment slots: table rows built from zero weights
            x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], -1)
        return x

    def __call__(self, x: torch.Tensor, path: str = "gather") -> torch.Tensor:
        return pcilt_linear(self._pad_x(x), self._tables_for(path), self.spec,
                            self.scale, self.group, path=path,
                            mesh=self.mesh, mesh_axis=self.mesh_axis)

    def tune(self, x: torch.Tensor) -> torch.Tensor:
        """Tune the fused kernel's design at this shape (the shared-pool
        kernel's for a shared-only layer) and record the winner in the
        design cache; returns the output.  Under a mesh it tunes one
        shard's local shape (its ``[G/D, V, O]`` block or local pool against
        its slice of ``x``), the key every shard's launch looks up."""
        from repro_torch.kernels import ops

        x = self._pad_x(x)
        flat = x.reshape(-1, x.shape[-1])
        D = self.shard_count
        if D > 1:
            xl = flat[:, :self.n_segments // D * self.group]
            if self.tables is None:
                sp = self.shard_pools
                ops.pcilt_shared_gemv(
                    xl.to(sp.pools[0].device).contiguous(), sp.pools[0],
                    sp.seg_idx[0], self.spec, _f32(self.scale), self.group,
                    autotune=True)
                return self(x, path="shared")
            t0 = self.tables.shards[0]
            ops.pcilt_fused_gemv(xl.to(t0.device).contiguous(), t0, self.spec,
                                 _f32(self.scale), self.group, autotune=True)
            return self(x, path="fused")
        if self.tables is None:
            out = ops.pcilt_shared_gemv(flat, self.shared.pool,
                                        self.shared.seg_idx, self.spec,
                                        _f32(self.scale), self.group,
                                        autotune=True)
        else:
            out = ops.pcilt_fused_gemv(flat, self.tables, self.spec,
                                       _f32(self.scale), self.group,
                                       autotune=True)
        return out.reshape(*x.shape[:-1], out.shape[-1])


def _quantize_weights(k: torch.Tensor, weight_bits: Optional[int]):
    """With ``weight_bits``, the weights on a symmetric absmax grid
    (fewer distinct values, the precondition of extension-3 sharing)."""
    if not weight_bits:
        return k
    wspec = QuantSpec(bits=weight_bits, symmetric=True)
    wscale = calibrate(k, wspec)
    return dequantize(quantize(k, wspec, wscale), wspec, wscale)


def convert_kernel(kernel: torch.Tensor, act_spec: QuantSpec, act_scale,
                   group: int, weight_bits: Optional[int] = None,
                   shared: bool = False, mesh=None,
                   mesh_axis: str = "model") -> PCILTLinear:
    """Offline build for one ``[d_in, d_out]`` kernel, on the kernel's
    device: with ``weight_bits`` the weights are first quantized; the
    reduction dim is aligned to ``group`` with zero weights, and the dense
    grouped tables (or with ``shared`` the segment-deduplicated pool) are
    built once; with ``mesh`` they are sharded over ``mesh_axis`` then (the
    offline step)."""
    k = kernel.float()
    if kernel.dim() > 2:
        k = k.reshape(kernel.shape[0], -1)
    k = _quantize_weights(k, weight_bits)
    n, out = k.shape
    pad = (-n) % group
    if pad:
        k = torch.cat([k, k.new_zeros((pad, out))], 0)
    with torch.no_grad():
        if shared:
            pool = build_shared_grouped_tables(k, act_spec, act_scale, group)
            return PCILTLinear(None, act_spec, act_scale, group, shared=pool,
                               mesh=mesh, mesh_axis=mesh_axis)
        tables = build_grouped_tables(k, act_spec, act_scale, group)
    return PCILTLinear(tables, act_spec, act_scale, group, mesh=mesh,
                       mesh_axis=mesh_axis)


class PCILTDwConv1d:
    """A converted depthwise-conv1d frontend: the ``[C, V]`` per-channel
    tables are built once and every call makes one fetch per output
    (``"fused"``: quantize, tap-stack, pack and fetch in one kernel;
    ``"kernel"``: host-packed offsets through the host-packed kernel;
    ``"gather"``/``"onehot"``: the reference fetches)."""

    def __init__(self, filters: torch.Tensor, spec: QuantSpec, scale,
                 tables: Optional[torch.Tensor] = None):
        self.filters = filters
        self.spec = spec
        self.scale = scale
        self.k = int(filters.shape[0])
        if tables is None:
            with torch.no_grad():
                tables = build_dwconv_tables(filters, spec, scale)
        self.tables = tables

    def table_bytes(self) -> int:
        return _nbytes(self.tables)

    def __call__(self, x: torch.Tensor, path: str = "fused",
                 padding: str = "CAUSAL") -> torch.Tensor:
        return pcilt_depthwise_conv1d(x, self.filters, self.spec, self.scale,
                                      tables=self.tables, path=path,
                                      padding=padding)

    def tune(self, x: torch.Tensor, padding: str = "CAUSAL") -> torch.Tensor:
        """Tune the fused dwconv's design at this shape and record it;
        returns the output."""
        from repro_torch.kernels import ops

        return ops.pcilt_fused_dwconv1d(x, self.tables, self.spec,
                                        _f32(self.scale), self.k,
                                        padding=padding, autotune=True)


def convert_dwconv(filters: torch.Tensor, act_spec: QuantSpec,
                   act_scale) -> PCILTDwConv1d:
    """Offline build for one ``[k, C]`` depthwise-conv1d filter: per-channel
    ``[C, 2**(bits*k)]`` tables, built once on the filter's device."""
    return PCILTDwConv1d(filters, act_spec, act_scale)


def pcilt_apply(lin: PCILTLinear, x: torch.Tensor, path: str = "gather"):
    return lin(x, path=path)


def mlp_table_bytes(d_model: int, d_ff: int, act_bits: int, group: int,
                    value_bytes: int = 2) -> int:
    """Per-layer table memory of a gated MLP (3 kernels): each ``[n, out]``
    kernel becomes ``[n/group, 2**(bits*group), out]`` tables."""
    V = 1 << (act_bits * group)
    gate_up = 2 * (d_model // group) * V * d_ff * value_bytes
    down = (d_ff // group) * V * d_model * value_bytes
    return gate_up + down


class PCILTConv2d(_TabledLayer):
    """A converted convolution: the filter with its pre-built dense tables
    and/or extension-3 pool.  ``layer(x, path)`` runs
    :func:`~repro_torch.core.lut_layers.pcilt_conv2d` on them (default
    ``"fused"``); under a mesh the conv kernels keep their in-kernel im2col
    on every shard (``seg_offset``)."""

    def __init__(self, filters: torch.Tensor, spec: QuantSpec, scale,
                 group: int, stride: int = 1, padding: str = "SAME",
                 tables: Optional[torch.Tensor] = None,
                 shared: Optional[SharedGroupedTables] = None, mesh=None,
                 mesh_axis: str = "model"):
        super().__init__(tables, shared, mesh, mesh_axis)
        self.filters = filters
        self.spec = spec
        self.scale = scale
        self.group = group
        self.stride = stride
        self.padding = padding

    def __call__(self, x: torch.Tensor, path: str = "fused") -> torch.Tensor:
        return pcilt_conv2d(x, self.filters, self.spec, self.scale,
                            self.group, stride=self.stride,
                            padding=self.padding,
                            tables=self._tables_for(path), path=path,
                            mesh=self.mesh, mesh_axis=self.mesh_axis)

    def tune(self, x: torch.Tensor) -> torch.Tensor:
        """Tune the conv kernel's design at this input shape (the
        shared-pool kernel's for a shared-only layer) and record it;
        returns the output.  Under a mesh it tunes shard 0's local shape
        (``seg_offset=0``): the key every shard's launch looks up."""
        from repro_torch.kernels import ops

        kh, kw = self.filters.shape[:2]
        kw_args = dict(stride=self.stride, padding=self.padding,
                       autotune=True)
        if self.shard_count > 1:
            kw_args["n_total"] = self.n_segments * self.group
            if self.tables is None:
                sp = self.shard_pools
                ops.pcilt_shared_conv2d(x.to(sp.pools[0].device), sp.pools[0],
                                        sp.seg_idx[0], self.spec,
                                        _f32(self.scale), self.group, kh, kw,
                                        **kw_args)
                return self(x, path="shared")
            t0 = self.tables.shards[0]
            ops.pcilt_fused_conv2d(x.to(t0.device), t0, self.spec,
                                   _f32(self.scale), self.group, kh, kw,
                                   **kw_args)
            return self(x, path="fused")
        if self.tables is None:
            ops.pcilt_shared_conv2d(x, self.shared.pool, self.shared.seg_idx,
                                    self.spec, _f32(self.scale), self.group,
                                    kh, kw, **kw_args)
            return self(x, path="shared")
        ops.pcilt_fused_conv2d(x, self.tables, self.spec, _f32(self.scale),
                               self.group, kh, kw, **kw_args)
        return self(x, path="fused")


def convert_conv_kernel(filters: torch.Tensor, act_spec: QuantSpec, act_scale,
                        group: int, stride: int = 1, padding: str = "SAME",
                        weight_bits: Optional[int] = None,
                        shared: bool = False, mesh=None,
                        mesh_axis: str = "model") -> PCILTConv2d:
    """Offline build for one ``[kh, kw, Cin, Cout]`` filter, on the
    filter's device: with ``weight_bits`` the filter is first quantized on
    a symmetric absmax grid; the receptive field is flattened and aligned
    to the segment grid once, and the dense tables (or with ``shared`` the
    segment-deduplicated pool) are built once; with ``mesh`` they are
    sharded over ``mesh_axis`` then."""
    f = _quantize_weights(filters.float(), weight_bits)
    wflat = flatten_filters(f, group)
    with torch.no_grad():
        if shared:
            pool = build_shared_grouped_tables(wflat, act_spec, act_scale,
                                               group)
            return PCILTConv2d(f, act_spec, act_scale, group, stride=stride,
                               padding=padding, shared=pool, mesh=mesh,
                               mesh_axis=mesh_axis)
        tables = build_grouped_tables(wflat, act_spec, act_scale, group)
    return PCILTConv2d(f, act_spec, act_scale, group, stride=stride,
                       padding=padding, tables=tables, mesh=mesh,
                       mesh_axis=mesh_axis)
