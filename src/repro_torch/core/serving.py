"""PCILT serving conversion (port of parts of ``repro.core.serving``): the
Mamba decode path and the converted conv2d layer.

:class:`PCILTConv2d` / :func:`convert_conv_kernel` hoist a convolution's
table build out of serving: the filter is flattened and aligned to the
segment grid and its dense tables (or, with ``shared=True``, its
extension-3 pool) are built once; a call runs one fetch path.  Unsharded,
without the reference's ``tune`` (no autotune cache in the port yet).

:func:`convert_mamba_decode` is the once-per-lifetime build: calibrate on a
prefill pass, build the conv, projection and head tables, record their
CRC-32s, and wrap the bundle in a :class:`PCILTMambaDecode` that verifies the
record at load.  The health monitor, recalibration and the checkpoint ring
of the reference wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .lut_layers import flatten_filters, pcilt_conv2d
from .pcilt import (SharedGroupedTables, build_grouped_tables,
                    build_shared_grouped_tables, stacked_checksums,
                    table_checksum)
from .quantization import (QuantSpec, calibrate, dequantize, quantize,
                           scale_from_amax)

__all__ = ["pcilt_integrity", "PCILTMambaDecode", "convert_mamba_decode",
           "PCILTConv2d", "convert_conv_kernel"]


def pcilt_integrity(pcilt: Dict) -> Dict:
    """Conversion-time CRC-32 record of every table of a Mamba PCILT bundle,
    per layer for the stacked arrays (the same record, byte for byte, as
    the reference's for the same tables)."""
    integ: Dict[str, Any] = {"conv": stacked_checksums(pcilt["tables"])}
    proj = pcilt.get("proj")
    if proj is not None:
        integ["proj"] = {name: stacked_checksums(t)
                         for name, t in proj["tables"].items()}
    head = pcilt.get("head")
    if head is not None:
        integ["head"] = {"pool": table_checksum(head["pool"]),
                         "seg_idx": table_checksum(head["seg_idx"])}
    return integ


class PCILTMambaDecode:
    """A converted Mamba decode path: the bundle plus its step.

    ``step(params, cache, tokens, layer_ok, head_ok, with_stats)`` mirrors
    ``MambaLM.decode_step``; ``layer_ok``/``head_ok`` are host bools
    (all-healthy by default).  The bundle's integrity record is verified at
    load (``verify=True``) and on demand."""

    def __init__(self, model, pcilt: Dict, verify: bool = True):
        self.model = model
        self.pcilt = pcilt
        if "integrity" not in pcilt:
            pcilt["integrity"] = pcilt_integrity(pcilt)
        if verify:
            bad = self.verify_integrity()
            if bad:
                raise RuntimeError(
                    f"PCILT bundle failed integrity verification at load "
                    f"(corrupted tables): {bad}")

    def step(self, params, cache, tokens, layer_ok=None, head_ok=None,
             with_stats: bool = False):
        return self.model.decode_step(params, cache, tokens, pcilt=self.pcilt,
                                      layer_ok=layer_ok, head_ok=head_ok,
                                      with_stats=with_stats)

    def verify_layer(self, layer: int) -> List[Tuple]:
        """Checksum one layer's conv + projection tables against the record;
        returns the breached ``(name, layer)`` sites (empty = clean)."""
        integ = self.pcilt["integrity"]
        bad: List[Tuple] = []
        if table_checksum(self.pcilt["tables"][layer]) != integ["conv"][layer]:
            bad.append(("conv", int(layer)))
        proj = self.pcilt.get("proj")
        if proj is not None:
            for name, t in proj["tables"].items():
                if table_checksum(t[layer]) != integ["proj"][name][layer]:
                    bad.append((name, int(layer)))
        return bad

    def verify_head(self) -> List[Tuple]:
        """Checksum the shared-pool head (pool values + pointers)."""
        head = self.pcilt.get("head")
        if head is None:
            return []
        integ = self.pcilt["integrity"]["head"]
        bad: List[Tuple] = []
        if table_checksum(head["pool"]) != integ["pool"]:
            bad.append(("head.pool",))
        if table_checksum(head["seg_idx"]) != integ["seg_idx"]:
            bad.append(("head.seg_idx",))
        return bad

    def verify_integrity(self) -> List[Tuple]:
        """Every layer of every stack plus the head; returns all breached
        sites, layer by layer as :meth:`verify_layer` orders them."""
        integ = self.pcilt["integrity"]
        got = {"conv": stacked_checksums(self.pcilt["tables"])}
        proj = self.pcilt.get("proj")
        names = list(proj["tables"]) if proj is not None else []
        for name in names:
            got[name] = stacked_checksums(proj["tables"][name])
        bad: List[Tuple] = []
        for l in range(len(got["conv"])):
            if got["conv"][l] != integ["conv"][l]:
                bad.append(("conv", l))
            bad.extend((name, l) for name in names
                       if got[name][l] != integ["proj"][name][l])
        return bad + self.verify_head()

    def table_bytes(self) -> int:
        """Bytes of every table the converted decode deploys."""
        def nbytes(t):
            return t.numel() * t.element_size()

        total = nbytes(self.pcilt["tables"])
        proj = self.pcilt.get("proj")
        if proj is not None:
            total += sum(nbytes(t) for t in proj["tables"].values())
        head = self.pcilt.get("head")
        if head is not None:
            total += nbytes(head["pool"]) + nbytes(head["seg_idx"])
        return total


def convert_mamba_decode(model, params, calib_tokens: torch.Tensor, *,
                         table_dtype=torch.float32,
                         head: Optional[str] = None,
                         timings: Optional[Dict[str, float]] = None,
                         device="cuda") -> PCILTMambaDecode:
    """Offline full-PCILT conversion of a ``MambaLM`` decode step on
    ``device`` (where ``params`` must lie): calibrate on ``calib_tokens
    [B, S]``, build the conv and projection stacks (and with
    ``head="shared"`` the shared-pool head), record the CRC-32s, verify them
    at load.  With ``timings`` (a dict) the seconds of each phase are stored
    there."""
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

    t0 = time.perf_counter()
    with torch.no_grad():
        amax = model.calibrate_pcilt(params, calib_tokens.to(dev))
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
            record_integrity=False)
    lap("build_s", t0)
    t0 = time.perf_counter()
    pcilt["integrity"] = pcilt_integrity(pcilt)
    lap("crc_record_s", t0)
    t0 = time.perf_counter()
    dec = PCILTMambaDecode(model, pcilt, verify=True)
    lap("verify_s", t0)
    return dec


class PCILTConv2d:
    """A converted convolution: the filter with its pre-built dense tables
    and/or extension-3 pool.  ``layer(x, path)`` runs
    :func:`~repro_torch.core.lut_layers.pcilt_conv2d` on them (default
    ``"fused"``); a shared-only layer runs ``"shared"`` or ``"gather"``."""

    def __init__(self, filters: torch.Tensor, spec: QuantSpec, scale,
                 group: int, stride: int = 1, padding: str = "SAME",
                 tables: Optional[torch.Tensor] = None,
                 shared: Optional[SharedGroupedTables] = None):
        if tables is None and shared is None:
            raise ValueError("PCILTConv2d needs dense tables, a shared pool, "
                             "or both")
        self.filters = filters
        self.spec = spec
        self.scale = scale
        self.group = group
        self.stride = stride
        self.padding = padding
        self.tables = tables
        self.shared = shared

    @property
    def n_segments(self) -> int:
        if self.tables is not None:
            return self.tables.shape[0]
        return self.shared.n_segments

    def _tables_for(self, path: str):
        if path == "shared" or (self.tables is None and path == "gather"):
            if self.shared is None:
                raise ValueError(
                    "no shared pool on this layer; convert with shared=True")
            return self.shared
        if self.tables is None:
            raise ValueError(
                f"shared-only PCILTConv2d executes path='shared' or "
                f"'gather', not {path!r}")
        return self.tables

    def table_bytes(self) -> int:
        if self.shared is not None:
            return self.shared.pool_bytes()
        return self.tables.numel() * self.tables.element_size()

    def __call__(self, x: torch.Tensor, path: str = "fused") -> torch.Tensor:
        return pcilt_conv2d(x, self.filters, self.spec, self.scale,
                            self.group, stride=self.stride,
                            padding=self.padding,
                            tables=self._tables_for(path), path=path)


def convert_conv_kernel(filters: torch.Tensor, act_spec: QuantSpec, act_scale,
                        group: int, stride: int = 1, padding: str = "SAME",
                        weight_bits: Optional[int] = None,
                        shared: bool = False) -> PCILTConv2d:
    """Offline build for one ``[kh, kw, Cin, Cout]`` filter, on the
    filter's device: with ``weight_bits`` the filter is first quantized on
    a symmetric absmax grid; the receptive field is flattened and aligned
    to the segment grid once, and the dense tables (or with ``shared`` the
    segment-deduplicated pool) are built once."""
    f = filters.float()
    if weight_bits:
        wspec = QuantSpec(bits=weight_bits, symmetric=True)
        wscale = calibrate(f, wspec)
        f = dequantize(quantize(f, wspec, wscale), wspec, wscale)
    wflat = flatten_filters(f, group)
    with torch.no_grad():
        if shared:
            pool = build_shared_grouped_tables(wflat, act_spec, act_scale,
                                               group)
            return PCILTConv2d(f, act_spec, act_scale, group, stride=stride,
                               padding=padding, shared=pool)
        tables = build_grouped_tables(wflat, act_spec, act_scale, group)
    return PCILTConv2d(f, act_spec, act_scale, group, stride=stride,
                       padding=padding, tables=tables)
