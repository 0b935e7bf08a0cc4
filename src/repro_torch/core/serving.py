"""PCILT serving conversion (port of parts of ``repro.core.serving``): the
Mamba decode path and the converted single layers.

:class:`PCILTLinear` / :func:`convert_kernel` convert one ``[d_in, d_out]``
projection (dense grouped tables and/or an extension-3 pool) and
:class:`PCILTDwConv1d` / :func:`convert_dwconv` one depthwise-conv1d
frontend; each call runs one fetch path.

:class:`PCILTConv2d` / :func:`convert_conv_kernel` hoist a convolution's
table build out of serving: the filter is flattened and aligned to the
segment grid and its dense tables (or, with ``shared=True``, its
extension-3 pool) are built once; a call runs one fetch path.  Unsharded,
without the reference's ``tune`` (no autotune cache in the port yet).

:func:`convert_mamba_decode` is the once-per-lifetime build: calibrate on a
prefill pass, build the conv, projection and head tables, record their
CRC-32s, and wrap the bundle in a :class:`PCILTMambaDecode` that verifies the
record at load; ``paired=True`` builds segment-major paired projection
stacks (two segments per fetch).  The health monitor, recalibration and the checkpoint ring
of the reference wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .lut_layers import (build_dwconv_tables, flatten_filters, pcilt_conv2d,
                         pcilt_depthwise_conv1d, pcilt_linear)
from .pcilt import (SharedGroupedTables, build_grouped_tables,
                    build_shared_grouped_tables, layer_checksum,
                    stacked_checksums, table_checksum)
from .quantization import (QuantSpec, calibrate, dequantize, quantize,
                           scale_from_amax)

__all__ = ["pcilt_integrity", "PCILTMambaDecode", "convert_mamba_decode",
           "PCILTLinear", "convert_kernel", "PCILTConv2d",
           "convert_conv_kernel", "PCILTDwConv1d", "convert_dwconv",
           "pcilt_apply", "mlp_table_bytes"]


def _proj_axis(proj: Dict) -> int:
    """The layer axis of a bundle's projection stacks: 0 for layer-major
    ``[L, G, V, O]``, 1 for segment-major paired ``[G2, L, V2, O]``."""
    return 1 if proj.get("paired") else 0


def pcilt_integrity(pcilt: Dict) -> Dict:
    """Conversion-time CRC-32 record of every table of a Mamba PCILT bundle,
    per layer for the stacked arrays (the same record, byte for byte, as
    the reference's for the same tables)."""
    integ: Dict[str, Any] = {"conv": stacked_checksums(pcilt["tables"])}
    proj = pcilt.get("proj")
    if proj is not None:
        axis = _proj_axis(proj)
        integ["proj"] = {name: stacked_checksums(t, axis)
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
            axis = _proj_axis(proj)
            for name, t in proj["tables"].items():
                if layer_checksum(t, layer, axis) != \
                        integ["proj"][name][layer]:
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
            got[name] = stacked_checksums(proj["tables"][name],
                                          _proj_axis(proj))
        bad: List[Tuple] = []
        for l in range(len(got["conv"])):
            if got["conv"][l] != integ["conv"][l]:
                bad.append(("conv", l))
            bad.extend((name, l) for name in names
                       if got[name][l] != integ["proj"][name][l])
        return bad + self.verify_head()

    def table_bytes(self) -> int:
        """Bytes of the conv and projection stacks (the reference's count;
        the head's pool is not included)."""
        total = _nbytes(self.pcilt["tables"])
        proj = self.pcilt.get("proj")
        if proj is not None:
            total += sum(_nbytes(t) for t in proj["tables"].values())
        return total


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def convert_mamba_decode(model, params, calib_tokens: torch.Tensor, *,
                         table_dtype=torch.float32, paired: bool = False,
                         head: Optional[str] = None,
                         timings: Optional[Dict[str, float]] = None,
                         device="cuda") -> PCILTMambaDecode:
    """Offline full-PCILT conversion of a ``MambaLM`` decode step on
    ``device`` (where ``params`` must lie): calibrate on ``calib_tokens
    [B, S]``, build the conv and projection stacks (segment-major paired
    stacks with ``paired``; with ``head="shared"`` also the shared-pool
    head), record the CRC-32s, verify them at load.  With ``timings`` (a
    dict) the seconds of each phase are stored there."""
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
            record_integrity=False, paired=paired)
    lap("build_s", t0)
    t0 = time.perf_counter()
    pcilt["integrity"] = pcilt_integrity(pcilt)
    lap("crc_record_s", t0)
    t0 = time.perf_counter()
    dec = PCILTMambaDecode(model, pcilt, verify=True)
    lap("verify_s", t0)
    return dec


class _TabledLayer:
    """What a converted linear or conv layer holds: dense grouped tables
    ``[G, V, O]`` and/or an extension-3 shared pool.  A shared-only layer
    runs ``"shared"`` or ``"gather"``; a dense-only one every other path."""

    def __init__(self, tables: Optional[torch.Tensor],
                 shared: Optional[SharedGroupedTables]):
        if tables is None and shared is None:
            raise ValueError(f"{type(self).__name__} needs dense tables, a "
                             f"shared pool, or both")
        self.tables = tables
        self.shared = shared

    @property
    def n_segments(self) -> int:
        if self.tables is not None:
            return self.tables.shape[0]
        return self.shared.n_segments

    def table_bytes(self) -> int:
        """Bytes of the representation this layer deploys (the shared pool
        when present)."""
        if self.shared is not None:
            return self.shared.pool_bytes()
        return _nbytes(self.tables)

    def _tables_for(self, path: str):
        if path == "shared" or (self.tables is None and path == "gather"):
            if self.shared is None:
                raise ValueError(
                    "no shared pool on this layer; convert with shared=True")
            return self.shared
        if self.tables is None:
            raise ValueError(
                f"shared-only {type(self).__name__} executes path='shared' "
                f"or 'gather', not {path!r}")
        return self.tables


class PCILTLinear(_TabledLayer):
    """A converted projection: dense grouped tables ``[G, V, O]`` and/or an
    extension-3 shared pool, plus the activation quantizer.  A call runs
    :func:`~repro_torch.core.lut_layers.pcilt_linear` on one path
    (``"fused"`` is one kernel launch).  Unsharded, without the reference's
    ``tune``."""

    def __init__(self, tables: Optional[torch.Tensor], spec: QuantSpec,
                 scale, group: int,
                 shared: Optional[SharedGroupedTables] = None):
        super().__init__(tables, shared)
        self.spec = spec
        self.scale = scale
        self.group = group
        #: conversion-time CRC-32 record, verified by verify_integrity
        self.integrity: Dict[str, int] = {}
        if tables is not None:
            self.integrity["tables"] = table_checksum(tables)
        if shared is not None:
            self.integrity["pool"] = table_checksum(shared.pool)
            self.integrity["seg_idx"] = table_checksum(shared.seg_idx)

    def verify_integrity(self) -> Dict[str, bool]:
        """Each held table's checksum against the conversion-time record;
        False marks a corrupted one."""
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
                            self.scale, self.group, path=path)


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
                   shared: bool = False) -> PCILTLinear:
    """Offline build for one ``[d_in, d_out]`` kernel, on the kernel's
    device: with ``weight_bits`` the weights are first quantized; the
    reduction dim is aligned to ``group`` with zero weights, and the dense
    grouped tables (or with ``shared`` the segment-deduplicated pool) are
    built once."""
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
            return PCILTLinear(None, act_spec, act_scale, group, shared=pool)
        tables = build_grouped_tables(k, act_spec, act_scale, group)
    return PCILTLinear(tables, act_spec, act_scale, group)


class PCILTDwConv1d:
    """A converted depthwise-conv1d frontend: the ``[C, V]`` per-channel
    tables are built once and every call makes one fetch per output
    (``"fused"``: quantize, tap-stack, pack and fetch in one kernel;
    ``"kernel"``: host-packed offsets through the host-packed kernel;
    ``"gather"``/``"onehot"``: the reference fetches).  Without the
    reference's ``tune``."""

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
    ``"fused"``)."""

    def __init__(self, filters: torch.Tensor, spec: QuantSpec, scale,
                 group: int, stride: int = 1, padding: str = "SAME",
                 tables: Optional[torch.Tensor] = None,
                 shared: Optional[SharedGroupedTables] = None):
        super().__init__(tables, shared)
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
    f = _quantize_weights(filters.float(), weight_bits)
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
