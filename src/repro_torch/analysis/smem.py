"""Static Hopper resource verifier for the port's CUDA kernels (the
counterpart of ``repro.analysis.vmem``).

The reference proves its Pallas kernels' VMEM budgets by tracing them.
The port's CUDA designs have budgets of their own that tests exercise
only at the shapes a run launches: 227 KiB of dynamic shared memory a
block (``kernels.ops.SMEM_LIMIT``), grids of at most 65535 rows, clusters
of up to 16 blocks, the registers and shared memory of one SM.  This pass
checks them for every design ``kernels.ops`` admits over a recorded sweep
of shapes, and never launches a kernel (a design the wrapper refuses
with a ``ValueError`` at a shape is counted, not checked: it launches
nothing there).  Each family below is a design
model of ``kernels.ops`` (the ``*_variant``, ``*_smem_bytes``,
``*_candidates``, ``*_tiles`` and ``*_plan`` mirrors of the CUDA sources)
plus the launch geometry each design's host code in ``kernels/csrc``
gives (the source and its launch function named beside each):

* ``gemv`` — the fused GEMV, kernels 1 and 8–11
  (``pcilt_gemv_stacked.cu``): the split design (``gemv_variant``,
  ``gemv_grid``, ``gemv_slab``, ``gemv_smem_bytes``: the row chunks past
  65535 on further planes of the grid, a block's segments staged slab by
  slab) and the direct one;
* ``gemv_staged`` — kernel 9's staged design (``pcilt_gemv_staged.cu``)
  where its ``V`` admits it (``gemv_staged_plan``, ``gemv_staged_grid``,
  ``gemv_staged_slab``, ``gemv_staged_smem_bytes``: a row tile's offsets
  staged slab by slab, the row tiles past 65535 on further planes), from
  1 to 8,388,609 rows;
* ``shared_gemv`` — the split head GEMV, kernel 3 (``shared_gemv_*``: at
  most 65535 rows of blocks, each walking its row chunks, and slabs);
* ``dwconv`` — the tiled fused dwconv, kernel 2 (``dwconv_tiled_grid``),
  and the direct one;
* ``dwconv_host`` — the staged host-packed dwconv, kernel 12
  (``dwconv_host_tiling``), and the direct one;
* ``conv`` — the staged conv, kernels 4 and 5 (``staged_smem_bytes``,
  ``staged_block_tile``, the code pre-pass), and the direct one;
* ``gemv_host`` — the host-packed GEMV and conv, kernels 6 and 7: the
  split design (kernel 9's split, ``pcilt_split.cuh``: ``gemv_variant``,
  ``gemv_grid``, ``gemv_slab``, ``gemv_smem_bytes`` over the rows), the
  staged one (``gemv_host_smem_bytes``, ``gemv_host_block_tile``) and the
  direct one;
* ``crc`` — the CRC-32 of the tables: its chunk pass (the banked design
  and the kept one) and combine passes.

The sweeps: ``quick`` holds the shapes of ``PERF.md``'s kernel table (the
mamba2-130m decode at B = 4 and 1, qwen3-0.6b's gate, the head, the [4,
2048, 1792] dwconv signal, the paper CNN at 1024x768, a layer's and the
head's CRC); ``full`` adds every registered config's widths at B = 1 to 64
(the dense kernels of its parameter specs, its head, its SSM conv) and
the paper CNN at B = 1 to 64, and the split GEMVs at the shapes past the
grid's rows and a 16-block cluster (``CEILING_GEMV``,
``CEILING_SHARED``).

Rules:

* **SMEM001** (error) — an admitted design models more dynamic shared
  memory than the budget (``SMEM_LIMIT``; ``smem_budget`` overrides it,
  and a shrunk budget must make the rule fire: the pass is not vacuous);
* **SMEM002** (error) — launch limits: ``gridDim.x`` below 2**31, ``.y``
  and ``.z`` at most 65535, at most 1024 threads a block and no more than
  the kernel's ``__launch_bounds__``, a cluster of at most 16 blocks that
  divides ``gridDim.x``, and more than 8 only where the source (or a
  header of ``kernels/csrc`` it includes) sets
  ``cudaFuncAttributeNonPortableClusterSizeAllowed``;
* **SMEM003** (error) — coverage: a design's tiles cover every output row
  and column (and a split's slices every segment) with no gap, and with no
  overlap (no design here writes with atomics);
* **SMEM004** (error) — model drift: given the built libraries, their
  ``*_config`` constants and ``*_plan`` results against the models over
  the whole sweep; given the ``ptxas`` reports, every modelled kernel is
  in its library's report, its static shared memory is the model's
  (``STATIC_SMEM``), and every admitted launch fits it (static plus
  dynamic shared memory within ``SMEM_LIMIT``, registers times threads
  within an SM's 65536); and each kernel's ``__launch_bounds__`` text in
  its source is the model's;
* **SMEM005** (error) — the heuristic's design (``candidates()[0]``) fits
  one SM at the occupancy its ``__launch_bounds__`` asks for: that many
  blocks of shared memory (dynamic, static and the 1 KiB the driver keeps
  a block) within 228 KiB, and of registers times threads (given a report)
  within 65536;
* **SMEM006** (warning) — a ``ptxas`` report shows spill stores or loads.

:func:`verify_all` takes the libraries and reports injected (a library is
any object with the ``ctypes`` entry points; a report is ``nvcc -Xptxas
-v`` text), so the CPU tests run every rule without a card;
``chip_smoke.py`` phase 26 passes the built ones (``kernels.build``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis import Finding

__all__ = ["RULES", "FAMILIES", "KERNELS", "STATIC_SMEM", "Launch",
           "Family", "verify_all", "parse_report", "SM_REGISTERS"]

RULES: Dict[str, str] = {
    "SMEM001": "an admitted design models more dynamic shared memory than "
               "SMEM_LIMIT (or --smem-budget)",
    "SMEM002": "a launch exceeds a grid, block, __launch_bounds__ or "
               "cluster limit",
    "SMEM003": "a design's tiles or slices leave a gap in (or overlap) its "
               "output rows, columns or segments",
    "SMEM004": "model drift: a library's constants or plan, or its ptxas "
               "report, differ from the Python model",
    "SMEM005": "the heuristic's design does not fit one SM at its "
               "__launch_bounds__ occupancy",
    "SMEM006": "ptxas reports spill stores or loads",
}

#: an H100 SM's registers (its shared memory and the shared memory the
#: driver keeps a block are ``kernels.ops.SM_SMEM_BYTES`` and
#: ``BLOCK_RESERVED_SMEM``, which kernel 3's split also reads)
SM_REGISTERS = 65536
MAX_THREADS = 1024
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_CLUSTER, PORTABLE_CLUSTER = 16, 8
_NONPORTABLE = "cudaFuncAttributeNonPortableClusterSizeAllowed"

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "kernels",
                     "csrc")

#: every ``__global__`` kernel of ``kernels/csrc``: (its source, the
#: library holding it, its ``__launch_bounds__`` text in the source or
#: None, the most threads and the fewest resident blocks those bounds ask)
KERNELS: Dict[str, Tuple[str, str, Optional[str], int, int]] = {
    "gemv_split_kernel": ("pcilt_gemv_stacked.cu", "gemv_stacked",
                          "32 * kWarps, 1", 128, 1),
    "gemv_split_slabs_kernel": ("pcilt_gemv_stacked.cu", "gemv_stacked",
                                "32 * kWarps, 1", 128, 1),
    "gemv_direct_kernel": ("pcilt_gemv_stacked.cu", "gemv_stacked", None,
                           MAX_THREADS, 1),
    "gemv_staged_kernel": ("pcilt_gemv_staged.cu", "gemv_staged",
                           "threads_of(WIDE), blocks_of(WIDE)", 512, 1),
    "shared_split_kernel": ("pcilt_shared_gemv.cu", "shared_gemv",
                            "32 * kWarps, kBlocksPerSm", 256, 2),
    "shared_gemv_kernel": ("pcilt_shared_gemv.cu", "shared_gemv", None,
                           MAX_THREADS, 1),
    "dwconv1d_kernel": ("pcilt_dwconv1d.cu", "dwconv1d", None, MAX_THREADS,
                        1),
    "dwconv1d_tiled_kernel": ("pcilt_dwconv1d.cu", "dwconv1d",
                              "kDwTiledThreads", 512, 1),
    "dwconv1d_staged_kernel": ("pcilt_dwconv1d.cu", "dwconv1d",
                               "kDwThreads", 256, 1),
    "dwconv1d_host_kernel": ("pcilt_dwconv1d.cu", "dwconv1d", None,
                             MAX_THREADS, 1),
    "conv2d_kernel": ("pcilt_conv2d.cu", "conv2d", None, MAX_THREADS, 1),
    "conv2d_codes_kernel": ("pcilt_conv2d.cu", "conv2d", None, MAX_THREADS,
                            1),
    "conv2d_staged_kernel": ("pcilt_conv2d.cu", "conv2d",
                             "staged::kThreads, 1", 512, 1),
    "gemv_host_kernel": ("pcilt_gemv.cu", "gemv_host", None, MAX_THREADS, 1),
    "gemv_host_split_kernel": ("pcilt_gemv.cu", "gemv_host",
                               "32 * split::kWarps, 1", 128, 1),
    "gemv_host_split_slabs_kernel": ("pcilt_gemv.cu", "gemv_host",
                                     "32 * split::kWarps, 1", 128, 1),
    "gemv_host_staged_kernel": ("pcilt_gemv.cu", "gemv_host",
                                "hstaged::kThreads, 1", 512, 1),
    "crc_chunks_kernel": ("pcilt_crc32.cu", "crc32", "kThreads", 256, 1),
    "crc_banked_kernel": ("pcilt_crc32.cu", "crc32", "kBankedThreads, 1",
                          512, 1),
    "crc_combine_kernel": ("pcilt_crc32.cu", "crc32", None, MAX_THREADS, 1),
}

#: the static shared memory of each kernel, as its ``__shared__`` arrays
#: declare it (the most of its template instances): the CRC's byte tables
#: ``uint32_t[16][256]`` and lane operators ``[5][32]`` (the kept design),
#: the banked design's lane operators ``[5][32]`` (its tables and staging
#: tiles are dynamic), its combine's
#: ``kCombine`` nodes and ``[10][32]`` operators, the tiled dwconv's
#: cluster slots ``[16 * 16]`` int and unsigned, the code pre-pass's
#: ``[32][33]`` byte tile; the others take dynamic shared memory only
STATIC_SMEM: Dict[str, int] = dict.fromkeys(KERNELS, 0)
STATIC_SMEM.update({"crc_chunks_kernel": 4 * (16 * 256 + 5 * 32),
                    "crc_banked_kernel": 4 * 5 * 32,
                    "crc_combine_kernel": 4 * (1024 + 10 * 32),
                    "dwconv1d_tiled_kernel": 2 * 4 * 16 * 16,
                    "conv2d_codes_kernel": 32 * 33})


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch a design makes: its ``__global__`` function, grid,
    block, dynamic shared memory and cluster size."""
    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem: int = 0
    cluster: int = 1

    @property
    def threads(self) -> int:
        return math.prod(self.block)


@dataclasses.dataclass(frozen=True)
class Family:
    """A design model: ``sweep(name)`` the shapes (dicts) of the ``quick``
    or ``full`` sweep, ``designs(shape)`` the admitted designs (the
    heuristic's first), ``launches(shape, design)`` their launches,
    ``cover(shape, design)`` the coverage problems, ``config(lib)`` the
    library's constants' problems (once), ``plan(lib, shape)`` its plan's
    problems at one shape, and ``refused(shape, design)`` whether the
    ``kernels.ops`` wrapper refuses the design there with a ``ValueError``
    before any launch (a generator's last-resort design where none
    fits)."""
    name: str
    kernels: str
    source: str
    library: str
    sweep: Callable[[str], Iterable[dict]]
    designs: Callable[[dict], List[str]]
    launches: Callable[[dict, str], List[Launch]]
    cover: Callable[[dict, str], List[str]]
    config: Callable[[object], List[str]]
    plan: Callable[[object, dict], List[str]]
    refused: Callable[[dict, str], bool] = lambda s, design: False


def _ops():
    from repro_torch.kernels import ops

    return ops


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _intervals(parts, lo: int, hi: int, what: str) -> List[str]:
    """The problems of ``parts`` ``[(a, b)]`` as a partition of ``[lo,
    hi)``: gaps, overlaps, empty parts."""
    out = []
    at = lo
    for a, b in sorted(parts):
        if b <= a:
            out.append(f"{what}: an empty part [{a}, {b})")
            continue
        if a > at:
            out.append(f"{what}: [{at}, {a}) is covered by no part")
        elif a < at:
            out.append(f"{what}: [{a}, {min(at, b)}) is covered twice")
        at = max(at, b)
    if at < hi:
        out.append(f"{what}: [{at}, {hi}) is covered by no part")
    elif at > hi:
        out.append(f"{what}: parts reach {at}, past the end {hi}")
    return out


def _ints(lib, fn: str, n: int, *args) -> Tuple[int, ...]:
    out = (ctypes.c_int * n)()
    getattr(lib, fn)(*args, out)
    return tuple(out)


def _compare(got, want, what: str) -> List[str]:
    got, want = tuple(got), tuple(want)
    return [] if got == want else [f"{what}: the library gives {got}, "
                                   f"kernels.ops models {want}"]


# ----------------------------------------------------------------------------
# the sweeps
# ----------------------------------------------------------------------------

#: the batch rows of the full sweep
_BATCHES = (1, 2, 4, 8, 16, 32, 64)
#: the paper CNN: channels, 5x5 SAME convs at stride 1, INT8 (V = 256),
#: group 1; its image
_CNN = ((1, 50), (50, 80), (80, 120), (120, 200), (200, 350))
_CNN_K, _CNN_V, _CNN_HW, _CNN_SMALL = 5, 256, (768, 1024), (48, 64)
#: mamba2-130m's decode widths at 4 bits, group 2: (G, O) of the six
#: projections; the paired decode's (G2, O); its conv frontend
_MAMBA = ((384, 1536), (384, 128), (384, 24), (768, 768))
_PAIRED = ((192, 1536), (192, 128), (192, 24), (384, 768))
_CONV_C, _CONV_K, _CONV_T = 1792, 4, 2048
#: the head: [384, 256, 50288] pool; qwen3-0.6b's gate
_HEAD = (384, 50288)
_GATE = (512, 3072)
#: kernel 6's other decode-size shapes (G, V, O): the learnable example's
#: tables, a ragged O, a V of 4096
_HOST_SMALL = ((8, 16, 4), (25, 256, 13), (64, 4096, 33))
#: a full-width mamba2-130m layer's seven table streams and the head's
#: one, in bytes (float32)
_LAYER_STREAMS = (4 * 1792 * 65536, 4 * 384 * 256 * 1536,
                  4 * 384 * 256 * 1536, 4 * 384 * 256 * 128,
                  4 * 384 * 256 * 128, 4 * 384 * 256 * 24,
                  4 * 768 * 256 * 768)
_HEAD_STREAM = (4 * 384 * 256 * 50288,)


def _config_widths() -> List[Tuple[int, int]]:
    """``(d_in, d_out)`` of every dense kernel, head and embedding of every
    registered config (the stacking and expert dims left out)."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import ParamSpec

    out = set()

    def walk(t):
        if isinstance(t, ParamSpec):
            dims = [n for n, a in zip(t.shape, t.axes)
                    if a not in ("layers", "expert", "stage")]
            if len(dims) < 2:
                return
            if t.axes and t.axes[0] == "vocab":  # an embedding: the head
                out.add((dims[1], dims[0]))
            else:
                out.add((dims[0], math.prod(dims[1:])))
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)

    for arch in ARCHS:
        walk(build_model(get_config(arch)).param_specs())
    return sorted(out)


def _gemv_shapes(sweep: str) -> Iterable[dict]:
    seen = set()

    def add(B, G, O, es):
        k = (B, G, O, es)
        if G >= 1 and O >= 1 and k not in seen:
            seen.add(k)
            yield {"B": B, "G": G, "O": O, "itemsize": es}

    for es in (4, 2):
        for G, O in _MAMBA + _PAIRED + (_GATE,):
            for B in (1, 4):
                yield from add(B, G, O, es)
    if sweep == "full":
        for d_in, d_out in _config_widths():
            for g in (1, 2):
                if d_in % g:
                    continue
                for B in _BATCHES:
                    for es in (4, 2):
                        yield from add(B, d_in // g, d_out, es)


#: (B, G, O, itemsize) past a design ceiling the split GEMVs once had and
#: the reference never did: more than 65535 row chunks of 4 rows, a
#: 16-block cluster's offsets past a block's shared memory (kernel 9) or
#: past two blocks an SM (kernel 3), and ``chip_smoke.py``'s cases of them
CEILING_GEMV = ((1056, 300000, 8, 4), (4, 230000, 8, 4), (262144, 64, 8, 4),
                (262148, 64, 64, 4), (4, 230000, 64, 4),
                (262148, 64, 64, 2))
CEILING_SHARED = ((262148, 32, 64, 4), (4, 2000000, 8, 4),
                  (4, 230000, 64, 4), (262148, 32, 64, 2))
#: (M, G, V, O, itemsize) of kernel 6's split past the same ceilings: a
#: block's segments in slabs, and more than 65535 row chunks (forced: the
#: chooser stages so many rows)
CEILING_HOST = ((4, 230000, 2, 8, 4), (262148, 64, 16, 64, 4))


def _ceiling(sweep: str, shapes, base) -> Iterable[dict]:
    yield from base(sweep)
    if sweep == "full":
        for B, G, O, es in shapes:
            yield {"B": B, "G": G, "O": O, "itemsize": es}


def _gemv_sweep(sweep: str) -> Iterable[dict]:
    return _ceiling(sweep, CEILING_GEMV, _gemv_shapes)


def _shared_sweep(sweep: str) -> Iterable[dict]:
    return _ceiling(sweep, CEILING_SHARED, _shared_shapes)


def _shared_shapes(sweep: str) -> Iterable[dict]:
    shapes = [(B, G, O, es) for B in (1, 4) for G, O in (_HEAD, _GATE)
              for es in (4, 2)]
    if sweep == "full":
        from repro_torch.configs import ARCHS, get_config

        for arch in ARCHS:
            c = get_config(arch)
            for g in (1, 2):
                if c.d_model % g == 0:
                    shapes += [(B, c.d_model // g, c.padded_vocab, es)
                               for B in _BATCHES for es in (4, 2)]
    for B, G, O, es in dict.fromkeys(shapes):
        yield {"B": B, "G": G, "O": O, "itemsize": es}


def _conv_channels(sweep: str) -> List[int]:
    out = [_CONV_C]
    if sweep == "full":
        from repro_torch.configs import ARCHS, get_config

        for arch in ARCHS:
            c = get_config(arch)
            ssm = getattr(c, "ssm", None)
            if ssm is not None:
                d_inner = getattr(ssm, "d_inner", None) or \
                    getattr(ssm, "expand", 2) * c.d_model
                out.append(d_inner + 2 * getattr(ssm, "n_groups", 1)
                           * getattr(ssm, "d_state", 128))
    return sorted(set(out))


def _dwconv_shapes(sweep: str) -> Iterable[dict]:
    batches = (1, 4) if sweep == "quick" else _BATCHES
    for C in _conv_channels(sweep):
        for B in batches:
            for To in (1, _CONV_T):
                for k in (_CONV_K, 2, 8, 9):
                    for wide in (True, False):
                        if wide and C % 4:
                            continue
                        for counters in (True, False):
                            yield {"B": B, "To": To, "C": C, "k": k,
                                   "wide": wide, "counters": counters,
                                   "itemsize": 4}


def _dwconv_host_shapes(sweep: str) -> Iterable[dict]:
    batches = (4,) if sweep == "quick" else _BATCHES
    for C in _conv_channels(sweep):
        for B in batches:
            for T in (1, _CONV_T):
                for V in (16, 256, 4096):
                    for es in (4, 2):
                        yield {"M": B * T, "C": C, "V": V, "itemsize": es}


def _cnn_shapes(sweep: str) -> List[Tuple[int, int, int, int]]:
    """``(B, H, W, layer)`` of the paper CNN's convs in the sweep."""
    H, W = _CNN_HW
    out = [(1, H, W, i) for i in range(len(_CNN))]
    out += [(1, *_CNN_SMALL, i) for i in range(len(_CNN))]
    if sweep == "full":
        out += [(B, H, W, i) for B in _BATCHES[1:] for i in range(len(_CNN))]
    return out


def _conv_shapes(sweep: str) -> Iterable[dict]:
    for B, H, W, i in _cnn_shapes(sweep):
        C, O = _CNN[i]
        for es in (4, 2):
            yield {"B": B, "Hp": H + _CNN_K - 1, "Wp": W + _CNN_K - 1,
                   "Ho": H, "Wo": W, "C": C, "O": O, "V": _CNN_V,
                   "G": _CNN_K * _CNN_K * C, "itemsize": es}


def _gemv_host_shapes(sweep: str) -> Iterable[dict]:
    for B, H, W, i in _cnn_shapes(sweep):
        C, O = _CNN[i]
        for es in (4, 2):
            yield {"M": B * H * W, "G": _CNN_K * _CNN_K * C, "V": _CNN_V,
                   "O": O, "itemsize": es}
    Ms = (1, 4, 64, 1023) if sweep == "quick" else \
        _BATCHES + (256, 1023, 1024, 4096)
    for M in Ms:
        for G, V, O in ((_GATE[0], 16, _GATE[1]), (_GATE[0], 256, _GATE[1]),
                        (_GATE[0], 65536, _GATE[1])) + _HOST_SMALL:
            for es in (4, 2):
                yield {"M": M, "G": G, "V": V, "O": O, "itemsize": es}
    if sweep == "full":
        for M, G, V, O, es in CEILING_HOST:
            yield {"M": M, "G": G, "V": V, "O": O, "itemsize": es}


def _crc_shapes(sweep: str) -> Iterable[dict]:
    yield {"streams": _LAYER_STREAMS}
    yield {"streams": _HEAD_STREAM}
    if sweep == "full":
        for n in (1, 7, 343, 4096):
            for size in (1, 65536, 65537, 2 ** 30 + 3):
                yield {"streams": (size,) * n}


# ----------------------------------------------------------------------------
# the fused GEMV (kernels 1, 8-11; pcilt_gemv_stacked.cu)
# ----------------------------------------------------------------------------


def _gemv_designs(s):
    return _ops().gemv_candidates(s["B"], s["G"], s["O"], s["itemsize"])


def _direct_launch(kernel, B, G, O):
    """``launch_direct`` of pcilt_gemv_stacked.cu / pcilt_shared_gemv.cu:
    128 columns a block, ``min(B, 8)`` rows of threads, the ``B * G``
    offsets in shared memory."""
    return Launch(kernel, (_cdiv(O, 128), 1, 1), (128, min(B, 8), 1),
                  B * G * 4)


def _split_refused(s, design):
    """The guard of ``_launch_gemv`` / ``_shared_gemv``: the split design
    serves any shape; the direct one needs the ``B * G`` offsets in one
    block's shared memory."""
    return design == "direct" and \
        s["B"] * s["G"] * 4 > _ops().SMEM_LIMIT


def _row_walk(chunks: int, rows: int, B: int) -> List[str]:
    """The rows a split grid covers: ``min(chunks, MAX_GRID_YZ)`` rows of
    blocks, block row ``y`` walking chunks ``y, y + gridDim.y, ...`` of
    ``rows`` rows each."""
    gy = min(chunks, MAX_GRID_YZ)
    return _intervals([(c * rows, min(B, (c + 1) * rows))
                       for y in range(gy) for c in range(y, chunks, gy)],
                      0, B, "rows")


def _row_planes(sp, rows: int, B: int) -> List[str]:
    """The rows the fused GEMV's split grid covers: block ``(x, y, z)``
    sums row chunk ``z * MAX_GRID_YZ + y`` (``gemv_grid``), a chunk past
    the last one adding nothing."""
    _, gy, gz = _ops().gemv_grid(sp)
    if gy * gz > 1 << 17:  # (z, y) -> z * MAX_GRID_YZ + y, gy <= MAX_GRID_YZ
        reach = (gz - 1) * MAX_GRID_YZ + gy
        ok = (gz == 1 or gy == MAX_GRID_YZ) and gy <= MAX_GRID_YZ and \
            reach - gy < sp.chunks <= reach and \
            (sp.chunks - 1) * rows < B <= sp.chunks * rows
        return [] if ok else [f"rows: {gz} planes of {gy} row chunks of "
                              f"{rows} rows for {B} rows ({sp.chunks} "
                              f"chunks)"]
    chunks = [z * MAX_GRID_YZ + y for z in range(gz) for y in range(gy)]
    return _intervals([(c * rows, min(B, (c + 1) * rows)) for c in chunks
                       if c < sp.chunks], 0, B, "rows")


def _slabs(ranks, slab: int) -> List[str]:
    """Each rank's staged segments ``[r0, r1)`` as the split kernels walk
    them, slabs of ``slab`` from ``r0``: they must cover the rank's
    segments once, each slab within ``slab``."""
    if slab < 1:
        return [f"segments: a slab of {slab} segments"]
    out = []
    for r0, r1 in ranks:
        parts = [(t, min(t + slab, r1)) for t in range(r0, r1, slab)]
        out += _intervals(parts, r0, r1, "segments") if r1 > r0 else []
    return out


def _split_launch(kernels, B, G, O, es):
    """The split launch of pcilt_split.cuh (``launch_cluster``) over ``B``
    rows: the one-pass kernel, or the slab kernel where a block's segments
    overflow a slab (``split_slabs``); ``kernels`` names the two."""
    ops = _ops()
    sp = ops.gemv_variant(B, G, O, es)
    slabs = ops.gemv_slab(sp, G) < _cdiv(G, sp.cluster)
    return Launch(kernels[slabs], ops.gemv_grid(sp), (32 * sp.warps, 1, 1),
                  ops.gemv_smem_bytes(sp, G), sp.cluster)


def _gemv_launches(s, design):
    B, G, O, es = s["B"], s["G"], s["O"], s["itemsize"]
    if design == "direct":
        return [_direct_launch("gemv_direct_kernel", B, G, O)]
    return [_split_launch(("gemv_split_kernel", "gemv_split_slabs_kernel"),
                          B, G, O, es)]  # launch_split_vb


def _gemv_slices(sp, G: int):
    """Each slot's segments ``[s*G // S, (s+1)*G // S)`` (``S = cluster *
    warps * groups``, slot ``s`` of block rank ``s // (warps * groups)``)
    and each rank's staged segments ``[r*G // cluster, (r+1)*G //
    cluster)``, as ``gemv_split_kernel`` computes them."""
    SB = sp.warps * sp.groups
    S = sp.cluster * SB
    slots = [(s * G // S, (s + 1) * G // S) for s in range(S)]
    ranks = [(r * G // sp.cluster, (r + 1) * G // sp.cluster)
             for r in range(sp.cluster)]
    return slots, ranks, SB


def _gemv_cover(s, design):
    B, G, O, es = s["B"], s["G"], s["O"], s["itemsize"]
    if design == "direct":
        return _intervals([(i * 128, min(O, (i + 1) * 128))
                           for i in range(_cdiv(O, 128))], 0, O, "columns")
    return _split_cover(B, G, O, es)


def _split_cover(B, G, O, es):
    """The split's columns, rows (over the grid's planes), slots and slabs
    over ``B`` rows (kernels 1, 6, 7 and 8-11)."""
    ops = _ops()
    sp = ops.gemv_variant(B, G, O, es)
    out = _intervals([(t * sp.tile, min(O, (t + 1) * sp.tile))
                      for t in range(sp.tiles)], 0, O, "columns")
    out += _row_planes(sp, ops.GEMV_ROWS, B)
    if sp.lanes * sp.groups > 32:
        out.append(f"{sp.groups} slots of {sp.lanes} lanes exceed a warp")
    slots, ranks, SB = _gemv_slices(sp, G)
    out += _intervals([x for x in slots if x[1] > x[0]], 0, G, "segments")
    for i, (a, b) in enumerate(slots):
        r0, r1 = ranks[i // SB]
        if a < r0 or b > r1:
            out.append(f"segments: slot {i}'s [{a}, {b}) lies outside its "
                       f"block's staged [{r0}, {r1})")
    return out + _slabs(ranks, ops.gemv_slab(sp, G))


def _gemv_config(lib):
    ops = _ops()
    return _compare(_ints(lib, "pcilt_gemv_split_config", 8),
                    (ops.GEMV_ROWS, ops.GEMV_WARPS, ops.GEMV_SEG_BATCH,
                     ops.GEMV_TARGET_BLOCKS, ops.GEMV_MAX_CLUSTER,
                     ops.GEMV_MIN_SEGS, ops.GEMV_MAX_LANES,
                     ops.GEMV_LANE_BYTES), "the split constants")


def _gemv_plan(lib, s):
    return _split_plan(lib, s["B"], s["G"], s["O"], s["itemsize"])


def _split_plan(lib, B, G, O, es):
    ops = _ops()
    sp = ops.gemv_variant(B, G, O, es)
    return _compare(_ints(lib, "pcilt_gemv_split_plan", 10, B, G, O, es),
                    (*sp, ops.gemv_smem_bytes(sp, G), ops.gemv_slab(sp, G),
                     ops.gemv_planes(sp)),
                    f"the split of B {B}, G {G}, O {O}, itemsize {es}")


# ----------------------------------------------------------------------------
# kernel 9's staged design (pcilt_gemv_staged.cu)
# ----------------------------------------------------------------------------

#: kernel 9's rows in the staged sweep: decode, the chooser's crossovers,
#: prefills (a 4 x 192-token one gives 768) and more
_STAGED_ROWS = (1, 4, 8, 16, 32, 64, 768, 4096)
#: (B, G, V, O, itemsize) past the ceilings: more than 65535 row tiles of
#: the smallest tile, slabs at group 1, ``chip_smoke.py``'s cases
CEILING_STAGED = ((8388609, 16, 16, 8, 4), (4, 230000, 16, 64, 4),
                  (262148, 64, 256, 64, 4), (32, 14336, 16, 4096, 4),
                  (32, 19200, 16, 7168, 2))


def _gemv_staged_sweep(sweep: str) -> Iterable[dict]:
    seen = set()

    def add(B, G, V, O, es):
        k = (B, G, V, O, es)
        if G >= 1 and O >= 1 and k not in seen:
            seen.add(k)
            yield {"B": B, "G": G, "V": V, "O": O, "itemsize": es}

    for es in (4, 2):
        for B in (1, 4, 32, 768):
            yield from add(B, _GATE[0], 256, _GATE[1], es)
    if sweep == "full":
        for d_in, d_out in _config_widths():
            for g, V in ((1, 16), (2, 256)):
                if d_in % g:
                    continue
                for B in _STAGED_ROWS:
                    for es in (4, 2):
                        yield from add(B, d_in // g, V, d_out, es)
        for shape in CEILING_STAGED:
            yield from add(*shape)


def _gemv_staged_designs(s):
    """The staged design where kernel 9's candidates admit it (its split
    and direct designs are the ``gemv`` family's, at the same widths)."""
    cands = _ops().gemv_candidates(s["B"], s["G"], s["O"], s["itemsize"],
                                   s["V"])
    return ["staged"] if "staged" in cands else []


def _gemv_staged_launches(s, design):
    ops = _ops()
    B, G, V, O, es = s["B"], s["G"], s["V"], s["O"], s["itemsize"]
    p = ops.gemv_staged_plan(B, G, V, O, es)  # launch_staged_inst
    return [Launch("gemv_staged_kernel", ops.gemv_staged_grid(p),
                   (ops.STAGED_GEMV_THREADS[p.wide], 1, 1),
                   ops.gemv_staged_smem_bytes(p, G, V), p.cluster)]


def _gemv_staged_cover(s, design):
    """The staged plan's columns, rows (over the grid's planes), ranks and
    slabs."""
    ops = _ops()
    B, G, V, O, es = s["B"], s["G"], s["V"], s["O"], s["itemsize"]
    p = ops.gemv_staged_plan(B, G, V, O, es)
    out = _intervals([(t * p.cols, min(O, (t + 1) * p.cols))
                      for t in range(p.ctiles)], 0, O, "columns")
    _, gy, gz = ops.gemv_staged_grid(p)
    reach = (gz - 1) * MAX_GRID_YZ + gy
    if not ((gz == 1 or gy == MAX_GRID_YZ) and gy <= MAX_GRID_YZ
            and reach - gy < p.rtiles <= reach
            and (p.rtiles - 1) * p.rows < B <= p.rtiles * p.rows):
        out.append(f"rows: {gz} planes of {gy} row tiles of {p.rows} rows "
                   f"for {B} rows ({p.rtiles} tiles)")
    lanes = 32 if p.wide else 8
    if p.rows != p.rpt * (32 // lanes) * ops.STAGED_GEMV_THREADS[p.wide] \
            // 32:
        out.append(f"rows: {p.rpt} rows a thread do not make a tile of "
                   f"{p.rows}")
    ranks = [(r * G // p.cluster, (r + 1) * G // p.cluster)
             for r in range(p.cluster)]
    out += _intervals([x for x in ranks if x[1] > x[0]], 0, G, "segments")
    return out + _slabs(ranks, ops.gemv_staged_slab(p, G, V))


def _gemv_staged_config(lib):
    ops = _ops()
    return _compare(_ints(lib, "pcilt_gemv_staged_config",
                          len(ops.STAGED_GEMV_CONFIG)),
                    ops.STAGED_GEMV_CONFIG, "the staged constants")


def _gemv_staged_plan(lib, s):
    ops = _ops()
    B, G, V, O, es = s["B"], s["G"], s["V"], s["O"], s["itemsize"]
    p = ops.gemv_staged_plan(B, G, V, O, es)
    return _compare(
        _ints(lib, "pcilt_gemv_staged_plan", 10, B, G, V, O, es),
        (int(p.wide), p.rpt, p.rows, p.cols, p.rtiles, p.ctiles, p.cluster,
         ops.gemv_staged_slab(p, G, V), ops.gemv_staged_smem_bytes(p, G, V),
         ops.gemv_staged_planes(p)),
        f"the staged plan of B {B}, G {G}, V {V}, O {O}, itemsize {es}")


# ----------------------------------------------------------------------------
# the shared-pool head GEMV (kernel 3; pcilt_shared_gemv.cu)
# ----------------------------------------------------------------------------


def _shared_designs(s):
    return _ops().shared_gemv_candidates(s["B"], s["G"], s["O"],
                                         s["itemsize"])


def _shared_launches(s, design):
    ops = _ops()
    B, G, O, es = s["B"], s["G"], s["O"], s["itemsize"]
    if design == "direct":
        return [_direct_launch("shared_gemv_kernel", B, G, O)]
    sp = ops.shared_gemv_variant(B, G, O, es)  # launch_split_vb
    return [Launch("shared_split_kernel",
                   (sp.tiles * sp.cluster, min(sp.chunks, MAX_GRID_YZ), 1),
                   (32 * sp.warps, 1, 1), ops.shared_gemv_smem_bytes(sp, G),
                   sp.cluster)]


def _shared_cover(s, design):
    ops = _ops()
    B, G, O, es = s["B"], s["G"], s["O"], s["itemsize"]
    if design == "direct":
        return _intervals([(i * 128, min(O, (i + 1) * 128))
                           for i in range(_cdiv(O, 128))], 0, O, "columns")
    sp = ops.shared_gemv_variant(B, G, O, es)
    out = _intervals([(t * sp.tile, min(O, (t + 1) * sp.tile))
                      for t in range(sp.tiles)], 0, O, "columns")
    out += _row_walk(sp.chunks, sp.rows, B)
    slices = ops.shared_gemv_slices(sp, G)
    out += _intervals([x for x in slices if x[1] > x[0]], 0, G, "segments")
    return out + _slabs(slices, ops.shared_gemv_slab(sp, G))


def _shared_config(lib):
    ops = _ops()
    return _compare(_ints(lib, "pcilt_shared_gemv_split_config", 10),
                    (ops.SHARED_ROWS, ops.SHARED_WARPS,
                     ops.SHARED_LANE_BYTES, ops.SHARED_LOADS,
                     ops.SHARED_TARGET_BLOCKS, ops.SHARED_MAX_CLUSTER,
                     ops.SHARED_MIN_SEGS, ops.SHARED_BLOCKS_PER_SM,
                     ops.SM_SMEM_BYTES, ops.BLOCK_RESERVED_SMEM),
                    "the split constants")


def _shared_plan(lib, s):
    ops = _ops()
    B, G, O, es = s["B"], s["G"], s["O"], s["itemsize"]
    sp = ops.shared_gemv_variant(B, G, O, es)
    return _compare(
        _ints(lib, "pcilt_shared_gemv_split_plan", 8, B, G, O, es),
        (*sp, ops.shared_gemv_smem_bytes(sp, G), ops.shared_gemv_slab(sp, G)),
        f"the split of B {B}, G {G}, O {O}, itemsize {es}")


# ----------------------------------------------------------------------------
# the fused dwconv (kernel 2; pcilt_dwconv1d.cu)
# ----------------------------------------------------------------------------


def _dwconv_designs(s):
    return _ops().dwconv_candidates(s["k"])


def _dwconv_launches(s, design):
    ops = _ops()
    rows = s["B"] * s["To"]
    if design == "direct":  # launch_direct: a thread an output
        return [Launch("dwconv1d_kernel", (_cdiv(rows * s["C"], 256), 1, 1),
                       (256, 1, 1))]
    d = ops.dwconv_tiled_grid(rows, s["C"], s["wide"])  # launch_tiled_nk
    nd = d.tiles * d.ry
    if s["counters"] and nd <= ops.DW_CLUSTER_BLOCKS:
        return [Launch("dwconv1d_tiled_kernel", (2 * nd, 1, 1),
                       (d.threads, 1, 1), 0, nd)]
    return [Launch("dwconv1d_tiled_kernel", (d.tiles, d.ry, 1),
                   (d.threads, 1, 1))]


def _dwconv_cover(s, design):
    ops = _ops()
    rows, C = s["B"] * s["To"], s["C"]
    if design == "direct":
        return _intervals([(0, _cdiv(rows * C, 256) * 256)], 0,
                          _cdiv(rows * C, 256) * 256, "outputs") \
            if rows * C else []
    d = ops.dwconv_tiled_grid(rows, C, s["wide"])
    span = d.threads * d.nv
    out = _intervals([(x * span, min(C, (x + 1) * span))
                      for x in range(d.tiles)], 0, C, "channels")
    if not 1 <= d.ry <= rows:
        out.append(f"rows: {d.ry} row blocks stride {rows} rows")
    return out


def _dwconv_config(lib):
    ops = _ops()
    return _compare(_ints(lib, "pcilt_dwconv1d_tiled_config", 5),
                    (ops.DW_TILED_THREADS, ops.DW_WIDE_LANES,
                     ops.DW_TILED_TARGET_BLOCKS, ops.DW_TILED_MAX_TAPS,
                     ops.DW_CLUSTER_BLOCKS), "the tiled constants")


def _dwconv_plan(lib, s):
    rows = s["B"] * s["To"]
    return _compare(
        _ints(lib, "pcilt_dwconv1d_tiled_plan", 4, rows, s["C"],
              int(s["wide"])),
        _ops().dwconv_tiled_grid(rows, s["C"], s["wide"]),
        f"the tiled grid of {rows} rows of C {s['C']}, wide {s['wide']}")


# ----------------------------------------------------------------------------
# the host-packed dwconv (kernel 12; pcilt_dwconv1d.cu)
# ----------------------------------------------------------------------------


def _dwconv_host_designs(s):
    return _ops().dwconv_host_candidates(s["V"], s["itemsize"])


def _dwconv_host_launches(s, design):
    ops = _ops()
    M, C, V, es = s["M"], s["C"], s["V"], s["itemsize"]
    if design == "direct":  # launch_host, variant 1
        return [Launch("dwconv1d_host_kernel", (_cdiv(M * C, 256), 1, 1),
                       (256, 1, 1))]
    tl = ops.dwconv_host_tiling(M, C, V, es)  # launch_staged_nv
    return [Launch("dwconv1d_staged_kernel", (tl.tiles * tl.groups, 1, 1),
                   (ops.DW_THREADS, 1, 1), tl.smem)]


def _dwconv_host_cover(s, design):
    ops = _ops()
    M, C = s["M"], s["C"]
    if design == "direct":
        return []
    tl = ops.dwconv_host_tiling(M, C, s["V"], s["itemsize"])
    out = _intervals([(t * ops.DW_CHANS, min(C, (t + 1) * ops.DW_CHANS))
                      for t in range(tl.tiles)], 0, C, "channels")
    out += _intervals([(M * k // tl.groups, M * (k + 1) // tl.groups)
                       for k in range(tl.groups)], 0, M, "rows")
    return out


def _dwconv_host_config(lib):
    ops = _ops()
    return _compare(_ints(lib, "pcilt_dwconv1d_staged_config", 4),
                    (ops.DW_CHANS, ops.DW_THREADS, ops.DW_UNROLL,
                     ops.DW_TARGET_BLOCKS), "the staged constants")


def _dwconv_host_plan(lib, s):
    M, C, V, es = s["M"], s["C"], s["V"], s["itemsize"]
    return _compare(_ints(lib, "pcilt_dwconv1d_staged_plan", 3, M, C, V, es),
                    _ops().dwconv_host_tiling(M, C, V, es),
                    f"the staged tiling of M {M}, C {C}, V {V}, itemsize "
                    f"{es}")


# ----------------------------------------------------------------------------
# the fused and shared convs (kernels 4, 5; pcilt_conv2d.cu) and the
# host-packed GEMV and conv (kernels 6, 7; pcilt_gemv.cu)
# ----------------------------------------------------------------------------


def _fetch_launch(kernel, rows: int, O: int) -> Launch:
    """``launch`` of the direct conv and host GEMV: ``fetch_block(O)`` (an
    O tile of ``min(128, O rounded up to a warp)`` columns, 256 threads),
    ``8 * blockDim.y`` rows a block, ``fetch_smem_bytes`` of shared
    memory (pcilt_common.cuh)."""
    to = min(128, _cdiv(O, 32) * 32)
    ty = max(1, 256 // to)
    R = ty * 8
    smem = 128 * 8 + R * 128 * 4 + R * 8
    return Launch(kernel, (_cdiv(rows, R), _cdiv(O, to), 1), (to, ty, 1),
                  smem)


def _fetch_cover(rows: int, O: int) -> List[str]:
    L = _fetch_launch("", rows, O)
    R, to = L.block[1] * 8, L.block[0]
    out = _intervals([(i * R, min(rows, (i + 1) * R))
                      for i in range(L.grid[0])], 0, rows, "rows") \
        if L.grid[0] <= 4096 else (
            [] if (L.grid[0] - 1) * R < rows <= L.grid[0] * R
            else [f"rows: {L.grid[0]} blocks of {R} rows for {rows}"])
    return out + _intervals([(j * to, min(O, (j + 1) * to))
                             for j in range(L.grid[1])], 0, O, "columns")


def _tile_cover(tile_fn, n_blocks: int, rows: int, O: int,
                n_rows: int) -> List[str]:
    """The problems of a 1-D grid whose block ``i`` owns ``tile_fn(i)`` =
    ``((r0, r1), (o0, o1))``: the blocks of the first column tile must
    partition the rows, the first block of each column tile the columns,
    and every block must be the pair of its row and column tiles (checked
    block by block up to 2**17 blocks, then on the first and last
    ``n_rows`` of each column tile)."""
    n_cols = _cdiv(n_blocks, n_rows) if n_rows else 0
    out = _intervals([tile_fn(i)[0] for i in range(n_rows)], 0, rows,
                     "rows")
    out += _intervals([tile_fn(j * n_rows)[1] for j in range(n_cols)], 0, O,
                      "columns")
    if n_rows * n_cols != n_blocks:
        out.append(f"{n_blocks} blocks are not {n_rows} row tiles by "
                   f"{n_cols} column tiles")
        return out
    row_t = [tile_fn(i)[0] for i in range(n_rows)]
    col_t = [tile_fn(j * n_rows)[1] for j in range(n_cols)]
    check = range(n_blocks) if n_blocks <= 1 << 17 else \
        [j * n_rows + i for j in range(n_cols)
         for i in (0, 1, n_rows - 2, n_rows - 1) if 0 <= i < n_rows]
    for i in check:
        want = (row_t[i % n_rows], col_t[i // n_rows])
        if tuple(tile_fn(i)) != want:
            out.append(f"block {i} owns {tile_fn(i)}, not row tile "
                       f"{i % n_rows} by column tile {i // n_rows} {want}")
            break
    return out


def _conv_designs(s):
    return _ops().conv_candidates(s["V"], s["itemsize"])


def _conv_launches(s, design):
    ops = _ops()
    P = s["B"] * s["Ho"] * s["Wo"]
    if design == "direct":
        return [_fetch_launch("conv2d_kernel", P, s["O"])]
    n_p, n_c = ops.staged_tiles(P, s["O"])  # launch_staged, launch_codes
    S = s["Hp"] * s["Wp"]
    return [Launch("conv2d_codes_kernel", (_cdiv(S, 32), _cdiv(s["C"], 32),
                                           s["B"]), (32, 8, 1)),
            Launch("conv2d_staged_kernel", (n_p * n_c, 1, 1),
                   (32 * 16, 1, 1), ops.staged_smem_bytes(s["itemsize"]))]


def _conv_cover(s, design):
    ops = _ops()
    P, O = s["B"] * s["Ho"] * s["Wo"], s["O"]
    if design == "direct":
        return _fetch_cover(P, O)
    n_p, n_c = ops.staged_tiles(P, O)
    out = _tile_cover(lambda i: ops.staged_block_tile(i, P, O), n_p * n_c,
                      P, O, n_p)
    S = s["Hp"] * s["Wp"]
    out += _intervals([(i * 32, min(S, (i + 1) * 32))
                       for i in range(_cdiv(S, 32))], 0, S, "code pixels") \
        if S <= 1 << 17 else []
    return out


def _conv_config(lib):
    ops = _ops()
    return _compare(_ints(lib, "pcilt_conv2d_staged_config", 6),
                    (ops.STAGED_PIX_TILE, ops.STAGED_COL_TILE,
                     ops.STAGED_STAGES, ops.STAGED_OFF_RING,
                     ops.STAGED_ROW_PITCH, ops.STAGED_MAX_V),
                    "the staged tiling")


def _gemv_host_designs(s):
    return _ops().gemv_host_candidates(s["M"], s["G"], s["V"], s["O"],
                                       s["itemsize"])


def _gemv_host_launches(s, design):
    ops = _ops()
    M, O = s["M"], s["O"]
    if design == "direct":
        return [_fetch_launch("gemv_host_kernel", M, O)]
    if design == "split":  # launch_split
        return [_split_launch(("gemv_host_split_kernel",
                               "gemv_host_split_slabs_kernel"), M, s["G"],
                              O, s["itemsize"])]
    n_r, n_c = ops.gemv_host_tiles(M, O)  # launch_staged
    return [Launch("gemv_host_staged_kernel", (n_r * n_c, 1, 1),
                   (32 * 16, 1, 1), ops.gemv_host_smem_bytes(s["itemsize"]))]


def _gemv_host_cover(s, design):
    ops = _ops()
    M, O = s["M"], s["O"]
    if design == "direct":
        return _fetch_cover(M, O)
    if design == "split":
        return _split_cover(M, s["G"], O, s["itemsize"])
    n_r, n_c = ops.gemv_host_tiles(M, O)
    return _tile_cover(lambda i: ops.gemv_host_block_tile(i, M, O),
                       n_r * n_c, M, O, n_r)


def _gemv_host_config(lib):
    ops = _ops()
    return _compare(_ints(lib, "pcilt_gemv_host_staged_config", 6),
                    (ops.HOST_ROW_TILE, ops.HOST_COL_TILE, ops.HOST_STAGES,
                     ops.HOST_CHUNK, ops.HOST_OFF_RING, ops.HOST_MAX_V),
                    "the staged tiling") + _gemv_config(lib)


def _gemv_host_plan(lib, s):
    """The library's split of the shape, where the split is admitted."""
    if "split" not in _gemv_host_designs(s):
        return []
    return _split_plan(lib, s["M"], s["G"], s["O"], s["itemsize"])


# ----------------------------------------------------------------------------
# the CRC (pcilt_crc32.cu)
# ----------------------------------------------------------------------------

#: the kept design's chunks a chunk block takes at once and chunk blocks
#: an SM, the banked design's (one block an SM) and its dynamic shared
#: memory (4 tables of 256 words, a copy a bank; a warp's staging tile of
#: 32 rows at a 144-byte pitch), an H100's SMs
_CRC_WARPS, _CRC_BLOCKS_PER_SM, _SMS = 8, 8, 132
_CRC_BANKED_WARPS = 16
_CRC_BANKED_SMEM = 4 * 256 * 32 * 4 + _CRC_BANKED_WARPS * 32 * 144


def _crc_plan(streams):
    """``(chunks a stream, levels, the combine passes' (blocks, streams,
    threads))`` of ``ops.pcilt_crc32`` and ``pcilt_crc32``'s loop."""
    from repro_torch.kernels.ref import CRC_CHUNK_BYTES

    ops = _ops()
    nch = [_cdiv(n, CRC_CHUNK_BYTES) for n in streams if n]
    levels = (max(nch) - 1).bit_length()
    passes = []
    n, left = 1 << levels, levels
    while True:
        lv = min(left, ops.CRC_COMBINE.bit_length() - 1)
        per = 1 << lv
        passes.append((n // per, len(nch), per))
        n //= per
        left -= lv
        if n <= 1:
            return nch, levels, passes


def _crc_designs(s):
    return list(_ops().CRC_VARIANTS)


def _crc_launches(s, design):
    nch, _, passes = _crc_plan(s["streams"])
    if design == "kept":
        blocks = min(_cdiv(sum(nch), _CRC_WARPS), _SMS * _CRC_BLOCKS_PER_SM)
        first = Launch("crc_chunks_kernel", (blocks, 1, 1),
                       (32 * _CRC_WARPS, 1, 1))
    else:
        blocks = min(_cdiv(sum(nch), _CRC_BANKED_WARPS), _SMS)
        first = Launch("crc_banked_kernel", (blocks, 1, 1),
                       (32 * _CRC_BANKED_WARPS, 1, 1), _CRC_BANKED_SMEM)
    return [first] + [Launch("crc_combine_kernel", (b, n, 1), (per, 1, 1))
                      for b, n, per in passes]


def _crc_cover(s, design):
    from repro_torch.kernels.ref import CRC_CHUNK_BYTES, CRC_LEVELS

    nch, levels, passes = _crc_plan(s["streams"])
    out = []
    for n, c in zip([x for x in s["streams"] if x], nch):
        if not (c - 1) * CRC_CHUNK_BYTES < n <= c * CRC_CHUNK_BYTES:
            out.append(f"bytes: {c} chunks for a stream of {n} bytes")
    if (1 << levels) < max(nch):
        out.append(f"chunks: a tree of {1 << levels} leaves for "
                   f"{max(nch)} chunks")
    if 5 + levels > CRC_LEVELS:
        out.append(f"chunks: {levels} levels exceed the operator table's "
                   f"{CRC_LEVELS - 5}")
    if passes[-1][0] != 1:
        out.append(f"chunks: the combine passes end on {passes[-1][0]} "
                   f"nodes, not one")
    return out


def _crc_config(lib):
    from repro_torch.kernels.ref import (CRC_CHUNK_BYTES, CRC_LANE_BYTES,
                                         CRC_LEVELS)

    return _compare(_ints(lib, "pcilt_crc32_config", 4),
                    (CRC_LANE_BYTES, CRC_CHUNK_BYTES, CRC_LEVELS,
                     _ops().CRC_COMBINE), "the CRC constants")


def _no_plan(lib, s):
    return []


def FAMILIES() -> List[Family]:
    """The design models, in the kernel table's order."""
    return [
        Family("gemv", "1, 8-11", "pcilt_gemv_stacked.cu", "gemv_stacked",
               _gemv_sweep, _gemv_designs, _gemv_launches, _gemv_cover,
               _gemv_config, _gemv_plan, _split_refused),
        Family("gemv_staged", "9", "pcilt_gemv_staged.cu", "gemv_staged",
               _gemv_staged_sweep, _gemv_staged_designs,
               _gemv_staged_launches, _gemv_staged_cover,
               _gemv_staged_config, _gemv_staged_plan, _split_refused),
        Family("dwconv", "2", "pcilt_dwconv1d.cu", "dwconv1d",
               _dwconv_shapes, _dwconv_designs, _dwconv_launches,
               _dwconv_cover, _dwconv_config, _dwconv_plan),
        Family("shared_gemv", "3", "pcilt_shared_gemv.cu", "shared_gemv",
               _shared_sweep, _shared_designs, _shared_launches,
               _shared_cover, _shared_config, _shared_plan, _split_refused),
        Family("conv", "4, 5", "pcilt_conv2d.cu", "conv2d", _conv_shapes,
               _conv_designs, _conv_launches, _conv_cover, _conv_config,
               _no_plan),
        Family("gemv_host", "6, 7", "pcilt_gemv.cu", "gemv_host",
               _gemv_host_shapes, _gemv_host_designs, _gemv_host_launches,
               _gemv_host_cover, _gemv_host_config, _gemv_host_plan),
        Family("dwconv_host", "12", "pcilt_dwconv1d.cu", "dwconv1d",
               _dwconv_host_shapes, _dwconv_host_designs,
               _dwconv_host_launches, _dwconv_host_cover,
               _dwconv_host_config, _dwconv_host_plan),
        Family("crc", "CRC", "pcilt_crc32.cu", "crc32", _crc_shapes,
               _crc_designs, _crc_launches, _crc_cover, _crc_config,
               _no_plan),
    ]


# ----------------------------------------------------------------------------
# the ptxas report
# ----------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?, (\d+) bytes smem)?")


def parse_report(text: str) -> Dict[str, Dict[str, int]]:
    """``nvcc -Xptxas -v`` output -> for each modelled kernel (every
    template instance of it, matched by its mangled name) the most
    ``registers``, ``static_smem``, ``spill_stores`` and ``spill_loads``
    of its instances, and ``instances``."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            mangled = m.group(1)
            cur = next((k for k in KERNELS
                        if f"{len(k)}{k}" in mangled or mangled == k), None)
            if cur is not None:
                r = out.setdefault(cur, {"registers": 0, "static_smem": 0,
                                         "spill_stores": 0,
                                         "spill_loads": 0, "instances": 0})
                r["instances"] += 1
            continue
        if cur is None:
            continue
        r = out[cur]
        m = _PROPS.search(line)
        if m:
            r["spill_stores"] = max(r["spill_stores"], int(m.group(2)))
            r["spill_loads"] = max(r["spill_loads"], int(m.group(3)))
        m = _USED.search(line)
        if m:
            r["registers"] = max(r["registers"], int(m.group(1)))
            if m.group(2):
                r["static_smem"] = max(r["static_smem"], int(m.group(2)))
    return out


def _launch_bounds_text(source: str, kernel: str) -> Optional[str]:
    """The text of ``kernel``'s ``__launch_bounds__(...)`` in a CUDA source
    (None without one)."""
    from repro_torch.analysis.lint import _blank, device_functions

    with open(os.path.join(_CSRC, source)) as f:
        text = _blank(f.read())
    for name, sig, body, _ in device_functions(text):
        if name == kernel:
            head = text[sig:body]
            m = re.search(r"__launch_bounds__\s*\(", head)
            if m is None:
                return None
            i = m.end() - 1
            depth, j = 0, i
            while j < len(head):
                depth += {"(": 1, ")": -1}.get(head[j], 0)
                if depth == 0:
                    break
                j += 1
            return " ".join(head[i + 1:j].split())
    raise KeyError(f"{source} defines no kernel {kernel!r}")


# ----------------------------------------------------------------------------
# the verifier
# ----------------------------------------------------------------------------


def _source_text(source: str, seen=None) -> str:
    """A CUDA source's text followed by that of the headers of
    ``kernels/csrc`` it includes (a launch attribute set in a shared
    header, as ``pcilt_split.cuh`` sets the split's, is the source's)."""
    seen = set() if seen is None else seen
    seen.add(source)
    with open(os.path.join(_CSRC, source)) as f:
        text = f.read()
    for inc in re.findall(r'#include "([^"]+)"', text):
        if inc not in seen and os.path.exists(os.path.join(_CSRC, inc)):
            text += "\n" + _source_text(inc, seen)
    return text


def _src(family: Family) -> str:
    return f"src/repro_torch/kernels/csrc/{family.source}"


def _limits(L: Launch, family: Family, sources: Dict[str, str]
            ) -> List[str]:
    out = []
    gx, gy, gz = L.grid
    if not 1 <= gx <= MAX_GRID_X:
        out.append(f"gridDim.x {gx} outside [1, 2**31 - 1]")
    for n, v in (("y", gy), ("z", gz)):
        if not 1 <= v <= MAX_GRID_YZ:
            out.append(f"gridDim.{n} {v} outside [1, 65535]")
    bound = KERNELS[L.kernel][3]
    if not 1 <= L.threads <= min(MAX_THREADS, bound):
        out.append(f"{L.threads} threads a block, at most "
                   f"{min(MAX_THREADS, bound)} (__launch_bounds__)")
    if L.cluster > 1:
        if L.cluster > MAX_CLUSTER:
            out.append(f"a cluster of {L.cluster} blocks, at most "
                       f"{MAX_CLUSTER}")
        elif L.cluster > PORTABLE_CLUSTER and _NONPORTABLE not in \
                sources[family.source]:
            out.append(f"a cluster of {L.cluster} blocks (more than "
                       f"{PORTABLE_CLUSTER}) while {family.source} sets no "
                       f"{_NONPORTABLE}")
        if gx % L.cluster:
            out.append(f"gridDim.x {gx} is not a multiple of the cluster "
                       f"{L.cluster}")
    return out


def verify_all(sweep: str = "quick", smem_budget: Optional[int] = None,
               families: Optional[Iterable[str]] = None,
               libraries: Optional[Dict[str, object]] = None,
               reports: Optional[Dict[str, str]] = None,
               root: Optional[str] = None,
               summary: Optional[dict] = None) -> List[Finding]:
    """Check every family's admitted designs over ``sweep`` (``quick`` |
    ``full``); returns the findings (module docstring).  ``smem_budget``
    replaces ``kernels.ops.SMEM_LIMIT`` for SMEM001; ``families`` limits the
    run to those names; ``libraries`` / ``reports`` map a library name
    (``kernels.build.SOURCES``) to a loaded library / its ptxas report
    text; ``summary`` (a dict) receives each family's counts, each
    kernel's most dynamic shared memory, threads and cluster over the
    checked launches, and each reported kernel's resources.  Nothing is
    launched."""
    if sweep not in ("quick", "full"):
        raise ValueError(f"unknown sweep {sweep!r} (quick | full)")
    ops = _ops()
    budget = ops.SMEM_LIMIT if smem_budget is None else int(smem_budget)
    libraries = libraries or {}
    reports = {k: parse_report(v) for k, v in (reports or {}).items()}
    fams = FAMILIES()
    if families is not None:
        want = set(families)
        unknown = want - {f.name for f in fams}
        if unknown:
            raise ValueError(f"unknown families {sorted(unknown)}")
        fams = [f for f in fams if f.name in want]
    sources = {f.source: _source_text(f.source) for f in fams}
    out: List[Finding] = []
    summary = {} if summary is None else summary
    kernels_seen: Dict[str, dict] = {}
    for fam in fams:
        src = _src(fam)
        seen = set()

        def find(rule, sev, msg, sym=fam.name):
            key = (rule, msg.split(";")[0], sym)
            if key not in seen:  # one finding a problem, not a shape
                seen.add(key)
                out.append(Finding(rule, sev, src, 0, msg, symbol=sym))

        lib = libraries.get(fam.library)
        rep = reports.get(fam.library)
        if lib is not None:
            for p in fam.config(lib):
                find("SMEM004", "error", f"{p}; {fam.source}")
        if rep is not None:
            for k, (source, library, _, _, _) in KERNELS.items():
                if library != fam.library or source != fam.source:
                    continue
                if k not in rep:
                    find("SMEM004", "error", f"the ptxas report of "
                         f"{fam.library} has no kernel {k!r}; the model "
                         f"names a kernel the library lacks", k)
                elif rep[k]["static_smem"] != STATIC_SMEM[k]:
                    find("SMEM004", "error",
                         f"{k} has {rep[k]['static_smem']} bytes of static "
                         f"shared memory, the model {STATIC_SMEM[k]}", k)
                elif rep[k]["spill_stores"] or rep[k]["spill_loads"]:
                    find("SMEM006", "warning",
                         f"{k} spills; {rep[k]['spill_stores']} bytes "
                         f"stored, {rep[k]['spill_loads']} loaded", k)
        for k, (source, _, lb, _, _) in KERNELS.items():
            if source == fam.source:
                got = _launch_bounds_text(source, k)
                if got != lb:
                    find("SMEM004", "error", f"{k}'s __launch_bounds__ is "
                         f"({got}) in {source}, the model's ({lb})", k)
        n_shapes = n_launches = n_refused = 0
        for s in fam.sweep(sweep):
            n_shapes += 1
            cands = fam.designs(s)
            kept = [d for d in cands if not fam.refused(s, d)]
            if len(kept) < len(cands):  # the wrapper raises there
                n_refused += 1
                if not kept:
                    continue
            cands = kept
            shape = ", ".join(f"{k} {v}" for k, v in s.items()
                              if k != "streams")
            if lib is not None:
                for p in fam.plan(lib, s):
                    find("SMEM004", "error", p)
            for i, design in enumerate(cands):
                where = f"{design} at {shape or s}"
                for L in fam.launches(s, design):
                    n_launches += 1
                    use = kernels_seen.setdefault(
                        L.kernel, {"max_dynamic_smem": 0, "max_threads": 0,
                                   "max_cluster": 1})
                    use["max_dynamic_smem"] = max(use["max_dynamic_smem"],
                                                  L.smem)
                    use["max_threads"] = max(use["max_threads"], L.threads)
                    use["max_cluster"] = max(use["max_cluster"], L.cluster)
                    if L.smem > budget:
                        find("SMEM001", "error",
                             f"{design} models {L.smem} bytes of dynamic "
                             f"shared memory for {L.kernel}, more than the "
                             f"budget {budget}; {where}")
                    for p in _limits(L, fam, sources):
                        find("SMEM002", "error", f"{L.kernel}: {p}; {where}")
                    r = (rep or {}).get(L.kernel)
                    static = r["static_smem"] if r else STATIC_SMEM[L.kernel]
                    regs = r["registers"] if r else 0
                    if r and static + L.smem > ops.SMEM_LIMIT:
                        find("SMEM004", "error",
                             f"{L.kernel}: {static} bytes of static and "
                             f"{L.smem} of dynamic shared memory exceed "
                             f"{ops.SMEM_LIMIT}; {where}", L.kernel)
                    if r and regs * L.threads > SM_REGISTERS:
                        find("SMEM004", "error",
                             f"{L.kernel}: {regs} registers times "
                             f"{L.threads} threads exceed an SM's "
                             f"{SM_REGISTERS}; {where}", L.kernel)
                    if i == 0:
                        n = KERNELS[L.kernel][4]
                        sm = n * (L.smem + static + ops.BLOCK_RESERVED_SMEM)
                        if sm > ops.SM_SMEM_BYTES:
                            find("SMEM005", "error",
                                 f"{L.kernel}: {n} resident blocks of "
                                 f"{L.smem + static} bytes of shared "
                                 f"memory need {sm}, more than an SM's "
                                 f"{ops.SM_SMEM_BYTES}; {where}", L.kernel)
                        if n * L.threads * regs > SM_REGISTERS:
                            find("SMEM005", "error",
                                 f"{L.kernel}: {n} resident blocks of "
                                 f"{L.threads} threads at {regs} registers "
                                 f"need {n * L.threads * regs}, more than "
                                 f"an SM's {SM_REGISTERS}; {where}",
                                 L.kernel)
                for p in fam.cover(s, design):
                    find("SMEM003", "error", f"{design}: {p}; {where}")
        summary[fam.name] = {"kernels": fam.kernels, "shapes": n_shapes,
                             "launches": n_launches, "refused": n_refused}
    summary["report"] = {lib: rep for lib, rep in reports.items()}
    summary["kernels"] = kernels_seen
    return out
