"""The CRC-32 of the port's integrity record: the plain version of the CRC
kernel (``kernels.ref.crc32_plain``, the kernel's chunk-and-combine
arithmetic on the CPU) equals ``zlib.crc32`` bit for bit, and the port's
checksum records equal the reference's ``table_checksum`` and
``stacked_checksums`` of the same tables.

Cases: ragged lengths around the banked design's staging step (128 B),
the lane slice (2 KiB) and the chunk (64 KiB), several ranges of ragged
lengths, a layer of a segment-major
``[G2, L, V2, O]`` stack (strided: G2 ranges), float32, bfloat16 and
int32 tables, a continued CRC; a design forced on CPU tensors.  The
kernel itself (both chunk-pass designs) is held to ``zlib`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import pcilt as jp
from repro_torch.core import pcilt as tp
from repro_torch.interop import to_torch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (CRC_CHUNK_BYTES, CRC_LANE_BYTES,
                                     crc32_finish, crc32_plain, crc_multmodp,
                                     crc_operators, crc_shift, crc_tables)

#: the banked design's staging step (bytes of each lane slice a step)
STEP = 128
LANE, CHUNK = CRC_LANE_BYTES, CRC_CHUNK_BYTES
LENGTHS = [0, 1, 2, 15, 16, 17, STEP - 1, STEP, STEP + 1, LANE - 1, LANE,
           LANE + 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 7,
           5 * CHUNK - 3, 4_999_936, 3_000_001]


def _bytes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_crc_equals_zlib_on_ragged_lengths(n):
    b = _bytes(n, n)
    assert crc32_plain([torch.from_numpy(b)]) == zlib.crc32(b.tobytes())


@pytest.mark.parametrize("n", [1, LANE + 3, CHUNK + 1, 3 * CHUNK])
def test_plain_crc_continues_a_crc(n):
    b = _bytes(n, 7)
    prev = zlib.crc32(b"a preceding stream")
    assert crc32_plain([torch.from_numpy(b)], prev) == \
        zlib.crc32(b.tobytes(), prev)


@pytest.mark.parametrize("cuts", [[0], [1, 0, 5], [LANE - 1, 2, LANE + 1],
                                  [CHUNK - 3, 3, 17, CHUNK + 5, 1],
                                  [7] * 40 + [CHUNK],
                                  [STEP - 1, 2, STEP + 1]])
def test_plain_crc_over_many_ranges(cuts):
    """Ranges of ragged (and empty) lengths concatenate: the CRC is that of
    their bytes back to back, whatever the chunk and lane boundaries."""
    parts = [_bytes(n, i) for i, n in enumerate(cuts)]
    want = zlib.crc32(b"".join(p.tobytes() for p in parts))
    assert crc32_plain([torch.from_numpy(p) for p in parts]) == want
    # the wrapper's streams: one CRC each, empty ones included
    assert ops.pcilt_crc32([torch.from_numpy(p) for p in parts]) == \
        [zlib.crc32(p.tobytes()) for p in parts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_plain_crc_of_tables_by_dtype(dtype):
    """A table's bytes are its C-order storage: float32 as is, bfloat16 as
    its 16-bit words, int32 pointers as is."""
    rng = np.random.default_rng(3)
    if dtype == "int32":
        a = rng.integers(-5, 1000, size=(3, 37, 129)).astype(np.int32)
    else:
        a = rng.normal(size=(3, 37, 129)).astype(
            ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    t = to_torch(a)
    assert crc32_plain([t]) == zlib.crc32(a.tobytes())
    assert tp.table_checksum(t) == jp.table_checksum(a)


@pytest.mark.parametrize("shape", [(5, 3, 16, 24), (7, 4, 256, 13),
                                   (2, 24, 16, 40)])
def test_segment_major_layer_is_its_strided_ranges(shape):
    """A layer of a ``[G2, L, V2, O]`` stack is G2 contiguous segments
    ``L * V2 * O`` elements apart: the plain CRC of those ranges, the
    port's ``layer_checksum`` and the reference's checksum of the slice
    agree."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=shape).astype(np.float32)
    t = torch.from_numpy(a)
    for l in range(shape[1]):
        want = zlib.crc32(np.ascontiguousarray(a[:, l]).tobytes())
        assert crc32_plain([t[g, l] for g in range(shape[0])]) == want
        assert tp.layer_checksum(t, l, axis=1) == want
    assert tp.stacked_checksums(t, axis=1) == \
        jp.stacked_checksums(jnp.asarray(a), axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_records_equal_the_reference(dtype):
    """Layer-major stacks: the port's per-layer record (the conversion's)
    equals the reference's, byte for byte."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(4, 6, 16, 33)).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    t = to_torch(a)
    assert tp.stacked_checksums(t) == jp.stacked_checksums(jnp.asarray(a))
    assert tp.table_checksum(t) == jp.table_checksum(jnp.asarray(a))


def test_combine_arithmetic():
    """The host GF(2) pieces: a shift by n zero bytes, the level operators
    (a shift by a lane slice times 2**j) and zlib's inversions."""
    a, b = _bytes(LANE, 1).tobytes(), _bytes(999, 2).tobytes()
    # zlib's CRCs combine with the same shift (their inversions cancel)
    assert crc_shift(zlib.crc32(a), len(b)) ^ zlib.crc32(b) == \
        zlib.crc32(a + b)
    pure = crc32_finish(0, 0) ^ crc32_finish(0, 0)  # the empty stream
    assert pure == 0 and crc32_finish(0, 0) == zlib.crc32(b"")
    ops_ = crc_operators()
    v = 0x12345678
    shifted = 0
    for i in range(32):
        if v >> i & 1:
            shifted ^= int(ops_[3, i])
    assert shifted == crc_shift(v, LANE << 3)
    assert crc_multmodp(1 << 31, v) == v  # x^0 is the identity


def _pure(b: bytes) -> int:
    """The pure CRC (from 0, no inversions) of ``b``: zlib's inversions
    undone (``crc32_finish`` applies them, and is its own inverse)."""
    return crc32_finish(zlib.crc32(b), len(b))


def _shifted(level: int, v: int) -> int:
    op = crc_operators()[level]
    return int(np.bitwise_xor.reduce([op[i] for i in range(32)
                                      if v >> i & 1] or [np.uint32(0)]))


def test_slicing_by_4_folds_a_lane_slice():
    """The banked design's step: a word xored into the CRC, then four
    lookups (byte s of the word into ``T[3 - s]``) — the pure CRC of a
    lane slice folded 128 bytes a staging step, and two slices joined by
    the level-0 operator, as the chunk's shuffle tree joins lanes."""
    T = [[int(v) for v in row] for row in crc_tables()[:4]]
    b = _bytes(2 * LANE, 9).tobytes()

    def fold(data, c=0):
        for i in range(0, len(data), 4):
            x = c ^ int.from_bytes(data[i:i + 4], "little")
            c = (T[3][x & 0xFF] ^ T[2][x >> 8 & 0xFF] ^ T[1][x >> 16 & 0xFF]
                 ^ T[0][x >> 24])
        return c

    c = 0
    for step in range(0, LANE, STEP):  # a lane's 16 staging steps
        c = fold(b[step:step + STEP], c)
    assert c == _pure(b[:LANE])
    assert crc32_finish(c, LANE) == zlib.crc32(b[:LANE])
    assert _shifted(0, c) ^ fold(b[LANE:]) == _pure(b)


@pytest.mark.parametrize("variant", ["banked", "kept"])
def test_a_forced_crc_design_on_the_cpu_runs_the_plain_version(variant):
    """A design is forced on CUDA tensors only: on CPU tensors the wrapper
    runs the plain version whatever is forced, equal to zlib, and launches
    and counts nothing."""
    parts = [_bytes(n, n) for n in (STEP + 1, 3, CHUNK + 5)]
    seen = dict(ops.CRC_VARIANT_LAUNCHES), ops.LAUNCHES["crc32"]
    with ops._crc_forced(variant):
        got = ops.pcilt_crc32([torch.from_numpy(p) for p in parts])
    assert got == [zlib.crc32(p.tobytes()) for p in parts]
    assert (dict(ops.CRC_VARIANT_LAUNCHES), ops.LAUNCHES["crc32"]) == seen
    assert list(ops.CRC_VARIANTS) == ["banked", "kept"]


def test_unknown_forced_crc_design_is_refused():
    with pytest.raises(ValueError, match="unknown CRC variant"):
        with ops._crc_forced("sliced"):
            pass


def test_cpu_tensor_routes_to_zlib(monkeypatch):
    """A CPU tensor's checksum goes through ``zlib`` (and the wrapper's
    plain version launches nothing)."""
    t = torch.randn(4, 5)
    calls = []
    real = zlib.crc32
    monkeypatch.setattr(tp.zlib, "crc32",
                        lambda *a: calls.append(1) or real(*a))
    before = ops.LAUNCHES["crc32"]
    assert tp.table_checksum(t) == real(t.numpy().tobytes())
    assert calls
    assert ops.pcilt_crc32([t]) == [real(t.numpy().tobytes())]
    assert ops.LAUNCHES["crc32"] == before


@pytest.mark.parametrize("shape,layer", [((5, 3, 16, 24), 2),
                                         ((7, 4, 256, 13), 0),
                                         ((3, 1, 16, 8), 0)])
def test_range_streams_are_a_segment_major_layer(shape, layer):
    """``pcilt_crc32`` over ``(t, starts, length)`` streams (the monitor's
    CRC of a segment-major layer: G2 starts ``L`` segments apart) on the
    CPU: the bytes of ``t[:, layer]``; a stream of no range or of empty
    ranges is ``zlib.crc32(b"")``; ranges past the tensor's bytes raise."""
    t = torch.from_numpy(np.random.default_rng(6).normal(
        size=shape).astype(np.float32))
    seg = shape[2] * shape[3] * 4
    starts = layer * seg + shape[1] * seg * np.arange(shape[0])
    got = ops.pcilt_crc32([(t, starts, seg), (t, [], seg), (t, starts, 0)])
    assert got == [zlib.crc32(t[:, layer].contiguous().numpy().tobytes()),
                   0, 0]
    with pytest.raises(ValueError, match="exceed"):
        ops.pcilt_crc32([(t, starts + seg, shape[1] * seg)])
    with pytest.raises(ValueError, match="contiguous"):
        ops.pcilt_crc32([t.transpose(2, 3)])


def test_checksums_take_tables_and_layers_together():
    """``checksums`` of tables and of layers of layer-major and
    segment-major stacks in one call: each the reference's
    ``table_checksum`` of the table or slice; a continued ``table_checksum``
    is ``zlib.crc32`` continued."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(3, 5, 16, 7)).astype(np.float32)
    b = rng.normal(size=(4, 3, 16, 9)).astype(np.float32)
    c = rng.integers(0, 99, size=(11,)).astype(np.int32)
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    got = tp.checksums([(ta, 2, 0), (tb, 1, 1), tc, (tb, 0, 1)])
    assert got == [jp.table_checksum(a[2]), jp.table_checksum(b[:, 1]),
                   jp.table_checksum(c), jp.table_checksum(b[:, 0])]
    assert tp.table_checksum(ta, crc=1234) == zlib.crc32(a.tobytes(), 1234)
