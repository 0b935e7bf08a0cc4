"""The staged conv design's host side, on the CPU: which design serves a
table shape, the staged tiling and its shared memory, and the code
pre-pass's plain version against the JAX package's quantizer.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``); ``kernels.ops`` checks at the library's
first launch that its tiling is this module's mirror of it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quantization as jq
from repro_torch.core import quantization as tq
from repro_torch.core.lut_layers import conv_same_pads, pad_nhwc
from repro_torch.kernels import ops

#: (bits, group) of the paper CNN (8-bit, group 1) and of the card tests
#: (4-bit and 2-bit at group 2), with the other packings of V <= 256
STAGED_PACKINGS = [(8, 1), (4, 2), (2, 2), (2, 4), (1, 8), (3, 2), (2, 3)]
#: packings whose offsets do not fit a byte: the kept ("direct") kernel
DIRECT_PACKINGS = [(8, 2), (4, 4), (5, 2), (3, 3), (2, 8)]
#: (P, O) of the paper CNN's five layers at 1024x768, and ragged shapes of
#: the card tests: B = 2 images of 9x11 at stride 2 (P 60), a P one past a
#: pixel tile, a tile short of one, conv0's and conv4's O
TILE_SHAPES = [(786432, 50), (786432, 80), (786432, 120), (786432, 200),
               (786432, 350), (60, 13), (1025, 350), (3071, 50), (1, 1),
               (2 * 40 * 40, 350)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("bits,group", STAGED_PACKINGS)
def test_byte_offsets_are_staged_within_a_blocks_shared_memory(
        itemsize, bits, group):
    V = 1 << (bits * group)
    assert ops.conv_variant(V, itemsize) == "staged"
    assert ops.staged_smem_bytes(itemsize) <= ops.SMEM_LIMIT == 232448


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("bits,group", DIRECT_PACKINGS)
def test_large_v_takes_the_kept_kernel(itemsize, bits, group):
    assert ops.conv_variant(1 << (bits * group), itemsize) == "direct"


def test_staged_shared_memory_layout():
    """float32: two 64 KB blocks of 256 rows x 256 bytes (two 32-column
    slots side by side), bf16: one block (four slots); then 8 slots of 1024
    offset bytes and of a 256-byte row mask."""
    rings = ops.STAGED_OFF_RING * (ops.STAGED_PIX_TILE + ops.STAGED_MAX_V)
    assert ops.staged_smem_bytes(4) == 2 * 65536 + rings == 141312
    assert ops.staged_smem_bytes(2) == 65536 + rings == 75776


@pytest.mark.parametrize("P,O", TILE_SHAPES)
def test_staged_tiles_cover_every_output_once(P, O):
    """Each column tile's pixel tiles partition [0, P), the column tiles
    partition [0, O), and consecutive blocks share a column tile (the
    blocks resident together walk one O tile's table)."""
    n_ptiles, n_otiles = ops.staged_tiles(P, O)
    seen = {}
    for i in range(n_ptiles * n_otiles):
        (p0, p1), (o0, o1) = ops.staged_block_tile(i, P, O)
        assert 0 <= p0 < p1 <= P and 0 <= o0 < o1 <= O
        assert p1 - p0 <= ops.STAGED_PIX_TILE
        assert o1 - o0 <= ops.STAGED_COL_TILE
        seen.setdefault((o0, o1), []).append((p0, p1))
        if i % n_ptiles:
            assert ops.staged_block_tile(i - 1, P, O)[1] == (o0, o1)
    cols = sorted(seen)
    assert cols[0][0] == 0 and cols[-1][1] == O
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    for ranges in seen.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == P
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def _padded_image(seed, B, H, W, C, k, stride, scale, bits):
    """A seeded NHWC image with some values on exact .5 code steps,
    padded SAME as the conv wrappers pad it."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=(B, H, W, C))).astype(np.float32)
    ties = ((rng.integers(-(1 << bits), 1 << bits, size=x.size // 3)
             + np.float32(0.5)) * np.float32(scale)).astype(np.float32)
    x.reshape(-1)[:ties.size] = ties
    xt = torch.from_numpy(x)
    return pad_nhwc(xt, conv_same_pads(H, W, k, k, stride))


@pytest.mark.parametrize("bits,sym", [(8, False), (8, True), (4, True),
                                      (4, False), (2, True)])
@pytest.mark.parametrize("B,H,W,C,k,stride", [(1, 12, 16, 1, 5, 1),
                                              (2, 9, 11, 3, 3, 2),
                                              (1, 7, 6, 50, 5, 1)])
def test_code_prepass_plain_matches_jax_quantize(bits, sym, B, H, W, C, k,
                                                 stride):
    """The pre-pass's plain version: codes ``[B, C, Hp, Wp]`` of the padded
    image, bit-equal to ``repro.core.quantization.quantize`` on the same
    image transposed, ties included (a power-of-two scale makes them
    exact)."""
    scale = np.float32(0.25)
    xp = _padded_image(bits * 7 + C, B, H, W, C, k, stride, scale, bits)
    got = ops.conv_codes_plain(xp, tq.QuantSpec(bits, sym), float(scale))
    want = np.asarray(jq.quantize(jnp.asarray(xp.numpy()),
                                  jq.QuantSpec(bits, sym),
                                  jnp.float32(scale)))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (xp.shape[0], C, xp.shape[1], xp.shape[2])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_code_prepass_on_the_cpu_is_its_plain_version():
    spec = tq.QuantSpec(8, False)
    xp = _padded_image(3, 1, 8, 8, 4, 5, 1, np.float32(0.5), 8)
    assert torch.equal(ops._conv_codes(xp, spec, 0.5),
                       ops.conv_codes_plain(xp, spec, 0.5))


def test_a_forced_variant_on_the_cpu_runs_the_plain_version():
    """``variant=`` picks a kernel on the card only: a CPU tensor runs the
    plain version whatever it names."""
    spec = tq.QuantSpec(4, True)
    x = torch.zeros(1, 5, 5, 2)
    tabs = torch.zeros(25, 256, 3)
    out = ops._fused_conv2d(x, tabs, spec, 0.5, 2, 5, 5, variant="direct")
    assert torch.equal(out, ops.pcilt_fused_conv2d(x, tabs, spec, 0.5, 2, 5,
                                                   5))
