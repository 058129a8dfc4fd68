"""The launch plans of the hand-written kernels, in pure Python on the CPU.

The CUDA kernels cannot run here, but the arithmetic that decides what they
touch is mirrored in their wrappers: the bf16 flash-attention kernel's key
range per 64-row query tile and its mask test (``csrc/flash_attention.cu``
``key_tile_range``/``tile_needs_mask``), and the RMSNorm kernel's
instantiation (``rmsnorm.launch_shape``).  These tests hold the mirrors
against the mask and the widths they must cover.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

torch.set_num_threads(1)


def _admitted(sq, sk, causal, window):
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), dtype=bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    return ok


def _visited(sq, sk, causal, window):
    """[sq, sk] bool: the pairs the kernel scores, and [sq, sk] bool: the
    pairs it scores in a tile it runs without the mask."""
    seen = np.zeros((sq, sk), dtype=bool)
    unmasked = np.zeros((sq, sk), dtype=bool)
    for q0 in range(0, sq, fa.BLOCK_Q):
        rows = slice(q0, min(q0 + fa.BLOCK_Q, sq))
        begin, end = fa.key_tile_range(q0, sq, sk, causal, window)
        for kt in range(begin, end, fa.BLOCK_K):
            keys = slice(kt, min(kt + fa.BLOCK_K, sk))
            seen[rows, keys] = True
            if not fa.tile_needs_mask(q0, kt, sq, sk, causal, window):
                assert kt + fa.BLOCK_K <= sk  # an unmasked tile holds no key past sk
                unmasked[rows, keys] = True
    return seen, unmasked


@settings(max_examples=300, deadline=None)
@given(sq=st.integers(1, 300), sk=st.integers(1, 300), causal=st.booleans(),
       window=st.one_of(st.just(0), st.integers(1, 320)))
def test_key_tile_range_visits_every_admitted_pair(sq, sk, causal, window):
    ok = _admitted(sq, sk, causal, window)
    seen, unmasked = _visited(sq, sk, causal, window)
    assert not (ok & ~seen).any()        # the mask admits nothing the loop skips
    assert not (unmasked & ~ok).any()    # an unmasked tile holds only admitted pairs


@pytest.mark.parametrize("sq,sk,causal,window,tiles", [
    (512, 512, True, 0, 36),         # qwen2-0.5b prefill: 1 + 2 + ... + 8 tiles
    (1536, 1536, True, 1024, 272),   # hymba-1.5b prefill: 136 + 8 x 17 tiles
    (100, 300, False, 0, 10),        # Sq != Sk, no mask: every key tile
])
def test_key_tile_range_at_serving_shapes(sq, sk, causal, window, tiles):
    count = 0
    for q0 in range(0, sq, fa.BLOCK_Q):
        begin, end = fa.key_tile_range(q0, sq, sk, causal, window)
        count += -(-(end - begin) // fa.BLOCK_K)
    assert count == tiles
    seen, _ = _visited(sq, sk, causal, window)
    assert not (_admitted(sq, sk, causal, window) & ~seen).any()


def test_interior_tiles_run_unmasked():
    # hymba's shape: of a query tile's 17 key tiles, the diagonal one and the
    # one the window's far edge falls in are masked; the 15 between are not
    q0 = 1472
    begin, end = fa.key_tile_range(q0, 1536, 1536, True, 1024)
    masked = [kt for kt in range(begin, end, fa.BLOCK_K)
              if fa.tile_needs_mask(q0, kt, 1536, 1536, True, 1024)]
    assert (begin, end, masked) == (448, 1536, [448, 1472])


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_tc_shared_memory_fits_a_block(hd):
    smem = fa.tc_smem_bytes(hd)
    assert smem == 640 * hd            # Q tile + 2 stages of K and V, bf16
    assert smem <= 227 * 1024          # an H100 block's dynamic shared memory


@pytest.mark.parametrize("dtype", rn.DTYPES)
def test_launch_shape_covers_every_d(dtype):
    width = 16 // dtype.itemsize
    for d in range(1, rn.MAX_D + 1):
        vec, per_lane, blocks = rn.launch_shape(7, d, dtype)
        assert vec == (d % width == 0) and blocks == 1
        if per_lane:  # the row in registers: a lane's vectors cover it
            assert vec and per_lane in rn.PER_LANE
            assert 32 * per_lane * width >= d > 16 * per_lane * width or per_lane == 1
        else:         # the streaming path: only past the register limit, or scalar
            assert not vec or d > 32 * max(rn.PER_LANE) * width
    limit = {torch.bfloat16: 4096, torch.float32: 2048}[dtype]
    assert rn.launch_shape(1, limit, dtype).per_lane == 16
    assert rn.launch_shape(1, limit + width, dtype).per_lane == 0


@pytest.mark.parametrize("rows,blocks", [(1, 1), (4, 1), (9, 2), (2048, 256),
                                         (6144, rn.MAX_BLOCKS)])
def test_launch_shape_grid(rows, blocks):
    shape = rn.launch_shape(rows, 1600, torch.bfloat16)
    assert shape.blocks == blocks
    # no block without a row; past MAX_BLOCKS the warps loop over more rows
    assert (shape.blocks - 1) * rn.WARPS * rn.ROWS_PER_WARP < rows


def test_launch_shape_unaligned_takes_scalar_loads():
    assert rn.launch_shape(4, 4096, torch.bfloat16, aligned=False) == (False, 0, 1)
