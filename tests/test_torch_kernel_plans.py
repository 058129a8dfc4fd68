"""The launch plans of the hand-written kernels, in pure Python on the CPU.

The CUDA kernels cannot run here, but the arithmetic that decides what they
touch is mirrored in their wrappers: the bf16 flash-attention kernel's key
range per 64-row query tile and its mask test (``csrc/flash_attention.cu``
``key_tile_range``/``tile_needs_mask``), the RMSNorm kernel's
instantiation (``rmsnorm.launch_shape``) and the selective-scan kernel's
plan (``selective_scan.launch_plan``: lanes per channel, channels per block,
grid, shared memory), and the backward kernels' tiles and plans
(``query_tile_range``, ``bwd_tc_smem_bytes``, ``bwd_launch_plan``,
``rmsnorm.bwd_launch_shape``).  These tests hold the mirrors
against the mask and the widths they must cover.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss

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


# ---------------------------------------------------------------------------
# Selective scan: ``selective_scan.launch_plan`` against the kernel's mapping
# of threads to (b, d, n) and of lanes to the timesteps whose y they write.
# ---------------------------------------------------------------------------

def _owners(plan, di, n):
    """[di, n] int: how many lanes of a batch row's blocks hold each state,
    as the kernel maps them: thread tid of block (bx, b) is lane tid % L of
    group tid // L, which holds channels bx * channels + group * K + k
    (k < K) and states lane * N / L + p (p < N / L) of each; blocks (., b)
    work on batch row b alone."""
    per = n // plan.lanes
    bx, tid, k, p = np.meshgrid(np.arange(plan.grid[0]), np.arange(ss.THREADS),
                                np.arange(plan.per_lane), np.arange(per), indexing="ij")
    d = bx * plan.channels + tid // plan.lanes * plan.per_lane + k
    state = tid % plan.lanes * per + p
    live = d < di
    return np.bincount((d * n + state)[live], minlength=di * n).reshape(di, n)


@settings(max_examples=60, deadline=None)
@given(bsz=st.integers(1, 8), seq=st.integers(1, 4096), di=st.integers(1, 16384),
       n=st.sampled_from(ss.STATES), dtype=st.sampled_from(ss.DTYPES),
       aligned=st.booleans(), sms=st.integers(1, 200))
def test_scan_plan_gives_every_state_one_lane(bsz, seq, di, n, dtype, aligned, sms):
    plan = ss.launch_plan(bsz, seq, di, n, dtype, aligned=aligned, sms=sms)
    assert (plan.lanes, plan.per_lane) in ss.PLANS[n]
    assert ss.plan_fits(n, plan.lanes, plan.per_lane) and n % plan.lanes == 0
    assert plan.per_lane * n // plan.lanes <= 16   # states a lane holds
    assert plan.channels == ss.THREADS // plan.lanes * plan.per_lane
    assert plan.channels % 8 == 0                  # whole 16-byte vectors of bf16
    assert plan.grid == (-(-di // plan.channels), bsz)
    assert plan.smem_bytes == ss.smem_bytes(plan.channels, n, dtype.itemsize)
    assert plan.smem_bytes <= 227 * 1024           # an H100 block's shared memory
    width = 16 // dtype.itemsize
    assert plan.vec == (aligned and di % width == 0 and seq * n % width == 0)
    assert (_owners(plan, di, n) == 1).all()


@pytest.mark.parametrize("n", ss.STATES)
def test_scan_every_instantiated_plan_fits_a_block(n):
    full, small = ss.PLANS[n]
    assert full != small and all(ss.plan_fits(n, *p) for p in (full, small))
    for dtype in ss.DTYPES:
        for sms, want in ((1, full), (10**6, small)):
            plan = ss.launch_plan(3, 100, 1000, n, dtype, sms=sms)
            assert (plan.lanes, plan.per_lane) == want
            assert plan.smem_bytes <= 227 * 1024
            assert (_owners(plan, 1000, n) == 1).all()


@pytest.mark.parametrize("shape,plan", [
    ((1, 1536, 3200, 16), (8, 2, 32)),   # hymba-1.5b, batch 1: 50 blocks of 64 channels
    ((2, 1536, 3200, 16), (8, 2, 32)),   # batch 2: 100
    ((1, 512, 8192, 16), (8, 2, 32)),    # falcon-mamba-7b, batch 1: 128
    ((2, 40, 4, 16), (8, 2, 32)),
    ((1, 70, 100, 8), (4, 2, 64)),
    ((2, 64, 20, 4), (4, 2, 64)),
])
def test_scan_plan_small_grids_take_the_smallest_blocks(shape, plan):
    # a grid of the first plan with fewer blocks than SMs takes the second,
    # whose blocks hold half the channels
    assert ss.launch_plan(*shape)[:3] == plan


@pytest.mark.parametrize("shape,plan", [
    ((4, 1536, 3200, 16), (4, 2, 64, (50, 4), 49152, True)),    # hymba-1.5b prefill
    ((4, 512, 8192, 16), (4, 2, 64, (128, 4), 49152, True)),    # falcon-mamba-7b prefill
])
def test_scan_plan_at_serving_shapes(shape, plan):
    # 8 states a lane, 4 of each of 2 channels; a block for every SM
    got = ss.launch_plan(*shape)
    assert tuple(got) == plan
    assert got.per_lane * 16 // got.lanes == 8
    assert got.grid[0] * got.grid[1] >= ss.SMS


@pytest.mark.parametrize("sms,lanes", [(132, 8), (128, 4), (114, 4), (1, 4)])
def test_scan_plan_follows_the_cards_sm_count(sms, lanes):
    # falcon-mamba-7b at batch 1 has 128 blocks of 64 channels: enough for
    # a card of 128 SMs or fewer (an H100 PCIe has 114), not for 132
    assert ss.launch_plan(1, 512, 8192, 16, sms=sms).lanes == lanes


@pytest.mark.parametrize("n,lanes,per_lane", [(16, 4, 2), (8, 2, 2), (4, 2, 2)])
def test_scan_plan_holds_eight_states_a_lane(n, lanes, per_lane):
    # N = 16 and 8: 8 states a lane; N = 4 keeps 128 channels a block
    plan = ss.launch_plan(4, 512, 8192, n)
    assert (plan.lanes, plan.per_lane) == (lanes, per_lane)


@pytest.mark.parametrize("bsz,seq,di,n,dtype", [
    (1, 8, 8, 2, torch.float32),          # N not instantiated
    (1, 8, 8, 32, torch.float32),
    (65536, 1, 8, 4, torch.float32),      # past the grid's y limit
    (1, 0, 8, 4, torch.float32),          # empty
    (1, 8, 0, 4, torch.float32),
    (1, 8, 8, 4, torch.float16),          # dtype not instantiated
])
def test_scan_plan_refuses(bsz, seq, di, n, dtype):
    with pytest.raises(ValueError):
        ss.launch_plan(bsz, seq, di, n, dtype)


# -- the backward kernels' plans ----------------------------------------------------

# The backward's tiles: the bf16 tensor-core kernels' 64-row query tiles by
# 64-key tiles, and the f32 SIMT kernels' 16 by 32.
BWD_TILES = [(fa.BWD_BLOCK_Q, fa.BWD_BLOCK_K), (fa.SIMT_BWD_BLOCK_Q, fa.SIMT_BWD_BLOCK_K)]


@pytest.mark.parametrize("block_q,block_k", BWD_TILES)
@settings(max_examples=200, deadline=None)
@given(sq=st.integers(1, 200), sk=st.integers(1, 200), causal=st.booleans(),
       window=st.integers(0, 80))
def test_bwd_tile_ranges_cover_every_admitted_pair(block_q, block_k, sq, sk, causal, window):
    """The dK/dV blocks' query rows (query_tile_range, block_q-row tiles per
    block_k-key tile) and the dQ blocks' keys (key_tile_range, block_k-key
    tiles per block_q-row tile) each reach every pair the mask admits."""
    ok = _admitted(sq, sk, causal, window)
    by_key = np.zeros_like(ok)
    for k0 in range(0, sk, block_k):
        begin, end = fa.query_tile_range(k0, sq, sk, causal, window, block_q=block_q,
                                         block_k=block_k)
        assert begin % block_q == 0
        by_key[begin:end, k0:k0 + block_k] = True
    by_query = np.zeros_like(ok)
    for q0 in range(0, sq, block_q):
        begin, end = fa.key_tile_range(q0, sq, sk, causal, window,
                                       block_q=block_q, block_k=block_k)
        by_query[q0:q0 + block_q, begin:end] = True
    assert not (ok & ~by_key).any()
    assert not (ok & ~by_query).any()


@pytest.mark.parametrize("block_q,block_k", BWD_TILES)
def test_bwd_query_range_skips_whole_tiles_outside_the_window(block_q, block_k):
    # hymba's training shape: a key tile sees at most window + block_k query rows
    for k0 in range(0, 2048, block_k):
        begin, end = fa.query_tile_range(k0, 2048, 2048, True, 1024, block_q=block_q,
                                         block_k=block_k)
        assert end - begin <= 1024 + block_k + block_q


def test_bwd_tiles_default_to_the_tensor_core_kernels():
    assert (fa.BWD_BLOCK_Q, fa.BWD_BLOCK_K) == (fa.BLOCK_Q, fa.BLOCK_K) == (64, 64)
    assert fa.query_tile_range(128, 2048, 2048, True, 1024) == \
        fa.query_tile_range(128, 2048, 2048, True, 1024, block_q=64, block_k=64) == (128, 1215)


@pytest.mark.parametrize("shape,splits", [
    ((2, 25, 5, 2048, 2048, True, 1024), 1),  # hymba-1.5b: the window evens the key tiles out
    ((4, 14, 2, 2048, 2048, True, 0), 3),     # qwen2-0.5b: key tile 0 sees 32 query tiles, the last 1
    ((4, 14, 2, 2048, 2048, False, 0), 1),    # no mask: every key tile sees every query tile
    ((1, 4, 4, 128, 128, True, 0), 1),        # no GQA group to cut
    ((1, 14, 2, 96, 96, True, 0), 7),         # a grid far under the card: every head its block
])
def test_bwd_gqa_splits(shape, splits):
    assert fa.bwd_gqa_splits(*shape) == splits


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 4), kh=st.integers(1, 4), group=st.integers(1, 8),
       sq=st.integers(1, 3000), sk=st.integers(1, 3000), causal=st.booleans(),
       window=st.one_of(st.just(0), st.integers(1, 2000)), sms=st.integers(1, 200))
def test_bwd_gqa_chunks_cover_every_head_once(b, kh, group, sq, sk, causal, window, sms):
    """The dK/dV kernel's chunk c of a split group takes heads [c * per,
    min(group, (c + 1) * per)), per = ceil(group / splits): together every
    head of the group, each once."""
    splits = fa.bwd_gqa_splits(b, kh * group, kh, sq, sk, causal, window, sms=sms)
    assert 1 <= splits <= group
    per = -(-group // splits)
    heads = [h for c in range(splits) for h in range(c * per, min(group, (c + 1) * per))]
    assert heads == list(range(group))


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_bwd_tc_shared_memory_fits_a_block(hd):
    dkdv, dq = fa.bwd_tc_smem_bytes(hd)
    assert dq == 6 * 64 * hd * 2              # Q, dO and 2 stages of K and V, bf16
    assert dkdv == dq + 2 * 2 * 64 * 4        # K, V, 2 stages of Q, dO, lse and D
    assert max(dkdv, dq) <= 227 * 1024        # an H100 block's dynamic shared memory
    assert 2 * max(dkdv, dq) <= 228 * 1024    # two blocks an SM (launch bounds)


# The RMSNorm backward (csrc/rms_norm_bwd.cu): register path (vectors a
# lane, warps a row) or streaming path (per_lane 0, one warp a row), by d,
# dtype and alignment.  The C instantiates only rn.BWD_PLANS (``picked``).
@pytest.mark.parametrize("d,dtype,aligned,plan", [
    (1600, torch.bfloat16, True, (4, 2)),     # hymba-1.5b: 200 vectors over 2 warps
    (896, torch.bfloat16, True, (4, 1)),      # qwen2-0.5b: 112 vectors, one warp
    (4096, torch.bfloat16, True, (4, 4)),     # falcon-mamba-7b: 512 vectors over 4 warps
    (4104, torch.bfloat16, True, (0, 1)),     # one vector past the register path
    (8192, torch.bfloat16, True, (0, 1)),     # streams
    (2048, torch.float32, True, (4, 4)),      # the widest f32 row in registers
    (4096, torch.float32, True, (0, 1)),
    (1001, torch.bfloat16, True, (0, 1)),     # d % 8 != 0: scalar loads
    (1600, torch.bfloat16, False, (0, 1)),    # a view off 16 bytes: scalar loads
    (64, torch.bfloat16, True, (1, 1)),
    (512, torch.bfloat16, True, (2, 1)),
    (1024, torch.float32, True, (4, 2)),      # 256 vectors: two warps' 4 a lane
    (1028, torch.float32, True, (4, 4)),      # 257: one past them, over 4 warps
])
def test_norm_bwd_register_or_streaming_path(d, dtype, aligned, plan):
    shape = rn.bwd_launch_shape(64, d, dtype, aligned=aligned)
    assert (shape.per_lane, shape.split) == plan
    width = 16 // dtype.itemsize
    assert shape.vec == (aligned and d % width == 0)
    if shape.per_lane:
        assert (shape.per_lane, shape.split) in rn.BWD_PLANS
        assert 32 * shape.split * shape.per_lane * width >= d > 0  # the team holds the row
        assert shape.warps == rn.BWD_WARPS and shape.warps % shape.split == 0


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 20000), d=st.integers(1, rn.MAX_D), dtype=st.sampled_from(rn.DTYPES),
       aligned=st.booleans(), sms=st.integers(1, 200))
def test_norm_bwd_every_plan_is_instantiated_and_covers_its_rows(rows, d, dtype, aligned, sms):
    shape = rn.bwd_launch_shape(rows, d, dtype, aligned=aligned, sms=sms)
    width = 16 // dtype.itemsize
    if shape.per_lane:
        assert shape.vec and (shape.per_lane, shape.split) in rn.BWD_PLANS
        need = -(-d // width // 32) if d % width == 0 else None
        # the fewest vectors a lane, over the fewest warps a row, that hold it
        assert shape.split == min(s for s in rn.BWD_SPLITS if need <= s * rn.BWD_PER_LANE[-1])
        assert shape.per_lane * shape.split >= need
    else:
        assert shape.split == 1 and (not shape.vec or d > 32 * 16 * width)
    teams = shape.warps // shape.split
    assert rn.bwd_smem_bytes(shape, d) <= 227 * 1024 - 128
    assert 1 <= shape.blocks <= rn.BWD_BLOCKS_PER_SM * sms
    # every row has a team: one row a team, or every block's teams busy
    assert shape.blocks * teams >= rows or shape.blocks == rn.BWD_BLOCKS_PER_SM * sms
    assert (shape.blocks - 1) * teams < rows


@pytest.mark.parametrize("d,dtype,warps", [
    (rn.MAX_D, torch.float32, 1),       # 226 KB of f32: one warp, one row of ds
    (57000, torch.bfloat16, 1),
    (20000, torch.float32, 2),
    (8192, torch.bfloat16, 4),          # 8 warps would need 256 KB
    (4096, torch.float32, 8),
    (4096, torch.bfloat16, 8),          # the register path: 2 teams of 4 warps
])
def test_norm_bwd_shared_memory_fits_a_block(d, dtype, warps):
    shape = rn.bwd_launch_shape(16, d, dtype)
    assert shape.warps == warps
    assert rn.bwd_smem_bytes(shape, d) == warps // shape.split * d * 4
    assert rn.bwd_smem_bytes(shape, d) <= 227 * 1024 - 128  # beside the split rows' sums
    if warps < rn.BWD_WARPS:  # the next wider block would not fit
        assert 2 * warps * d * 4 > 227 * 1024 - 128


@pytest.mark.parametrize("rows,d,sms,blocks", [
    (4096, 1600, 132, 264),   # hymba-1.5b's training rows: one wave, two blocks an SM
    (8192, 896, 132, 264),    # qwen2-0.5b's
    (4096, 4096, 132, 264),   # falcon-mamba-7b's
    (4096, 1600, 114, 228),   # a card of 114 SMs
    (100, 1600, 132, 25),     # 4 teams a block, one row each
    (3, 896, 132, 1),         # fewer rows than a block's 8 teams
    (1, 4096, 132, 1),
    (64, 8192, 132, 16),      # streaming, 4-warp blocks
])
def test_norm_bwd_grid_against_the_sm_count(rows, d, sms, blocks):
    assert rn.bwd_launch_shape(rows, d, torch.bfloat16, sms=sms).blocks == blocks


@pytest.mark.parametrize("x_dtype", rn.DTYPES)
@pytest.mark.parametrize("scale_dtype", rn.DTYPES)
def test_norm_bwd_registers_at_falcon_width(x_dtype, scale_dtype):
    # d = 4096 (2048 in f32), the widest row the register path holds: a
    # lane's x, dy, scale and ds sums take at most 96 of the 128 registers a
    # thread has at two 8-warp blocks an SM (ptxas read 124-128 in all on an
    # H100), far under the 255 a thread may use
    d = 4096 if x_dtype == torch.bfloat16 else 2048
    shape = rn.bwd_launch_shape(4096, d, x_dtype)
    words = rn.bwd_registers(shape.per_lane, x_dtype, scale_dtype)
    assert shape.per_lane == 4 and words <= 96 < 255
    assert rn.bwd_registers(8, x_dtype, scale_dtype) > 96  # why 8 a lane is not a plan


@pytest.mark.parametrize("n", ss.STATES)
def test_scan_bwd_every_plan_fits_a_block(n):
    lanes, per_lane = ss.BWD_PLANS[n]
    assert ss.bwd_plan_fits(n, lanes, per_lane)
    for dtype in ss.DTYPES:
        assert ss.bwd_smem_bytes(n, lanes, per_lane, dtype.itemsize) <= 227 * 1024
    assert ss.CKPT_STEPS % 16 == 0 and ss.CHUNK % ss.CKPT_STEPS == 0


def test_scan_bwd_chunks_hold_whole_segments():
    # the staged walk recomputes whole CKPT_STEPS segments inside a CHUNK,
    # and its reduce-scatters run over L lanes and 32 / L groups of steps
    # that a segment holds whole
    assert ss.CHUNK % ss.CKPT_STEPS == 0
    for n in ss.STATES:
        lanes = ss.BWD_PLANS[n][0]
        assert ss.CKPT_STEPS % max(lanes, 32 // lanes) == 0


@settings(max_examples=60, deadline=None)
@given(bsz=st.integers(1, 8), seq=st.integers(1, 4096), di=st.integers(1, 16384),
       n=st.sampled_from(ss.STATES), dtype=st.sampled_from(ss.DTYPES),
       aligned=st.booleans())
def test_scan_bwd_plan_gives_every_state_one_lane(bsz, seq, di, n, dtype, aligned):
    plan = ss.bwd_launch_plan(bsz, seq, di, n, dtype, aligned=aligned)
    assert (plan.lanes, plan.per_lane) == ss.BWD_PLANS[n]
    assert plan.channels == ss.THREADS // plan.lanes * plan.per_lane
    assert plan.channels % 8 == 0                  # whole 16-byte vectors of bf16
    assert plan.grid == (-(-di // plan.channels), bsz)
    assert plan.smem_bytes == ss.bwd_smem_bytes(n, plan.lanes, plan.per_lane, dtype.itemsize)
    assert plan.smem_bytes <= 227 * 1024
    width = 16 // dtype.itemsize
    assert plan.vec == (aligned and di % width == 0 and seq * n % width == 0)
    assert (_owners(plan, di, n) == 1).all()


@pytest.mark.parametrize("shape,plan", [
    ((2, 2048, 3200, 16), (8, 2, 32, (100, 2))),    # hymba-1.5b training microbatch
    ((2, 2048, 8192, 16), (8, 2, 32, (256, 2))),    # falcon-mamba-7b's
    ((1, 2048, 3200, 16), (8, 2, 32, (100, 1))),    # a grid of fewer blocks than SMs
    ((2, 96, 64, 8), (4, 1, 32, (2, 2))),
    ((2, 64, 20, 4), (4, 1, 32, (1, 2))),
])
def test_scan_bwd_plan_at_training_shapes(shape, plan):
    got = ss.bwd_launch_plan(*shape)
    assert tuple(got)[:4] == plan
    assert (_owners(got, shape[2], shape[3]) == 1).all()


def test_scan_bwd_plan_refuses():
    with pytest.raises(ValueError, match="state size 32"):
        ss.bwd_launch_plan(2, 64, 64, 32)
    with pytest.raises(ValueError):
        ss.bwd_launch_plan(65536, 1, 8, 4)
