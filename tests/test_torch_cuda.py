"""The hand-written CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card.  Imports no JAX, so it runs
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss

pytestmark = pytest.mark.cuda

CASES = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 2, 1, 96, 96, 16, False, 0),
    (1, 4, 2, 128, 128, 32, True, 32),
    (1, 2, 2, 80, 112, 32, False, 0),
    (4, 14, 2, 512, 512, 64, True, 0),    # qwen2-0.5b prefill
    (1, 2, 1, 33, 47, 128, True, 0),      # hd 128, ragged, Sq != Sk
    # edges of the bf16 kernel's 64-row query tiles and 64-key tiles
    (1, 2, 1, 100, 150, 64, True, 0),      # ragged Sq and Sk, Sq < Sk
    (1, 2, 2, 130, 70, 64, False, 0),      # ragged, Sq > Sk, no mask
    (2, 4, 2, 65, 65, 64, True, 0),        # one row past a tile
    (1, 4, 2, 300, 300, 64, True, 100),    # window mid-tile
    (1, 2, 1, 200, 230, 32, False, 37),    # window without causal, Sq != Sk
    (1, 10, 2, 128, 128, 64, True, 0),     # GQA group 5
    (1, 14, 2, 96, 96, 64, True, 0),       # GQA group 7
    (2, 2, 1, 128, 128, 16, True, 0),      # hd 16
    (1, 4, 2, 192, 192, 32, True, 0),      # hd 32
    (1, 2, 1, 160, 200, 128, True, 70),    # hd 128, window, Sq != Sk
    (2, 3, 1, 40, 40, 64, True, 0),        # one query tile only
    (1, 2, 2, 1, 77, 64, False, 0),        # a single query row
    (4, 25, 5, 1536, 1536, 64, True, 1024),  # hymba-1.5b prefill
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    return torch.device("cuda")


def _inputs(b, h, kh, sq, sk, hd, dtype, device, seed=7):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,sq,sk,hd,causal,window", CASES)
def test_kernel_matches_plain_version(cuda, b, h, kh, sq, sk, hd, causal,
                                      window, dtype):
    q, k, v = _inputs(b, h, kh, sq, sk, hd, dtype, cuda)
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_refuses_a_misaligned_view(cuda, dtype):
    shape = (1, 2, 64, 64)
    n = 1 * 2 * 64 * 64
    buf = torch.randn(n + 8, device=cuda).to(dtype)
    q = buf[1:n + 1].view(shape)  # contiguous, one element off 16 bytes
    k = v = torch.randn(shape, device=cuda).to(dtype)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, k, v)
    assert fa.launches == before
    out = fa.flash_attention(q.clone(), k, v)  # the same values, aligned
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.attention_ref(q, k, v).float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_auto_attention_takes_the_kernel_on_the_card(cuda):
    from repro_torch.models import layers

    q, k, v = _inputs(2, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    before = fa.launches
    out = layers.attention(q, k, v, causal=True, impl="auto")
    assert fa.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])
    # no give-way to a plain path on the card: what the kernel refuses raises
    with pytest.raises(ValueError, match="head dim"):
        layers.attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                         v[..., :24].contiguous(), impl="auto")
    assert fa.launches == before + 1


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _inputs(1, 4, 2, 16, 16, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                           v[..., :24].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(q[:, :3].contiguous(), k, v)


# Selective scan: the sweep of test_kernels.py, a ragged DI, and hymba-1.5b's
# DI at a ragged S.  Tolerances as test_kernels.py.
SCAN_CASES = [
    (2, 64, 32, 8),
    (1, 96, 64, 16),
    (2, 50, 32, 4),
    (1, 100, 200, 16),
    (2, 257, 3200, 16),
]
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _scan_inputs(b, s, di, n, dtype, device, seed=7):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    u, bm, cm = randn(b, s, di), randn(b, s, n), randn(b, s, n)
    dt = torch.nn.functional.softplus(randn(b, s, di))
    a = -torch.exp(0.3 * randn(di, n))
    d = 1.0 + 0.1 * randn(di)
    return [u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype), d]


def _scan_agrees(args, dtype):
    before = ss.launches
    y, h = ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    want_y, want_h = ref.selective_scan_ref(*args)
    tol = SCAN_TOL[dtype]
    for got, want in ((y, want_y), (h, want_h)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,di,n", SCAN_CASES)
def test_scan_kernel_matches_plain_version(cuda, b, s, di, n, dtype):
    _scan_agrees(_scan_inputs(b, s, di, n, dtype, cuda), dtype)


# Edges of the lanes-per-channel design (launch_plan: L lanes share K
# channels, 128 / L * K channels a block, 64-step chunks, 16-byte copies
# where aligned, y stored K values at a time where DI allows).
SCAN_EDGES = [
    (1, 1, 64, 16),      # S = 1
    (2, 45, 96, 16),     # S no multiple of the chunk or of L
    (3, 65, 48, 8),      # one step past a chunk
    (2, 40, 4, 16),      # DI under a block's 32 channels; bf16 rows unaligned
    (1, 70, 100, 8),     # DI no multiple of a block's 64 channels
    (2, 64, 20, 4),      # N = 4 at L = 4, DI under a block's 64 channels
    (1, 31, 24, 4),      # N = 4, odd S: bf16 B/C rows unaligned, plain loads
    (4, 96, 3200, 16),   # hymba-1.5b's DI: L = 4, K = 2
    (4, 70, 3199, 16),   # K = 2 with an odd DI: the last group half live
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,di,n", SCAN_EDGES)
def test_scan_kernel_edges(cuda, b, s, di, n, dtype):
    _scan_agrees(_scan_inputs(b, s, di, n, dtype, cuda), dtype)


# Each instantiated plan (ss.PLANS), reached by shape: a grid that fills the
# card takes the first plan of its N, a small one the second.
SCAN_PLANS = [(n, i) for n in ss.STATES for i in range(2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,which", SCAN_PLANS)
def test_scan_kernel_every_plan(cuda, n, which, dtype):
    args = _scan_inputs(*((8, 70, 4000, n) if which == 0 else (2, 70, 200, n)), dtype, cuda)
    plan = ss._check(*args)
    assert (plan.lanes, plan.per_lane) == ss.PLANS[n][which]
    _scan_agrees(args, dtype)


def test_scan_plan_of_the_edges(cuda):
    assert ss.launch_plan(2, 64, 20, 4).lanes == 4       # the most N = 4 allows
    assert ss.launch_plan(2, 40, 4, 16, torch.bfloat16).vec is False
    assert ss.launch_plan(1, 31, 24, 4, torch.bfloat16).vec is False
    assert ss.launch_plan(1, 31, 24, 4, torch.float32).vec is True
    assert ss.launch_plan(4, 70, 3199, 16)[:2] == (4, 2)


def test_scan_kernel_f32_at_hymba_shape(cuda):
    _scan_agrees(_scan_inputs(4, 1536, 3200, 16, torch.float32, cuda), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt_scale,dt_shift,s", [
    (1e-3, 0.0, 4096),   # decays near 1 over a long S: h sums thousands of steps
    (1.0, 20.0, 300),    # decays near 0: h forgets at every step
])
def test_scan_kernel_extreme_decays(cuda, dt_scale, dt_shift, s, dtype):
    args = _scan_inputs(2, s, 64, 16, torch.float32, cuda)
    args[1] = args[1] * dt_scale + dt_shift
    args = [t.to(dtype) if i in (0, 1, 3, 4) else t for i, t in enumerate(args)]
    _scan_agrees(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_misaligned_views(cuda, dtype):
    args = _scan_inputs(2, 64, 256, 16, dtype, cuda)
    buf = torch.empty(args[0].numel() + 8, dtype=dtype, device=cuda)
    u = buf[1:args[0].numel() + 1].view(args[0].shape)
    u.copy_(args[0])  # contiguous, one element off 16 bytes: plain loads
    assert u.data_ptr() % 16 and not ss._check(u, *args[1:]).vec
    _scan_agrees([u, *args[1:]], dtype)


def test_scan_wrapper_raises_where_the_plan_refuses(cuda):
    args = _scan_inputs(2, 8, 16, 4, torch.float32, cuda)
    wide = [torch.zeros(65536, 1, 16, device=cuda), torch.zeros(65536, 1, 16, device=cuda),
            args[2], torch.zeros(65536, 1, 4, device=cuda),
            torch.zeros(65536, 1, 4, device=cuda), args[5]]
    with pytest.raises(ValueError):
        ss.launch_plan(65536, 1, 16, 4, torch.float32)
    before = ss.launches
    with pytest.raises(ValueError, match="unsupported shape"):
        ss.selective_scan(*wide)
    a2 = args[2][:, :2].contiguous()  # N = 2: no instantiation
    with pytest.raises(ValueError, match="state size"):
        ss.selective_scan(args[0], args[1], a2, args[3][..., :2].contiguous(),
                          args[4][..., :2].contiguous(), args[5])
    assert ss.launches == before


# RMSNorm: the sweep of test_kernels.py, the serving shapes (prefill and
# decode rows of qwen2-0.5b, hymba-1.5b and falcon-mamba-7b), a d that takes
# the scalar (unvectorised) path, and a row wider than 48 KB of f32; then the
# register limit (d 4096: in registers in bf16, read twice in f32), rows past
# it, ragged rows and 1, 4 and 6144 rows.
NORM_CASES = [(64, 128), (37, 256), (5, 64), (2048, 896), (6144, 1600), (2048, 4096),
              (4, 896), (4, 1600), (4, 4096), (9, 1001), (3, 20000),
              (1, 4096), (6144, 4096), (4, 8192), (6144, 4104), (1, 1003), (6144, 1003),
              (1, 2048), (4, 2052)]
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", NORM_CASES)
def test_norm_kernel_matches_plain_version(cuda, rows, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    scale = 0.1 * torch.randn(d, generator=g, device=cuda)
    before = rn.launches
    out = ops.rms_norm(x, scale, eps=1e-6)
    torch.cuda.synchronize()
    assert rn.launches == before + 1 and out.dtype == dtype
    want = ref.rms_norm_ref(x, scale, 1e-6)
    tol = NORM_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(6144, 1600), (4, 4096), (2048, 8192)])
def test_norm_kernel_scale_dtypes(cuda, rows, d, dtype, scale_dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    scale = (0.1 * torch.randn(d, generator=g, device=cuda)).to(scale_dtype)
    out = ops.rms_norm(x, scale, eps=1e-6)
    want = ref.rms_norm_ref(x, scale, 1e-6)
    tol = NORM_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


def test_norm_kernel_unaligned_rows_take_scalar_loads(cuda):
    buf = torch.randn(4 * 1600 + 8, device=cuda).to(torch.bfloat16)
    x = buf[1:4 * 1600 + 1].view(4, 1600)
    scale = 0.1 * torch.randn(1600, device=cuda)
    out = rn.rms_norm(x, scale)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.rms_norm_ref(x, scale).float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_auto_takes_the_scan_and_norm_kernels_on_the_card(cuda):
    from repro_torch.models import layers

    args = _scan_inputs(2, 40, 64, 16, torch.bfloat16, cuda)
    before = ss.launches
    y, _ = layers._selective_scan(*args, impl="auto")
    assert ss.launches == before + 1
    want, _ = ref.selective_scan_ref(*args)
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(), atol=5e-2, rtol=5e-2)
    # from a state: 'auto' raises on the card (the kernel starts from h=0),
    # so the recurrent step asks for the plain scan
    h0 = torch.zeros(2, 64, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="h0"):
        layers._selective_scan(*args, h0=h0, impl="auto")
    layers._selective_scan(*args, h0=h0, impl="ref")
    assert ss.launches == before + 1

    x = torch.randn(4, 7, 1600, device=cuda).to(torch.bfloat16)
    scale = torch.zeros(1600, device=cuda).to(torch.bfloat16)
    before = rn.launches
    out = layers.rms_norm(x, scale, 1e-6, impl="auto")
    assert rn.launches == before + 1
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.rms_norm_ref(x, scale).float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="dtype"):
        layers.rms_norm(x.half(), scale, 1e-6, impl="auto")
    assert rn.launches == before + 1


def test_scan_and_norm_kernels_refuse_what_they_do_not_take(cuda):
    u, dt, a, bm, cm, d = _scan_inputs(1, 16, 32, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.selective_scan(u.cpu(), dt, a, bm, cm, d)
    with pytest.raises(ValueError, match="dtype"):
        ss.selective_scan(u.half(), dt.half(), a, bm.half(), cm.half(), d)
    with pytest.raises(ValueError, match="want torch.float32"):
        ss.selective_scan(u, dt, a.to(torch.bfloat16), bm, cm, d)
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan(u, dt, a, bm.transpose(1, 2).contiguous().transpose(1, 2), cm, d)
    with pytest.raises(ValueError, match="state size"):
        ss.selective_scan(u, dt, a[:, :5].contiguous(), bm[..., :5].contiguous(),
                          cm[..., :5].contiguous(), d)
    with pytest.raises(NotImplementedError, match="h0"):
        ops.selective_scan(u, dt, a, bm, cm, d, h0=torch.zeros(1, 32, 8, device=cuda))

    x, scale = torch.randn(4, 64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rn.rms_norm(x.cpu(), scale)
    with pytest.raises(ValueError, match="dtype"):
        rn.rms_norm(x.half(), scale)
    with pytest.raises(ValueError, match="contiguous"):
        rn.rms_norm(x.T, torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="does not fit"):
        rn.rms_norm(x, scale[:32])


# -- the surrogate training path (no hand-written kernel: convolutions, the
# optimizer and the pinned host-to-device staging, on the card) -------------

class _StepCfg:
    grad_accum = 1
    grad_accum_dtype = "float32"


@pytest.fixture()
def no_tf32(cuda):
    """f32 convolutions in full f32: cuDNN defaults to TF32."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("name", ["ptychonn", "autophasenn", "cosmoflow"])
def test_surrogate_train_step_on_the_card_equals_the_cpu_step(no_tf32, name):
    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.models import cnn
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = SURROGATES[name].reduced()
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((6,) + cfg.input_shape).astype(np.float32),
             "y": rng.standard_normal((6,) + cfg.output_shape).astype(np.float32),
             "weights": np.array([1, 1, 1, 1, 0, 0], np.float32)}
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(_StepCfg(), opt, lambda p, b: cnn.surrogate_loss(p, b, cfg))
    out = {}
    for dev in ("cpu", "cuda"):
        params = cnn.init_surrogate(cfg, generator=torch.Generator().manual_seed(1),
                                    device=dev)
        state, m = step(init_train_state(params, opt),
                        {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        assert all(t.device.type == dev for t in state["params"].values())
        out[dev] = (state, {k: float(v) for k, v in m.items()})
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    assert gm["tokens"] == cm["tokens"] == 4.0
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(gm[k], cm[k], rtol=1e-5)
    for k, v in cs["params"].items():
        # One Adam step moves an element by about lr·g/|g| = 1e-5 (warmup);
        # an element whose gradient sits within f32 error of 0 may move
        # less, or the other way, on one device: all within 2·lr, nearly
        # all within 2e-7.
        diff = np.abs(gs["params"][k].cpu().numpy() - v.numpy())
        lr = float(cm["lr"])
        assert diff.max() <= 2 * lr
        assert (diff > 2e-7).mean() <= 1e-4
        mu = cs["opt"].mu[k].numpy()
        np.testing.assert_allclose(gs["opt"].mu[k].cpu().numpy(), mu, rtol=1e-5,
                                   atol=1e-5 * np.abs(mu).max())


def test_pinned_double_buffer_delivers_exactly_to_global_bytes(cuda, tmp_path):
    from repro_torch.data import DatasetSpec, LoaderSpec, build_pipeline, create_store
    from repro_torch.train.trainer import PinnedBatchStager

    # 1 MiB samples: copies long enough that refilling a pinned buffer
    # before its copy landed would show
    store = create_store(str(tmp_path / "ds.bin"), "binary",
                         spec=DatasetSpec(96, (256, 1024), "<f4"), fill="random")
    try:
        ld = build_pipeline(LoaderSpec(loader="solar", store=store, num_nodes=2,
                                       local_batch=4, num_epochs=1, buffer_size=16,
                                       collect_data=True))
        stager = PinnedBatchStager(cuda)
        host, dev, sums = [], [], []
        for sb in ld:
            data, weights = sb.to_global(ld.capacity)
            host.append((data, weights))
            d = stager({"x": data, "weights": weights})
            dev.append(d)
            sums.append(d["x"].double().sum())  # on the compute stream, at once
        torch.cuda.synchronize()
        assert len(dev) >= 4
        for (data, weights), d, s in zip(host, dev, sums):
            assert d["x"].cpu().numpy().tobytes() == data.tobytes()
            assert d["weights"].cpu().numpy().tobytes() == weights.tobytes()
            np.testing.assert_allclose(float(s), data.astype(np.float64).sum(), rtol=1e-12)
    finally:
        store.close()


def test_trainer_on_the_card_follows_the_cpu_trainer(no_tf32, tmp_path):
    from repro_torch.configs.surrogates import SURROGATES
    from repro_torch.data import DatasetSpec, LoaderSpec, build_pipeline, create_store
    from repro_torch.launch.train_surrogate import make_batch_fn
    from repro_torch.models import cnn
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    cfg = SURROGATES["ptychonn"].reduced()
    store = create_store(str(tmp_path / "ds.bin"), "binary",
                         spec=DatasetSpec(256, cfg.input_shape, "<f4"), fill="random")
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=10)
    step = make_train_step(_StepCfg(), opt, lambda p, b: cnn.surrogate_loss(p, b, cfg))
    runs = {}
    try:
        for dev in ("cpu", "cuda"):
            spec = LoaderSpec(loader="solar", store=store, num_nodes=2, local_batch=8,
                              num_epochs=2, buffer_size=64, collect_data=True,
                              prefetch_depth=2, num_workers=2)
            params = cnn.init_surrogate(cfg, generator=torch.Generator().manual_seed(0),
                                        device=dev)
            pipeline = build_pipeline(spec)
            t = Trainer(loader=pipeline, step_fn=step, state=init_train_state(params, opt),
                        make_batch=make_batch_fn(cfg, pipeline.capacity), device=dev)
            t.run(max_steps=10)
            runs[dev] = t.metrics_history
    finally:
        store.close()
    assert [m["tokens"] for m in runs["cuda"]] == [m["tokens"] for m in runs["cpu"]]
    np.testing.assert_allclose([m["loss"] for m in runs["cuda"]],
                               [m["loss"] for m in runs["cpu"]], rtol=1e-5)
