"""The stem convolution's weight gradient on the CPU: its plain version
against PyTorch's, the rule that routes a convolution to it, the wrapper's
checks and grid (on meta tensors), and the surrogates' loss and gradients
through ``models/cnn.py``'s Function against the plain ``F.conv3d`` path.
The kernel itself runs in ``tests/test_torch_cuda.py``.  Tolerance: f32
sums of up to 2 * 16^3 products per element in another order, within 1e-5
of the largest magnitude (as ``tests/test_torch_cnn.py``)."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.surrogates import SURROGATES
from repro_torch.kernels import conv_wgrad, ops, ref, work
from repro_torch.models import cnn
from repro_torch.obs import trace as obs_trace

torch.set_num_threads(1)

TOL = 1e-5
#: the benchmark's cosmoflow (bench/configs/cosmoflow.json)
COSMOFLOW_CELL = dataclasses.replace(SURROGATES["cosmoflow"], input_shape=(128, 128, 128, 4),
                                     base_channels=32, depth=5)


def _close(a, b):
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= TOL * float(b.abs().max())


def _stem_inputs(n, cin, cout, dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, cin) + dims, generator=g),
            torch.randn((n, cout) + tuple(-(-s // 2) for s in dims), generator=g),
            cnn.conv_pads(dims))


@pytest.mark.parametrize("n,cin,cout,dims", [
    (2, 4, 32, (32, 32, 32)),   # cosmoflow's stem, spatial reduced
    (2, 1, 16, (32, 32, 32)),   # autophasenn's stem
    (1, 4, 32, (17, 17, 17)),   # odd: a pad before each axis
    (1, 1, 16, (33, 33, 33)),
    (1, 8, 8, (9, 10, 15)),     # 8 channels, unequal odd and even sides
])
def test_plain_version_is_pytorchs_weight_and_bias_gradient(n, cin, cout, dims):
    x, dy, pads = _stem_inputs(n, cin, cout, dims)
    dw, db = ref.conv3d_stem_wgrad_ref(x, dy, pads)
    _close(dw, torch.nn.grad.conv3d_weight(F.pad(x, pads), (cout, cin, 3, 3, 3), dy, stride=2))
    _close(db, dy.sum(dim=(0, 2, 3, 4)))
    got = ops.conv3d_stem_wgrad(x, dy, pads)  # a CPU tensor takes the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, (dw, db)))


@pytest.mark.parametrize("cfg,want", [
    (SURROGATES["ptychonn"], []),
    (SURROGATES["ptychonn"].reduced(), []),
    (SURROGATES["autophasenn"], ["enc.0"]),                   # 1 -> 16
    (SURROGATES["autophasenn"].reduced(), ["enc.0", "enc.1"]),  # 1 -> 8 -> 16
    (SURROGATES["cosmoflow"], ["enc.0"]),                     # 4 -> 16
    (SURROGATES["cosmoflow"].reduced(), ["enc.0", "enc.1"]),    # 4 -> 8 -> 16
    (COSMOFLOW_CELL, ["enc.0"]),                               # 4 -> 32 at 128^3
], ids=["ptychonn", "ptychonn-reduced", "autophasenn", "autophasenn-reduced", "cosmoflow",
        "cosmoflow-reduced", "cosmoflow-cell"])
def test_routing_rule_for_every_layer(cfg, want, monkeypatch):
    """Only float32 3D convolutions of 1, 4 or 8 input channels into a
    multiple of 4; the decoders' transposed convolutions never.  The model sends exactly those
    layers through the Function (on meta tensors: nothing is computed)."""
    assert cnn.stem_layers(cfg) == want
    rank = len(cfg.input_shape) - 1
    enc, dec = cnn._layer_channels(cfg)
    for cin, cout in enc:
        assert conv_wgrad.routes(rank, cin, cout, torch.float32) == (rank == 3 and cin in (1, 4, 8))
        assert not conv_wgrad.routes(rank, cin, cout, torch.bfloat16)
    seen = []
    apply = cnn._StemConv.apply
    monkeypatch.setattr(cnn._StemConv, "apply",
                        lambda x, w, b, pads: seen.append(tuple(w.shape)) or apply(x, w, b, pads))
    params = cnn.init_surrogate(cfg, device="meta")
    cnn.surrogate_apply(params, torch.empty((1,) + cfg.input_shape, device="meta"), cfg)
    assert seen == [tuple(params[f"{name}.w"].shape) for name in want]


def test_routes_by_shape_alone():
    assert all(conv_wgrad.routes(3, cin, 32, torch.float32) for cin in (1, 4, 8))
    assert conv_wgrad.routes(3, 4, 8, torch.float32)
    assert not any(conv_wgrad.routes(3, cin, 32, torch.float32) for cin in (2, 3, 9, 16))
    assert not conv_wgrad.routes(3, 4, 6, torch.float32)
    assert not conv_wgrad.routes(2, 4, 32, torch.float32)
    assert not conv_wgrad.routes(3, 4, 32, torch.float16)


def _meta(shape, cl=True, dtype=torch.float32):
    t = torch.empty(shape, device="meta", dtype=dtype)
    return t.contiguous(memory_format=torch.channels_last_3d) if cl else t.contiguous()


def test_wrapper_on_meta_allocates_records_and_launches_nothing():
    recorded = []
    before = conv_wgrad.launches
    with work.recording(lambda *a: recorded.append(a)):
        dw, db = conv_wgrad.conv3d_stem_wgrad(_meta((24, 4, 128, 128, 128)),
                                              _meta((24, 32, 64, 64, 64)), (0, 1) * 3)
    assert conv_wgrad.launches == before
    assert dw.shape == (32, 4, 3, 3, 3) and db.shape == (32,) and dw.is_meta
    p = 24 * 64**3
    assert recorded == [("conv3d_stem_wgrad",
                         work.Work(f32_ops=(2 * 108 + 1) * p * 32,
                                   bytes=4 * (24 * 4 * 128**3 + p * 32 + 32 * 108 + 32)),
                         torch.float32)]
    # 43.5 GFLOP of float32 FFMA: 0.65 ms at 67 TFLOP/s
    assert abs(2 * 108 * p * 32 / 1e9 - 43.5) < 0.05
    # autophasenn's stem, odd sides
    dw, db = conv_wgrad.conv3d_stem_wgrad(_meta((1, 1, 9, 9, 9)), _meta((1, 16, 5, 5, 5)),
                                          (1, 1) * 3)
    assert dw.shape == (16, 1, 3, 3, 3) and db.shape == (16,)


@pytest.mark.parametrize("case", ["cpu", "dtype", "rank", "layout", "dy layout", "channels",
                                  "3 channels", "cout", "pads", "dy shape"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    x, dy, pads = _meta((2, 4, 16, 16, 16)), _meta((2, 32, 8, 8, 8)), (0, 1) * 3
    if case == "cpu":
        x = torch.empty((2, 4, 16, 16, 16)).contiguous(memory_format=torch.channels_last_3d)
    elif case == "dtype":
        x = _meta((2, 4, 16, 16, 16), dtype=torch.float64)
    elif case == "rank":
        x, dy = torch.empty((2, 4, 16, 16), device="meta"), torch.empty((2, 32, 8, 8),
                                                                         device="meta")
    elif case == "layout":
        x = _meta((2, 4, 16, 16, 16), cl=False)
    elif case == "dy layout":
        dy = _meta((2, 32, 8, 8, 8), cl=False)
    elif case == "channels":
        x = _meta((2, 9, 16, 16, 16))
    elif case == "3 channels":
        x = _meta((2, 3, 16, 16, 16))
    elif case == "cout":
        dy = _meta((2, 6, 8, 8, 8))
    elif case == "pads":
        pads = (2, 0) * 3
    else:
        dy = _meta((2, 32, 8, 8, 9))
    with pytest.raises(ValueError):
        conv_wgrad.conv3d_stem_wgrad(x, dy, pads)


def test_launch_plan_mirrors_the_grid():
    # cosmoflow's cell: 24 rows x 32 tiles of 2 x 64 outputs, one slice of 32 channels
    assert conv_wgrad.launch_plan(24, 4, 32, 64, 64) == (768, 1, 32 * 109)
    assert conv_wgrad.launch_plan(2, 1, 16, 16, 16) == (16, 1, 16 * 28)
    assert conv_wgrad.launch_plan(1, 4, 40, 10, 75) == (10, 2, 40 * 109)
    assert conv_wgrad.launch_plan(1, 8, 16, 3, 3) == (2, 1, 16 * 217)


@pytest.mark.parametrize("n", [16, 17])
def test_stem_function_gradients_equal_pytorchs(n):
    """Through ``models/cnn._conv`` with the input needing a gradient too:
    dx is cuDNN's data gradient of the padded input, cropped."""
    x, dy, pads = _stem_inputs(2, 4, 8, (n, n, n))
    g = torch.Generator().manual_seed(3)
    w = (torch.randn((8, 4, 3, 3, 3), generator=g) / 10).requires_grad_(True)
    b = torch.randn(8, generator=g).requires_grad_(True)
    x.requires_grad_(True)
    y = cnn._conv(x, w, b, 3)
    assert y.grad_fn.name().endswith("_StemConvBackward")
    got = torch.autograd.grad(y, (x, w, b), dy)
    want = torch.autograd.grad(F.conv3d(F.pad(x, pads), w, b, stride=2), (x, w, b), dy)
    for a, c in zip(got, want):
        _close(a, c)


@pytest.mark.parametrize("name,size", [("autophasenn", "reduced"), ("autophasenn", "full"),
                                       ("cosmoflow", "reduced"), ("cosmoflow", "full")])
def test_surrogate_loss_and_gradients_equal_the_plain_path(name, size, monkeypatch):
    cfg = SURROGATES[name] if size == "full" else SURROGATES[name].reduced()
    g = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn((2,) + cfg.input_shape, generator=g),
             "y": torch.randn((2,) + cfg.output_shape, generator=g),
             "weights": torch.tensor([1.0, 0.0])}
    params = cnn.init_surrogate(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    params = {k: (v + 0.05 * torch.randn(v.shape, generator=g)).requires_grad_(True)
              for k, v in params.items()}

    def run():
        loss, _ = cnn.surrogate_loss(params, batch, cfg)
        return loss, torch.autograd.grad(loss, list(params.values()))

    loss, grads = run()
    monkeypatch.setattr(conv_wgrad, "routes", lambda *a: False)
    want_loss, want = run()
    assert torch.equal(loss, want_loss)  # the same forward
    for k, a, b in zip(params, grads, want):
        _close(a, b)


def test_stem_wgrad_is_traced_inside_the_backward():
    """One ``conv.stem_wgrad`` span per stem layer a backward, inside
    ``step.backward``; a = positions, b = taps."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    class _Cfg:
        grad_accum = 2
        grad_accum_dtype = "float32"

    cfg = SURROGATES["cosmoflow"].reduced()
    assert obs_trace.kind_names()[27] == "conv.stem_wgrad" == \
        obs_trace.kind_name(obs_trace.CONV_STEM_WGRAD)
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn((4,) + cfg.input_shape, generator=g),
             "y": torch.randn((4,) + cfg.output_shape, generator=g),
             "weights": torch.ones(4)}
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(_Cfg(), opt, lambda p, b: cnn.surrogate_loss(p, b, cfg))
    state = init_train_state(cnn.init_surrogate(cfg, device="cpu"), opt)
    tracer = obs_trace.enable()
    try:
        step(state, batch)
    finally:
        obs_trace.disable()
    recs, _, _ = tracer.records()
    names = [obs_trace.kind_name(int(k)) for k in recs["kind"]]
    stems = [r for r, k in zip(recs, names) if k == "conv.stem_wgrad"]
    backs = [r for r, k in zip(recs, names) if k == "step.backward"]
    assert len(backs) == 2 and len(stems) == 2 * len(cnn.stem_layers(cfg)) == 4
    # enc.1 (8 channels in, 4^3 out) runs first in the backward, then enc.0 (4 in, 8^3)
    assert [(int(r["a"]), int(r["b"])) for r in stems] == [(2 * 4**3, 8 * 27),
                                                            (2 * 8**3, 4 * 27)] * 2
    for i, r in enumerate(stems):
        back = backs[i // 2]
        assert back["t0"] <= r["t0"] <= r["t1"] <= back["t1"]
