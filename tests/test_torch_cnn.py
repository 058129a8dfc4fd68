"""The port's CNN surrogates against ``repro.models.cnn``: from the same
JAX-initialised parameters, carried over by ``repro_torch.convert``, the
outputs, the weighted loss and every gradient (autograd against
``jax.grad``) agree, at ``reduced()`` and at full width with a batch of 2.
Tolerance: f32, atol 1e-5 with rtol 1e-5 for outputs and loss (they read
~1e-7 apart); for gradients rtol 1e-5 and atol 1e-5 times the leaf's largest
|g|, because a kernel's gradient sums up to 2·32³ products per element in a
different order in each framework (CosmoFlow at full width reads 6.3e-6 of
its leaf's scale).  One test
per conversion trap, in 2D and 3D at n=16 and n=15, checks the single
operation and that the naive PyTorch form is far off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from repro.configs.surrogates import SURROGATES as JAX_SURROGATES
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs.surrogates import SURROGATES
from repro_torch.models import cnn

torch.set_num_threads(1)

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-5


def _inputs(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch,) + cfg.input_shape).astype(np.float32)
    y = rng.standard_normal((batch,) + cfg.output_shape).astype(np.float32)
    w = np.ones(batch, np.float32)
    w[-1] = 0.0  # a padding row: weightless
    return x, y, w


def _perturbed(params, seed=1):
    """JAX params with non-zero biases, so the bias paths are checked."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def test_configs_are_the_reference_configs():
    for name, cfg in JAX_SURROGATES.items():
        assert SURROGATES[name].__dict__ == cfg.__dict__
        assert SURROGATES[name].reduced().__dict__ == cfg.reduced().__dict__


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("name", sorted(JAX_SURROGATES))
def test_surrogate_outputs_loss_and_gradients_match(name, size):
    jcfg = JAX_SURROGATES[name]
    tcfg = SURROGATES[name]
    if size == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    x, y, w = _inputs(jcfg, batch=2)
    jp = _perturbed(jcnn.init_surrogate(jax.random.PRNGKey(3), jcfg))
    batch = {"x": x, "y": y, "weights": w}

    (jloss, jm), jgrad = jax.value_and_grad(
        lambda p: jcnn.surrogate_loss(p, batch, jcfg), has_aux=True)(jp)
    jout = np.asarray(jcnn.surrogate_apply(jp, x, jcfg))

    tp = {k: v.requires_grad_(True)
          for k, v in convert.surrogate_params_from_jax(jp, "cpu").items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tm = cnn.surrogate_loss(tp, tbatch, tcfg)
    tgrad = torch.autograd.grad(tloss, list(tp.values()))
    with torch.no_grad():
        tout = cnn.surrogate_apply(tp, tbatch["x"], tcfg).numpy()

    assert tout.shape == jout.shape == (2,) + jcfg.output_shape
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=ATOL, rtol=RTOL)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 1.0
    back = convert.surrogate_params_to_jax(dict(zip(tp, tgrad)))
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jgrad))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jgrad)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=GRAD_TOL * np.abs(b).max(), rtol=GRAD_TOL)


@pytest.mark.parametrize("name", sorted(JAX_SURROGATES))
def test_convert_round_trip_is_bit_exact_and_init_has_the_reference_shapes(name):
    cfg = SURROGATES[name].reduced()
    jp = jax.tree.map(np.asarray, jcnn.init_surrogate(jax.random.PRNGKey(0),
                                                      JAX_SURROGATES[name].reduced()))
    back = convert.surrogate_params_to_jax(convert.surrogate_params_from_jax(jp, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's own init: the reference's shapes (in JAX layout), zero
    # biases, weights ~ N(0, 1/fan_in)
    own = convert.surrogate_params_to_jax(
        cnn.init_surrogate(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for layer in own["enc"] + own["dec"]:
        assert not layer["b"].any()
        fan_in = int(np.prod(layer["w"].shape[:-1]))
        assert 0.5 < layer["w"].std() * np.sqrt(fan_in) < 1.5


def _jax_conv(x, w, rank, transpose):
    dn_in = {2: "NHWC", 3: "NDHWC"}[rank]
    dn = (dn_in, {2: "HWIO", 3: "DHWIO"}[rank], dn_in)
    if transpose:
        return np.asarray(lax.conv_transpose(x, w, strides=(2,) * rank, padding="SAME",
                                             dimension_numbers=dn))
    return np.asarray(lax.conv_general_dilated(x, w, window_strides=(2,) * rank,
                                               padding="SAME", dimension_numbers=dn))


def _trap_inputs(rank, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2,) + (n,) * rank + (3,)).astype(np.float32)
    w = rng.standard_normal((3,) * rank + (3, 5)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("n", [16, 15])
@pytest.mark.parametrize("rank", [2, 3])
def test_trap_same_stride2_conv_pads_by_the_xla_rule(rank, n):
    x, w = _trap_inputs(rank, n)
    want = _jax_conv(x, w, rank, transpose=False)
    lo, hi = cnn.same_pads(n)
    assert (lo, hi) == ((0, 1) if n == 16 else (1, 1))
    tw = convert.surrogate_leaf_from_jax("enc.0.w", w)
    tx = cnn._channels_first(torch.from_numpy(x), rank)
    got = cnn._channels_last(cnn._conv(tx, tw, None, rank), rank).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if n == 16:  # PyTorch's symmetric padding=1 is the trap
        conv = F.conv2d if rank == 2 else F.conv3d
        naive = cnn._channels_last(conv(tx, tw, stride=2, padding=1), rank).numpy()
        assert naive.shape == want.shape
        assert np.abs(naive - want).max() > 1.0


@pytest.mark.parametrize("n", [16, 15])
@pytest.mark.parametrize("rank", [2, 3])
def test_trap_same_conv_transpose_is_flipped_and_cropped(rank, n):
    x, w = _trap_inputs(rank, n)
    want = _jax_conv(x, w, rank, transpose=True)
    tw = convert.surrogate_leaf_from_jax("dec.0.w", w)
    tx = cnn._channels_first(torch.from_numpy(x), rank)
    got = cnn._channels_last(cnn._conv_transpose(tx, tw, None, rank), rank).numpy()
    assert got.shape == want.shape == (2,) + (2 * n,) * rank + (5,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # without the flip, or cropped one place later, it is far off
    unflipped = tw.flip(tuple(range(2, rank + 2)))
    bad = cnn._channels_last(cnn._conv_transpose(tx, unflipped, None, rank), rank).numpy()
    assert np.abs(bad - want).max() > 1.0
    convt = F.conv_transpose2d if rank == 2 else F.conv_transpose3d
    full = convt(tx, tw, stride=2)
    late = full[(Ellipsis,) + tuple(slice(1, 2 * n + 1) for _ in range(rank))]
    assert np.abs(cnn._channels_last(late, rank).numpy() - want).max() > 1.0


@pytest.mark.parametrize("n", [16, 15])
def test_trap_cosmoflow_flattens_channels_last(n):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, n, n, n, 4)).astype(np.float32)  # NDHWC
    want = jnp.asarray(h).reshape(2, -1)
    th = cnn._channels_first(torch.from_numpy(h), 3)             # NCDHW view
    got = cnn._flatten(th, 3).numpy()
    assert np.array_equal(got, np.asarray(want))
    assert not np.array_equal(th.reshape(2, -1).numpy(), np.asarray(want))
