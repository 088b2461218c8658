"""The port's train state and steps against exaspim_tpu.train.state.

A width-0.25 UNet (``head_init="normal"``, so every gradient is live) at
16³, batch 2, f32, with the JAX init carried over by ``params_from_flax``:

* the loss (1e-5 relative) and every parameter's gradient against
  ``jax.value_and_grad``: relative L2 error ≤ 2e-3 per parameter (a
  wrong transpose, flip or stats fold gives O(1)). Not tighter: a
  LeakyReLU input within f32 rounding of zero takes the other slope in
  the other framework (one such element in this batch, measured), which
  moves every gradient upstream of it by up to 6e-4 in relative L2; the
  targets sit away from the Charbonnier knee (see the test). The conv's
  own backward is held to 1e-4 in tests/test_torch_port_nb_conv_grad.py;
* five AdamW updates with the cosine and the warmup-cosine schedules
  against optax fed the SAME gradients (atol 1e-6 on the params: Adam's
  first step is ≈ lr·sign(g), so comparing params after steps on
  separately computed gradients would test summation noise);
* the fg bit packing, ``orient_batch`` for all 48 codes (equal), and one
  cached step (gather, packed fg, foreground-preserving target, the
  transform inside the step) against the JAX cached step's loss (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.losses import signal_preserving_loss as jax_loss
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.train import state as js
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.train import state as ts
from exaspim_tpu_torch.train.checkpoint import params_from_flax
from exaspim_tpu_torch.transforms import build_transform

KW = dict(width_multiplier=0.25, head_init="normal")
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


@pytest.fixture(scope="module")
def setup():
    jm = JaxUNet(**KW)
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, 16, 16, 16, 1)))["params"]
    return jm, jax.tree.map(np.asarray, params)


def _port(params):
    model = UNet(**KW)
    model.load_state_dict(params_from_flax(params))
    return model


def test_loss_and_gradients_match_jax(setup):
    jm, params = setup
    # Targets 5 away from the input, with a random sign per voxel: the
    # Charbonnier derivative diff/sqrt(diff² + eps²) then sits at ±1. Near
    # |diff| < eps it amplifies any f32 forward difference by 1/eps = 1000,
    # which would test the two frameworks' rounding, not the backward.
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 1.0, (2, 16, 16, 16, 1)).astype(np.float32)
    y = (x + 5.0 * rng.choice([-1.0, 1.0], x.shape)).astype(np.float32)
    fg = rng.random(x.shape) < 0.2

    def loss_fn(p):
        return jax_loss(jm.apply({"params": p}, x), y, fg, fg_weight=20.0)

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port(params)
    loss = ts.signal_preserving_loss(
        model(torch.from_numpy(x)), torch.from_numpy(y),
        torch.from_numpy(fg).float(), fg_weight=20.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, want_g))
    got = dict(model.named_parameters())
    assert want.keys() == got.keys()
    for k, g in want.items():
        g = g.numpy()
        assert np.abs(g).max() > 0, k  # a live gradient
        rel = np.linalg.norm(got[k].grad.numpy() - g) / np.linalg.norm(g)
        assert rel <= 2e-3, (k, rel)


@pytest.mark.parametrize("warmup", [0, 2])
def test_adamw_cosine_updates_match_optax(setup, warmup):
    jm, params = setup
    total, lr = 7, 1e-3
    sched = ts.cosine_schedule(lr, total, warmup)
    want_sched = js.cosine_schedule(lr, total, warmup)
    for t in range(total + 3):
        np.testing.assert_allclose(sched(t), float(want_sched(t)),
                                   rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for _ in range(5)]
    jstate = js.create_train_state(jm, lr=lr, total_steps=total,
                                   warmup_steps=warmup, params=params)
    state = ts.create_train_state(_port(params), lr=lr, total_steps=total,
                                  warmup_steps=warmup, params=params)
    apply = jax.jit(lambda st, g: st.apply_gradients(grads=g))
    for g in grads:
        jstate = apply(jstate, g)
        for k, p in state.model.named_parameters():
            p.grad = params_from_flax(g)[k]
        state.apply_gradients()
    assert state.step == int(jstate.step) == 5
    want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_fg_bits_and_orientations_match_jax():
    rng = np.random.default_rng(2)
    fg = rng.random((3, 5, 6, 7)) < 0.3
    packed = ts.pack_fg_bits(fg)
    np.testing.assert_array_equal(packed, js.pack_fg_bits(fg))
    got = ts.unpack_fg_bits(torch.from_numpy(packed), (5, 6, 7))
    np.testing.assert_array_equal(got.numpy(), fg)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(js.unpack_fg_bits(jnp.asarray(packed),
                                                  (5, 6, 7))))
    cube = rng.integers(0, 1000, (2, 4, 4, 4)).astype(np.int32)
    orient = jax.jit(js.orient_batch)
    for code in range(48):
        np.testing.assert_array_equal(
            ts.orient_batch(torch.from_numpy(cube), code).numpy(),
            np.asarray(orient(jnp.asarray(cube), jnp.int32(code))),
            err_msg=str(code))
    with pytest.raises(NotImplementedError):
        ts.make_cached_train_step(augment=True)


def test_cached_step_loss_matches_jax(setup):
    jm, params = setup
    rng = np.random.default_rng(3)
    raw = rng.poisson(300.0, (4, 16, 16, 16)).astype(np.uint16)
    teacher = rng.poisson(300.0, raw.shape).astype(np.uint16)
    fg = rng.random(raw.shape) < 0.2
    idx = np.array([2, 0], np.int32)
    kw = dict(fg_weight=20.0, preserve_foreground=True, fg_packed=True,
              patch_shape=(16, 16, 16))
    jstate = js.create_train_state(jm, params=params)
    jstep = js.make_cached_train_step(transform=jax_transform(TCFG),
                                      donate=False, **kw)
    _, want = jstep(jstate, jnp.asarray(raw), jnp.asarray(teacher),
                    jnp.asarray(js.pack_fg_bits(fg)), jnp.asarray(idx))
    state = ts.create_train_state(_port(params), params=params)
    step = ts.make_cached_train_step(transform=build_transform(TCFG), **kw)
    _, loss = step(state, torch.from_numpy(raw.view(np.int16)),
                   torch.from_numpy(teacher.view(np.int16)),
                   torch.from_numpy(ts.pack_fg_bits(fg)),
                   torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert state.step == 1


def test_max_pool_tie_gradient_matches_jax():
    """Rounded values tie often; each window's gradient goes to one
    element, the one XLA's reduce_window max picks (equal arrays)."""
    from exaspim_tpu.models.unet3d import max_pool3d as jax_pool
    from exaspim_tpu_torch.models.unet3d import max_pool3d

    x = np.round(np.random.default_rng(4).normal(size=(2, 4, 6, 8, 3)))
    x = x.astype(np.float32)
    w = np.arange(3.0, dtype=np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_pool(a) * w))(jnp.asarray(x))
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(x).to(dtype).requires_grad_()
        (max_pool3d(t).float() * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(t.grad.float().numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("head_init", ["zeros", "normal"])
def test_init_matches_flax_in_distribution(setup, head_init):
    """``init_weights`` draws Flax's initialisers (not its bits), against
    the fixture's Flax init (head "normal"): per kernel both draws' std
    is within 4 standard errors (4/√(2n)) of lecun_normal's √(1/fan_in),
    |w| stays inside the ±2σ truncation, GroupNorm is (1, 0), the head
    bias 0, the zero head is exactly zero, and a seed repeats."""
    want = params_from_flax(setup[1])
    kw = dict(width_multiplier=0.25, head_init=head_init)
    got = dict(UNet(**kw).init_weights(1).named_parameters())
    again = dict(UNet(**kw).init_weights(1).named_parameters())
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.numpy()
        np.testing.assert_array_equal(g, again[k].detach().numpy())
        if k == "Conv_0.kernel" and head_init == "zeros":
            assert not g.any()
        elif w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            fan_in = g.shape[0] if k == "Conv_0.kernel" else 27 * g.shape[1]
            bound = 2.0 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            assert np.abs(g).max() <= bound * (1 + 1e-6), k
            tol = 4.0 / np.sqrt(2 * g.size)
            for draw in (g, w):
                np.testing.assert_allclose(draw.std(), (1.0 / fan_in) ** 0.5,
                                           rtol=tol, err_msg=k)
