"""The port's UNet and its plain layers against exaspim_tpu.models.

All comparisons run in f32 on the CPU with the same numpy-seeded inputs
and JAX-initialised params carried over by ``params_from_flax``.
Tolerance: atol = rtol = 1e-4 for the model (the bar of
tests/test_torch_parity.py), 1e-5 for single layers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.models.unet3d import GroupNorm as JaxGroupNorm
from exaspim_tpu.models.unet3d import _linear_resize_matrix
from exaspim_tpu.models.unet3d import max_pool3d as jax_max_pool3d
from exaspim_tpu.models.unet3d import resize_trilinear as jax_resize
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.models.unet3d import (
    group_norm,
    linear_resize_matrix,
    max_pool3d,
    resize_trilinear,
)
from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_stats
from exaspim_tpu_torch.train.checkpoint import params_from_flax


def _port(params, **kw):
    model = UNet(**kw)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return model


def test_unet_forward_matches_jax():
    kw = dict(width_multiplier=0.25, head_init="normal")
    jm = JaxUNet(**kw)
    x = np.random.default_rng(0).normal(0.5, 0.2, (1, 32, 32, 32, 1)).astype(
        np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    assert np.abs(want - x).max() > 0.1  # the head is not the identity
    with torch.no_grad():
        got = _port(params, **kw)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_unet_width_0_3_forward_matches_jax():
    """``width_multiplier=0.3``: stages 9, 19, 38, 76 (and 153 // 2 = 76),
    widths that are no multiple of 8 (the reference sends them to the XLA
    conv; the port's kernels take them on the card, the plain conv here).
    Same numpy-seeded input, JAX-initialised params, tolerance as above."""
    kw = dict(width_multiplier=0.3, head_init="normal")
    jm = JaxUNet(**kw)
    x = np.random.default_rng(3).normal(0.5, 0.2, (1, 16, 16, 16, 1)).astype(
        np.float32)
    params = jm.init(jax.random.key(3), jnp.asarray(x))["params"]
    widths = sorted({v.shape[-1] for v in jax.tree.leaves(params)
                     if v.ndim == 5})
    assert widths == [1, 9, 19, 38, 76]  # 1: the 1x1x1 head
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, **kw)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_fused_stats_group_norm_equals_unfused_and_flax():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 4, 8, 8, 16)).astype(np.float32))
    k = torch.from_numpy(
        (rng.normal(size=(3, 3, 3, 16, 32)) * 0.1).astype(np.float32))
    y, s1, s2 = nb_conv3d_stats(x, k)
    scale = torch.from_numpy(rng.normal(1.0, 0.1, 32).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.1, 32).astype(np.float32))
    fused = group_norm(y, scale, bias, 8, stats=(s1, s2))
    unfused = group_norm(y, scale, bias, 8)
    torch.testing.assert_close(fused, unfused, rtol=1e-6, atol=1e-6)
    jgn = JaxGroupNorm(num_groups=8)
    want = jgn.apply({"params": {"scale": jnp.asarray(scale.numpy()),
                                 "bias": jnp.asarray(bias.numpy())}},
                     jnp.asarray(y.numpy()))
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n_in,n_out,ac", [
    (6, 12, False), (5, 10, False), (1, 2, False), (7, 14, True),
])
def test_resize_matrix_equals_reference(n_in, n_out, ac):
    np.testing.assert_array_equal(linear_resize_matrix(n_in, n_out, ac),
                                  _linear_resize_matrix(n_in, n_out, ac))


def test_resize_and_pool_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 6, 7, 3)).astype(np.float32)
    got = resize_trilinear(torch.from_numpy(x), (10, 12, 14)).numpy()
    want = np.asarray(jax_resize(jnp.asarray(x), (10, 12, 14)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        max_pool3d(torch.from_numpy(x)).numpy(),
        np.asarray(jax_max_pool3d(jnp.asarray(x))),
    )


@pytest.mark.slow
def test_shipped_checkpoint_forward_matches_jax():
    from exaspim_tpu.models import build_model as jax_build
    from exaspim_tpu_torch.models import build_model
    from exaspim_tpu_torch.train.checkpoint import load_checkpoint

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "checkpoints", "bm4dnet.msgpack")
    ckpt = load_checkpoint(path)
    jm = jax_build(ckpt["model_config"])
    x = np.random.default_rng(3).normal(0.3, 0.1, (1, 32, 32, 32, 1)).astype(
        np.float32)
    want = np.asarray(jm.apply({"params": ckpt["params"]}, jnp.asarray(x)))
    model = build_model(ckpt["model_config"], device="cpu")
    model.load_state_dict(params_from_flax(ckpt["params"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
