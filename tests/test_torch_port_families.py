"""The port's other model families against exaspim_tpu.models.

Every comparison runs in f32 on the CPU (the port's convs on their plain
versions) with numpy-seeded inputs and one set of parameters: the port's
``init_weights`` with every bias (conv, transposed conv, GroupNorm, head)
redrawn from a seeded N(0, 0.05), so that none is the zero of the
initialiser, handed to the JAX model through ``params_to_flax`` (its tree
held to the JAX model's own by ``jax.eval_shape``; the JAX package's
eager ``init`` takes ~45 s to trace at these sizes).

* ``UNet`` with ``conv_bias=True``, ``trilinear=False`` and
  ``residual=False``, alone and combined, ``align_corners`` both ways, at
  extents that the pools round (the decoder pads back): forward outputs
  within 1e-4 absolute (measured ≤ 7e-5 at width 0.25; the port's biased
  GroupNorm shifts the conv's sums algebraically, the JAX package reduces
  the biased tensor, so the two differ by rounding), and whole-model
  gradients of a seeded linear functional within 3e-2 relative L2 per
  parameter, plus 1e-6 of the whole gradient's norm for the parameters
  whose gradient vanishes (a conv bias that a one-channel GroupNorm group
  absorbs: ~1e-3 of noise in both). Not tighter: a LeakyReLU input within
  f32 rounding of zero takes the other slope in the other framework, which
  moves the gradients upstream of it (the N2V2 forward at 32³ has four
  inputs below 1e-6, one in the last block); the port's trilinear
  bias-free UNet, ported earlier, shows 5.5e-3 on these inputs, N2V2's
  last block 1.3e-2 (a wrong flip, transpose or bias shift gives O(1)).
  The layers new to the port are held alone, below.
* ``N2V2UNet`` at an even and an odd extent (the odd one re-pads before
  the head), both upsampling modes: the same tolerances.
* ``max_pool3d(stride=1)``, ``blur_pool3d``, ``max_blur_pool3d`` and the
  transposed conv alone (against ``flax.linen.ConvTranspose`` with
  asymmetric seeded kernels at odd extents): equal bits in f32, and their
  gradients (a seeded cotangent through ``jax.vjp``) within 1e-5
  relative L2.
* Every family builds through ``build_model`` from the JAX model's
  ``config``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from exaspim_tpu.models import N2V2UNet as JaxN2V2UNet
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.models import unet3d as ju
from exaspim_tpu_torch.models import N2V2UNet, UNet, build_model
from exaspim_tpu_torch.models.unet3d import (
    blur_pool3d,
    conv_transpose_2x,
    max_blur_pool3d,
    max_pool3d,
)
from exaspim_tpu_torch.train.checkpoint import (
    params_from_flax,
    params_to_flax,
)

FWD_ATOL = 1e-4
GRAD_REL_L2 = 3e-2
LAYER_GRAD_REL_L2 = 1e-5
GRAD_FLOOR = 1e-6  # of the whole gradient's norm


def _pair(jax_cls, port_cls, kw, shape, seed):
    jm = jax_cls(width_multiplier=0.25, head_init="normal", **kw)
    x = np.random.default_rng(seed).normal(0.5, 0.2, shape).astype(
        np.float32)
    model = port_cls(width_multiplier=0.25, head_init="normal",
                     **kw).init_weights(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=gen)
    params = params_to_flax(model.state_dict())
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.asarray(x))["params"]
    assert jax.tree.structure(shapes) == jax.tree.structure(params)
    for want, got in zip(jax.tree.leaves(shapes), jax.tree.leaves(params)):
        assert want.shape == got.shape
    return jm, params, model, x


def _check(jm, params, model, x):
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * w)

    jgrads = params_from_flax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    floor = GRAD_FLOOR * float(torch.cat([g.reshape(-1) for g in
                                          jgrads.values()]).norm())
    out = model(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, atol=FWD_ATOL,
                               rtol=0)
    grads = dict(model.named_parameters())
    assert grads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        gap = float((grads[name].grad - g).norm())
        assert gap <= GRAD_REL_L2 * float(g.norm()) + floor, (
            name, gap, float(g.norm()))
    return want


@pytest.mark.parametrize("kw,shape", [
    (dict(conv_bias=True), (1, 18, 20, 22, 1)),
    (dict(trilinear=False), (1, 18, 20, 22, 1)),
    (dict(residual=False), (2, 16, 16, 16, 1)),
    (dict(conv_bias=True, align_corners=True), (1, 18, 20, 22, 1)),
    (dict(trilinear=False, conv_bias=True, residual=False,
          align_corners=True), (1, 18, 20, 22, 1)),
], ids=["bias", "transposed", "value-head", "bias-aligned", "all"])
def test_unet_variants_match_jax(kw, shape):
    jm, params, model, x = _pair(JaxUNet, UNet, kw, shape, seed=2)
    want = _check(jm, params, model, x)
    if kw.get("residual", True):
        assert np.abs(want - x).max() > 0.1  # the head is not the identity


@pytest.mark.parametrize("kw,shape", [
    (dict(residual=False), (1, 32, 32, 32, 1)),
    (dict(residual=False), (1, 33, 34, 35, 1)),
    (dict(trilinear=False, conv_bias=True), (1, 33, 34, 35, 1)),
], ids=["even", "odd-repad", "odd-transposed-bias"])
def test_n2v2_unet_matches_jax(kw, shape):
    jm, params, model, x = _pair(JaxN2V2UNet, N2V2UNet, kw, shape, seed=4)
    _check(jm, params, model, x)


def _vjp_matches(port_fn, jax_fn, *args):
    """Outputs equal; gradients of a seeded cotangent within
    LAYER_GRAD_REL_L2 for every argument."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got = port_fn(*ts)
    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, args))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    for t, w in zip(ts, vjp(jnp.asarray(g))):
        w = np.asarray(w)
        assert np.linalg.norm(t.grad.numpy() - w) <= (
            LAYER_GRAD_REL_L2 * np.linalg.norm(w))


@pytest.mark.parametrize("which", ["max-stride-1", "blur", "max-blur"])
def test_pools_match_jax(which):
    x = np.random.default_rng(5).normal(size=(2, 9, 10, 11, 3)).astype(
        np.float32)
    port_fn, jax_fn = {
        "max-stride-1": (lambda t: max_pool3d(t, window=2, stride=1),
                         lambda a: ju.max_pool3d(a, window=2, stride=1)),
        "blur": (blur_pool3d, ju.blur_pool3d),
        "max-blur": (max_blur_pool3d, ju.max_blur_pool3d)}[which]
    _vjp_matches(port_fn, jax_fn, x)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (1, 5, 1, 3, 8)])
def test_transposed_conv_matches_flax(shape):
    rng = np.random.default_rng(6)
    x = rng.normal(size=shape).astype(np.float32)
    ct = fnn.ConvTranspose(4, (2, 2, 2), strides=(2, 2, 2))
    k = rng.normal(size=(2, 2, 2, shape[-1], 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    assert not np.allclose(k, k[::-1, ::-1, ::-1])  # the flip shows
    _vjp_matches(conv_transpose_2x,
                 lambda a, kk, bb: ct.apply(
                     {"params": {"kernel": kk, "bias": bb}}, a), x, k, b)


@pytest.mark.parametrize("cls,kw", [
    (JaxUNet, dict(conv_bias=True, trilinear=False, residual=False)),
    (JaxN2V2UNet, dict(residual=False, head_init="normal")),
])
def test_families_build_from_their_config(cls, kw):
    cfg = cls(width_multiplier=0.25, **kw).config
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == cfg["model"]
    assert model.config == cfg
    shapes = jax.eval_shape(cls(width_multiplier=0.25, **kw).init,
                            jax.random.key(0), jnp.zeros((1, 16, 16, 16, 1)))
    model.load_state_dict(params_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes["params"])))
