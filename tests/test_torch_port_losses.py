"""The port's losses against exaspim_tpu.losses (f32, 1e-6 relative),
including the loss's gradient near the Charbonnier knee."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu import losses as jl
from exaspim_tpu_torch import losses as tl


@pytest.mark.parametrize("fg_weight,eps", [(20.0, 1e-3), (0.0, 1e-3),
                                           (5.0, 1e-2)])
def test_signal_preserving_loss_matches_jax(fg_weight, eps):
    rng = np.random.default_rng(int(fg_weight))
    pred = rng.normal(0.4, 0.1, (2, 6, 7, 8, 1)).astype(np.float32)
    target = (pred + rng.normal(0.0, 2e-3, pred.shape)).astype(np.float32)
    fg = rng.random(pred.shape) < 0.3

    def jloss(p):
        return jl.signal_preserving_loss(p, target, fg, fg_weight, eps)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tl.SignalPreservingLoss(fg_weight, eps)(
        p, torch.from_numpy(target), torch.from_numpy(fg).float())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-12)
    d = rng.normal(size=50).astype(np.float32)
    np.testing.assert_allclose(
        tl.charbonnier(torch.from_numpy(d), eps).numpy(),
        np.asarray(jl.charbonnier(jnp.asarray(d), eps)), rtol=1e-6)
