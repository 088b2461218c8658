"""The port's 3³ conv (plain version) against the JAX reference.

On the CPU ``nb_conv3d`` runs its plain PyTorch version; it is held
against the Pallas kernel ``nb_conv3d_stats`` run in interpret mode (as
tests/test_nb_conv.py runs it), and the Cin = 1 entry conv against
``lax.conv_general_dilated``. Tolerance 1e-4 (f32 sums in another order);
the stats are compared after folding the reference's four parity lanes.
The gradients are held against JAX in tests/test_torch_port_nb_conv_grad.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.ops.nb_conv import from_blocked, to_blocked
from exaspim_tpu.ops.nb_conv import nb_conv3d_stats as jax_stats
from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_stats


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_two_segment_stats_match_pallas_interpret():
    b, d, h, w, ca, cb, cout = 1, 4, 32, 32, 32, 32, 32
    rng = np.random.default_rng(0)
    xa, xb = _rand(rng, (b, d, h, w, ca)), _rand(rng, (b, d, h, w, cb))
    k = _rand(rng, (3, 3, 3, ca + cb, cout), 0.05)
    out, s1, s2 = jax_stats(
        (to_blocked(jnp.asarray(xa)), to_blocked(jnp.asarray(xb))),
        jnp.asarray(k), h, w, (ca, cb), interpret=True,
    )
    want = np.asarray(from_blocked(out, h, w))
    ws1 = np.asarray(s1).reshape(b, 4, cout).sum(1)
    ws2 = np.asarray(s2).reshape(b, 4, cout).sum(1)

    y, t1, t2 = nb_conv3d_stats(
        (torch.from_numpy(xa), torch.from_numpy(xb)), torch.from_numpy(k))
    assert y.shape == (b, d, h, w, cout) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t1.numpy(), ws1, rtol=1e-4,
                               atol=1e-4 * np.abs(ws1).max())
    np.testing.assert_allclose(t2.numpy(), ws2, rtol=1e-4)
    # The plain mode is the same conv without the sums; packed taps too.
    y2 = nb_conv3d((torch.from_numpy(xa), torch.from_numpy(xb)),
                   torch.from_numpy(k).reshape(27, ca + cb, cout))
    np.testing.assert_array_equal(y2.numpy(), y.numpy())


def test_single_channel_entry_conv_matches_lax():
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 6, 10, 12, 1))
    k = _rand(rng, (3, 3, 3, 1, 32), 0.3)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    )
    y, s1, s2 = nb_conv3d(torch.from_numpy(x), torch.from_numpy(k),
                          with_stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    yf = y.double()
    np.testing.assert_allclose(s1.numpy(), yf.sum((1, 2, 3)).numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), (yf * yf).sum((1, 2, 3)).numpy(),
                               rtol=1e-4)


def test_bf16_stats_come_from_rounded_output():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rand(rng, (1, 4, 8, 8, 32))).bfloat16()
    k = torch.from_numpy(_rand(rng, (3, 3, 3, 32, 32), 0.05)).bfloat16()
    y, s1, s2 = nb_conv3d_stats(x, k)
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    yf = y.float()
    torch.testing.assert_close(s1, yf.sum((1, 2, 3)), rtol=0, atol=0)
    torch.testing.assert_close(s2, (yf * yf).sum((1, 2, 3)), rtol=0, atol=0)


def test_rejects_bad_inputs():
    x = torch.zeros(1, 4, 8, 8, 32)
    with pytest.raises(ValueError):
        nb_conv3d(x, torch.zeros(3, 3, 3, 16, 32))  # Cin mismatch
    with pytest.raises(ValueError):
        nb_conv3d((x, torch.zeros(1, 4, 8, 6, 32)),
                  torch.zeros(3, 3, 3, 64, 32))  # segment shapes differ
    # Gradients flow: all-ones input and taps, cotangent 1. An interior
    # voxel's dL/dx sums 27 taps × 32 outputs; the centre tap's dL/dW sums
    # all 1·4·8·8 voxels.
    x1 = torch.ones(1, 4, 8, 8, 32, requires_grad=True)
    k1 = torch.ones(3, 3, 3, 32, 32, requires_grad=True)
    nb_conv3d(x1, k1).sum().backward()
    assert x1.grad.shape == x1.shape and k1.grad.shape == k1.shape
    assert float(x1.grad[0, 1, 3, 3, 0]) == 27 * 32
    assert torch.all(k1.grad[1, 1, 1] == 4 * 8 * 8)

