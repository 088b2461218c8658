"""The port's conv autograd and dL/dW (plain versions) against JAX.

The port's ``nb_conv3d_stats`` backward (stats fold, flipped-tap dL/dx,
dL/dW) is held against ``jax.vjp`` of the Pallas ``nb_conv3d_stats`` run
in interpret mode through ``to_blocked``/``from_blocked``, with random
cotangents on y, Σy and Σy² (the port's per-channel sums are the sums of
the reference's four parity lanes, so their cotangents tile over them).
``nb_conv3d_dw_plain`` is held against the Pallas ``_nb_conv_dw`` in
interpret mode, and the Cin = 1 entry conv's dW against ``jax.grad`` of
``lax.conv_general_dilated``. All f32; tolerance 1e-4 of max |ref|
(f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.ops.nb_conv import _nb_conv_dw, _row_pad
from exaspim_tpu.ops.nb_conv import from_blocked, to_blocked
from exaspim_tpu.ops.nb_conv import nb_conv3d_stats as jax_stats
from exaspim_tpu_torch.ops.nb_conv import (
    nb_conv3d,
    nb_conv3d_dw,
    nb_conv3d_dw_plain,
    nb_conv3d_stats,
)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("segs", [(32,), (32, 32)])
def test_stats_vjp_matches_jax(segs):
    b, d, h, w, cout = 1, 2, 32, 32, 32
    rng = np.random.default_rng(len(segs))
    xs = [_rand(rng, (b, d, h, w, c)) for c in segs]
    k = _rand(rng, (3, 3, 3, sum(segs), cout), 0.05)
    gy = _rand(rng, (b, d, h, w, cout))
    g1 = _rand(rng, (b, cout))
    g2 = _rand(rng, (b, cout), 0.1)

    def f(xs, k):
        out, s1, s2 = jax_stats(tuple(to_blocked(x) for x in xs), k, h, w,
                                segs, interpret=True)
        return from_blocked(out, h, w), s1, s2

    (y, _, _), vjp = jax.vjp(f, [jnp.asarray(x) for x in xs],
                             jnp.asarray(k))
    gxs, gk = vjp((jnp.asarray(gy), jnp.tile(g1, (1, 4)),
                   jnp.tile(g2, (1, 4))))

    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    tk = torch.from_numpy(k).requires_grad_()
    ty, t1, t2 = nb_conv3d_stats(tuple(tx), tk)
    torch.autograd.backward(
        [ty, t1, t2],
        [torch.from_numpy(gy), torch.from_numpy(g1), torch.from_numpy(g2)])
    _close(ty.detach().numpy(), y)
    for got, want in zip(tx, gxs):
        _close(got.grad.numpy(), want)
    _close(tk.grad.numpy(), gk)


def test_dw_plain_matches_pallas_dw_kernel():
    b, d, h, w, ca, cb, cout = 1, 4, 32, 32, 32, 32, 32
    rng = np.random.default_rng(3)
    xs = [_rand(rng, (b, d, h, w, c)) for c in (ca, cb)]
    g = _rand(rng, (b, d, h, w, cout))
    p = _row_pad(w // 2)

    def resident(a):
        return jnp.pad(to_blocked(jnp.asarray(a)),
                       ((0, 0), (0, 0), (p, p), (0, 0)))

    want = _nb_conv_dw(tuple(resident(x) for x in xs), resident(g), h, w,
                       (ca, cb), True)
    txs = tuple(torch.from_numpy(x) for x in xs)
    got = nb_conv3d_dw_plain(txs, torch.from_numpy(g))
    assert got.shape == (27, ca + cb, cout) and got.dtype == torch.float32
    _close(got.numpy().reshape(want.shape), want)
    # On CPU tensors the dispatching wrapper is the plain version.
    assert torch.equal(nb_conv3d_dw(txs, torch.from_numpy(g)), got)


def test_entry_conv_dw_matches_lax_grad():
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 6, 10, 12, 1))
    g = _rand(rng, (2, 6, 10, 12, 32))

    def contract(k):
        y = jax.lax.conv_general_dilated(
            jnp.asarray(x), k, (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
        return jnp.vdot(y, jnp.asarray(g))

    want = jax.grad(contract)(jnp.zeros((3, 3, 3, 1, 32), jnp.float32))
    _close(nb_conv3d_dw(torch.from_numpy(x), torch.from_numpy(g))
           .numpy().reshape(want.shape), want)
    # Through autograd: the input needs no gradient, so no dL/dx runs.
    tx = torch.from_numpy(x)
    tk = torch.from_numpy(_rand(rng, (3, 3, 3, 1, 32), 0.3)).requires_grad_()
    nb_conv3d(tx, tk).backward(torch.from_numpy(g))
    assert tx.grad is None
    _close(tk.grad.numpy(), want)
