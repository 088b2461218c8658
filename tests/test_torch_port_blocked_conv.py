"""The port's blocked_conv3d against exaspim_tpu.ops.pallas_conv.

The JAX function runs its Pallas kernel in interpret mode, as
``tests/test_pallas_conv.py`` runs it; on the CPU the port runs its plain
version. Tolerances: f32 forward atol/rtol 1e-4 (two f32 sums of 27·Cin
products in different orders), gradients 1e-3 (the same, summed over the
volume), bf16 output within two bf16 ulps of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.ops import pallas_conv as jc
from exaspim_tpu_torch.ops import blocked_conv as tc


def _inputs(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    b, d, h, w = shape
    x = rng.normal(size=(b, d, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.05).astype(np.float32)
    return x, k


@pytest.mark.parametrize("cin,cout,shape", [
    (32, 32, (1, 4, 32, 32)),
    (32, 64, (2, 2, 32, 32)),
    (64, 32, (1, 2, 32, 64)),
])
def test_forward_matches_pallas_interpret(cin, cout, shape):
    x, k = _inputs(0, shape, cin, cout)
    want = jc.blocked_conv3d(jnp.asarray(x), jnp.asarray(k), True)
    got = tc.blocked_conv3d(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_gradients_match_jax_grad():
    x, k = _inputs(1, (1, 2, 32, 32), 32, 32)

    def loss(x, k):
        return jnp.sum(jc.blocked_conv3d(x, k, True) ** 2)

    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    tc.blocked_conv3d(tx, tk).pow(2).sum().backward()
    assert tk.grad.shape == tk.shape and tk.grad.dtype == tk.dtype
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(gk),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 4, 32, 32), 32, 32), ((1, 4, 32, 32), 1, 32),
    ((1, 3, 32, 32), 32, 32), ((1, 4, 16, 16), 32, 32),
    ((32, 64, 64, 64), 32, 32), ((32, 16, 16, 16), 128, 128),
    ((1, 4, 32, 32), 32, 48), ((2, 2, 30, 32), 64, 64),
    ((2, 2, 31, 34), 64, 64), ((1, 2, 32, 16), 32, 32),
])
def test_supports_gate_equals_jax(shape, cin, cout):
    assert tc.supports_blocked_conv(shape, cin, cout) == \
        jc.supports_blocked_conv(shape, cin, cout)


def test_bf16_matches_plain_and_lax():
    """bf16 in, f32 accumulation, one rounding: the wrapper on the CPU is
    the plain version, and both sit within two bf16 ulps of the f32 conv."""
    x, k = _inputs(2, (1, 2, 8, 12), 32, 64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    got = tc.blocked_conv3d(xb, kb)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, 8, 12, 64)
    assert torch.equal(got, tc.blocked_conv3d_plain(xb, kb))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xb.float().numpy()), jnp.asarray(kb.float().numpy()),
        (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    ref = np.asarray(ref)
    assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -7 * \
        np.abs(ref).max()


def test_small_plane_and_odd_depth_are_accepted():
    """The gate is advisory: the bench calls the function at 16³, and the
    reference takes any D."""
    x, k = _inputs(3, (1, 3, 4, 6), 32, 32)
    assert not tc.supports_blocked_conv(x.shape, 32, 32)
    want = jc.blocked_conv3d(jnp.asarray(x), jnp.asarray(k), True)
    got = tc.blocked_conv3d(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("x_shape,k_shape,exc", [
    ((1, 2, 5, 4, 32), (3, 3, 3, 32, 32), "even"),
    ((1, 2, 4, 7, 32), (3, 3, 3, 32, 32), "even"),
    ((2, 4, 4, 32), (3, 3, 3, 32, 32), "B, D, H, W"),
    ((1, 2, 4, 4, 32), (3, 3, 3, 16, 32), "taps"),
    ((1, 2, 4, 4, 32), (27, 32, 32), "taps"),
])
def test_rejects_bad_inputs(x_shape, k_shape, exc):
    with pytest.raises(ValueError, match=exc):
        tc.blocked_conv3d(torch.zeros(x_shape), torch.zeros(k_shape))


def test_rejects_mixed_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        tc.blocked_conv3d(torch.zeros(1, 2, 4, 4, 32),
                          torch.zeros(3, 3, 3, 32, 32, dtype=torch.bfloat16))


def test_cpu_runs_count_no_launch():
    before = tc.blocked_conv3d.launches
    tc.blocked_conv3d(torch.zeros(1, 2, 4, 4, 32),
                      torch.zeros(3, 3, 3, 32, 32))
    assert tc.blocked_conv3d.launches == before


def test_bench_runs_on_the_cpu_at_a_toy_size(monkeypatch):
    """Control flow of the conv bench (the times mean nothing here): three
    columns per shape, equal checksums for the two kernels' plain
    versions."""
    from exaspim_tpu_torch.ops import nb_bench

    monkeypatch.setattr(nb_bench, "SHAPES", ((2, 4, 4, 32, 32),))
    out = nb_bench.main(["--batch", "1"], device="cpu")
    (row,) = out["shapes"]
    assert row["label"] == "B1 2x4x4 C32->32" and row["clock"] == "host"
    for col in ("library", "blocked", "nb"):
        assert row[f"{col}_ms"] > 0 and np.isfinite(row[f"{col}_checksum"])
    assert row["blocked_checksum"] == row["nb_checksum"]
    with pytest.raises(ValueError, match="cin == cout"):
        nb_bench.bench_shape(1, 2, 4, 4, 32, 64, device="cpu")


def test_every_kernel_source_is_registered():
    import os

    from exaspim_tpu_torch.ops import _build

    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    assert sources == sorted(_build.KERNELS) and len(sources) == 7
    assert "blocked_conv3d" in _build.KERNELS
