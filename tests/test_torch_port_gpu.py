"""The port's Hopper conv kernel against its plain version, on the card.

These tests need a CUDA card (marker ``gpu``) and skip elsewhere. They
import nothing of JAX, so they also run on a machine without it:
``python -m pytest --noconftest -q tests/test_torch_port_gpu.py``.
"""

import numpy as np
import pytest
import torch

from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_stats


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_f32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x = torch.zeros(1, 4, 8, 8, 32, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        nb_conv3d(x, torch.zeros(3, 3, 3, 32, 32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("segs,cout,n", [((1,), 32, 20), ((32, 32), 32, 16),
                                         ((64,), 64, 9)])
def test_cuda_kernel_matches_plain(segs, cout, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_plain

    rng = np.random.default_rng(5)
    xs = tuple(torch.from_numpy(_rand(rng, (2, n, n, n, c)))
               .to("cuda", torch.bfloat16) for c in segs)
    k = torch.from_numpy(_rand(rng, (3, 3, 3, sum(segs), cout), 0.05)).to(
        "cuda", torch.bfloat16)
    before = nb_conv3d.launches
    y, s1, s2 = nb_conv3d_stats(xs, k)
    assert nb_conv3d.launches == before + 1
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # a full-f32 plain reference
    try:
        py, p1, p2 = nb_conv3d_plain(xs, k, with_stats=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # One f32 sum rounded to bf16 in two orders: within two bf16 ulps.
    err = (y.float() - py.float()).abs().max().item()
    assert err <= 2.0 ** -7 * py.float().abs().max().item()
    torch.testing.assert_close(s2, p2, rtol=1e-3, atol=0)
    assert ((s1 - p1).abs() <= 1e-3 * py.float().abs().sum((1, 2, 3))).all()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("segs,cout,n,b", [((1,), 32, 12, 2),
                                           ((32, 32), 32, 10, 2),
                                           ((64,), 64, 6, 3)])
def test_dw_kernel_matches_plain(segs, cout, n, b):
    _card()
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw, nb_conv3d_dw_plain

    rng = np.random.default_rng(6)
    xs = tuple(torch.from_numpy(_rand(rng, (b, n, n, n, c)))
               .to("cuda", torch.bfloat16) for c in segs)
    g = torch.from_numpy(_rand(rng, (b, n, n, n, cout), 0.1)).to(
        "cuda", torch.bfloat16)
    before = nb_conv3d_dw.launches
    got = nb_conv3d_dw(xs, g)
    assert nb_conv3d_dw.launches == before + 1
    assert torch.equal(got, nb_conv3d_dw(xs, g))  # no float atomics
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = nb_conv3d_dw_plain(xs, g)
        scale = nb_conv3d_dw_plain(tuple(x.abs() for x in xs), g.abs())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # Exact bf16 products summed in f32 in two orders.
    assert ((got - ref).abs() <= 1e-3 * scale).all()


@pytest.mark.gpu
def test_histogram_kernel_matches_plain():
    _card()
    from exaspim_tpu_torch.compression.proxy import (
        byte_histogram,
        byte_histogram_plain,
    )

    rng = np.random.default_rng(7)
    for rows in (rng.integers(0, 256, (5, 4096), dtype=np.uint8),
                 rng.choice(np.array([0, 255, 9], np.uint8), (3, 1001))):
        v = torch.from_numpy(rows).cuda()
        assert torch.equal(byte_histogram(v), byte_histogram_plain(v))


@pytest.mark.gpu
def test_autograd_through_kernels_matches_plain():
    _card()
    rng = np.random.default_rng(8)
    arrays = [_rand(rng, (2, 12, 12, 12, 32)), _rand(rng, (2, 12, 12, 12, 32)),
              _rand(rng, (27, 64, 32), 0.05), _rand(rng, (2, 12, 12, 12, 32)),
              _rand(rng, (2, 32)), _rand(rng, (2, 32), 0.01)]

    def grads(device, dtype):
        xa, xb, k, gy, g1, g2 = (torch.from_numpy(a).to(device)
                                 for a in arrays)
        xa, xb, k = (t.to(dtype).requires_grad_() for t in (xa, xb, k))
        y, s1, s2 = nb_conv3d_stats((xa, xb), k)
        torch.autograd.backward([y, s1, s2], [gy.to(dtype), g1, g2])
        return [t.grad.float().cpu() for t in (xa, xb, k)]

    for got, want in zip(grads("cuda", torch.bfloat16),
                         grads("cpu", torch.float32)):
        # bf16 inputs and cotangent against f32: ~0.3 % measured.
        assert float((got - want).norm() / want.norm()) < 1e-2
