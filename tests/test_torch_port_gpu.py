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
