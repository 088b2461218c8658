"""The port's Hopper kernels against their plain versions, on the card.

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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,block,step,search,group", [
    ((22, 22, 22), 4, 3, 9, 16), ((19, 16, 13), 4, 3, 5, 8),
    ((20, 14, 17), 5, 3, 7, 32), ((22, 22, 22), 4, 3, 15, 16),
])
def test_match_and_select_kernels_match_plain(shape, block, step, search,
                                              group):
    _card()
    from exaspim_tpu_torch.ops import bm4d_match as tm

    rng = np.random.default_rng(9)
    vol = _rand(rng, shape, 20.0) + 100.0
    vol = np.pad(vol, [(0, (-(d - block)) % step) for d in shape],
                 mode="reflect")
    g = torch.from_numpy(vol).cuda()
    before = tm.match_distances.launches, tm.select_topk.launches
    table = tm.match_distances(g, block, step, search)
    grid = tm.grid_shape(g.shape, block, step)
    starts = tm.select_topk(table, grid, group, step, search)
    assert (tm.match_distances.launches, tm.select_topk.launches) == (
        before[0] + 1, before[1] + 1)
    # Same f32 operations in the same order, no FMA contraction: equal
    # bits, on the card and against the plain version on the CPU.
    assert torch.equal(table, tm.match_distances_plain(g, block, step, search))
    assert torch.equal(table.cpu(), tm.match_distances_plain(
        torch.from_numpy(vol), block, step, search))
    for a, b in zip(starts, tm.select_topk_plain(table, grid, group, step,
                                                 search)):
        assert torch.equal(a, b)
    for a, b in zip(tm.match_topk(g, block, group, step, search), starts):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_asinh_kernels_match_plain():
    _card()
    from exaspim_tpu_torch.ops import elementwise as te
    from exaspim_tpu_torch.transforms import AsinhTransform

    rng = np.random.default_rng(10)
    raw = (rng.poisson(300, (33, 31, 29)) + 37).astype(np.uint16)
    raw.reshape(-1)[:3] = (0, 65535, 100)
    x = torch.from_numpy(raw).cuda()
    t = AsinhTransform(offset=100.0, scale=60.0)
    kw = dict(offset=100.0, scale=60.0, norm=t._norm)
    before = te.asinh_forward.launches, te.asinh_inverse.launches
    y = te.asinh_forward(x, **kw)
    back = te.asinh_inverse(y, **kw)
    assert (te.asinh_forward.launches, te.asinh_inverse.launches) == (
        before[0] + 1, before[1] + 1)
    # Same operations as the plain versions; log, exp and sqrt may round
    # the last bit differently: 4 f32 ulps, and counts within 1.
    torch.testing.assert_close(y, te.asinh_forward_plain(x, **kw),
                               rtol=2.0 ** -21, atol=1e-7)
    assert torch.equal(y, te.asinh_forward(x.to(torch.float32), **kw))
    torch.testing.assert_close(y, t.forward(x.to(torch.float32)),
                               rtol=0, atol=1e-6)
    assert torch.equal(back.cpu(), torch.from_numpy(raw))
    noisy = y + 0.01 * torch.randn_like(y)
    d = (te.asinh_inverse(noisy, **kw).to(torch.int32)
         - te.asinh_inverse_plain(noisy, **kw).to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.gpu
def test_bm4d_on_the_card_is_deterministic_and_matches_the_cpu():
    _card()
    import importlib

    from exaspim_tpu_torch.data.synthetic import SyntheticPatchDataset

    tb = importlib.import_module("exaspim_tpu_torch.ops.bm4d")
    raw, _ = SyntheticPatchDataset(n=1, patch_shape=(32, 32, 32),
                                   seed=42).raw_and_fg(0)
    vol = raw.astype(np.float32)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    a = tb.bm4d(vol, 24.0)
    assert a.device.type == "cuda"
    assert torch.equal(a, tb.bm4d(vol, 24.0))  # no float atomics
    assert flags == (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.are_deterministic_algorithms_enabled())
    cpu = tb.bm4d(vol, 24.0, device="cpu")
    # Same groups (the tables are bit-equal); sums in another order flip
    # a rare coefficient at the threshold: teachers within 1 count.
    d = (a.cpu().round() - cpu.round()).abs()
    assert float(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
