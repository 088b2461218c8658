"""The port's Hopper kernels against their plain versions, on the card.

These tests need a CUDA card (marker ``gpu``) and skip elsewhere. They
import nothing of JAX, so they also run on a machine without it:
``python -m pytest --noconftest -q tests/test_torch_port_gpu.py``.
"""

import numpy as np
import pytest
import torch

from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_stats


# dL/dW against its f32 plain version: both sum exact bf16 products in f32,
# in different orders; |Δ| within DW_RTOL of the contraction over |x|, |g|
# (chip_smoke.py's limit, set between the sound and the faulty readings).
DW_RTOL = 1e-5


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
    assert ((got - ref).abs() <= DW_RTOL * scale).all()


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


HIST_CASES = ("one repeated byte", "uniform bytes", "noisy phantom planes",
              "wrap at 0 and 65535", "lengths no multiple of 16",
              "27^3 chunk", "more rows than 65535", "misaligned base")


@pytest.mark.gpu
@pytest.mark.parametrize("case", HIST_CASES)
def test_histogram_entries_match_plain_and_repeat_bit_equal(case):
    """Both entries of csrc/byte_histogram.cu against their plain versions
    (integer counts: exactly equal), each launch once per call, and a
    second launch bit-equal to the first."""
    _card()
    from exaspim_tpu_torch.compression import proxy as P
    from exaspim_tpu_torch.ops.hist_bench import edge_cases

    rows, vols, chunk = edge_cases("cuda")[case]
    n_rows, n_chunks = P.byte_histogram.launches, \
        P.chunk_byte_histograms.launches
    got = P.byte_histogram(rows)
    got_c = P.chunk_byte_histograms(vols, chunk)
    assert P.byte_histogram.launches == n_rows + 1
    assert P.chunk_byte_histograms.launches == n_chunks + 1
    assert torch.equal(got, P.byte_histogram_plain(rows))
    assert torch.equal(got_c, P.chunk_byte_histograms_plain(vols, chunk))
    assert torch.equal(P.byte_histogram(rows), got)
    assert torch.equal(P.chunk_byte_histograms(vols, chunk), got_c)


@pytest.mark.gpu
def test_histogram_call_is_one_kernel_launch():
    """One call of either entry enqueues one kernel and nothing else (no
    memset, no conversion kernel, no copy: a misaligned input is not
    cloned), read from the call captured in a CUDA graph; the proxy's one
    histogram launch is its only byte-histogram node."""
    _card()
    from exaspim_tpu_torch.compression import proxy as P
    from exaspim_tpu_torch.ops.hist_bench import device_ops, edge_cases

    rows, vols, chunk = edge_cases("cuda")["misaligned base"]
    for fn in (lambda: P.byte_histogram(rows),
               lambda: P.chunk_byte_histograms(vols, chunk)):
        ops = device_ops(fn)
        assert len(ops) == 1 and ops[0][0] == "kernel", ops
        assert "byte_histogram" in ops[0][1]
    ops = device_ops(lambda: P.cratio_proxy_batch(vols, chunk))
    assert len([op for op in ops if "byte_histogram" in (op[1] or "")]) == 1
    assert not [op for op in ops if op[0] == "memcpy"], ops


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


_MATCH_PARAMS = [((22, 22, 22), 4, 3, 9, 16), ((19, 16, 13), 4, 3, 5, 8),
                 ((20, 14, 17), 5, 3, 7, 32), ((22, 22, 22), 4, 3, 15, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [None, 3])
@pytest.mark.parametrize("shape,block,step,search,group", _MATCH_PARAMS)
def test_fused_match_kernel_matches_plain(shape, block, step, search, group,
                                          n):
    """One guide (n None) or a batch of three: one launch, the plain
    version's starts exactly, and no (R, W³) table allocated."""
    _card()
    from exaspim_tpu_torch.ops import bm4d_match as tm

    rng = np.random.default_rng(11)
    vols = _rand(rng, (n or 1, *shape), 20.0) + 100.0
    vols = np.pad(vols, [(0, 0)] + [(0, (-(d - block)) % step)
                                    for d in shape], mode="reflect")
    vols = vols[0] if n is None else vols
    g = torch.from_numpy(vols).cuda()
    grid = tm.grid_shape(g.shape[-3:], block, step)
    refs = (n or 1) * grid[0] * grid[1] * grid[2]
    # What the call may hold: the padded guides and the starts (each
    # rounded up to the allocator's 512-byte blocks); a table would add
    # refs * W³ * 2 bytes.
    padded = (n or 1) * np.prod([d + search - 1 for d in g.shape[-3:]]) * 4
    allowed = padded + 3 * refs * group * 4 + 1024
    torch.cuda.synchronize()
    before = (tm.match_topk.launches, tm.match_distances.launches,
              tm.select_topk.launches)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    starts = tm.match_topk(g, block, group, step, search)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    assert (tm.match_topk.launches, tm.match_distances.launches,
            tm.select_topk.launches) == (before[0] + 1, *before[1:])
    assert peak <= allowed, (peak, allowed, refs * search ** 3 * 2)
    want = tm.match_topk_plain(torch.from_numpy(vols), block, group, step,
                               search)
    for a, b in zip(starts, want):
        assert a.dtype == torch.int32 and a.shape == b.shape
        assert torch.equal(a.cpu(), b)
    again = tm.match_topk(g, block, group, step, search)
    assert all(torch.equal(a, b) for a, b in zip(starts, again))


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


@pytest.mark.gpu
def test_bm4d_batch_on_the_card_matches_per_volume():
    """Three volumes staged together: two launches of the fused matcher,
    and each teacher within a count of its per-volume bm4d on ≤ 1e-3 of
    voxels (cuDNN may sum the batched patch conv in another order)."""
    _card()
    import importlib

    from exaspim_tpu_torch.data.synthetic import SyntheticPatchDataset
    from exaspim_tpu_torch.ops import bm4d_match as tm

    tb = importlib.import_module("exaspim_tpu_torch.ops.bm4d")
    ds = SyntheticPatchDataset(n=3, patch_shape=(32, 32, 32), seed=7)
    vols = np.stack([ds.raw_and_fg(i)[0] for i in range(3)]).astype(
        np.float32)
    before = tm.match_topk.launches
    batch = tb.bm4d_batch(vols, 24.0)
    assert tm.match_topk.launches == before + 2
    assert torch.equal(batch, tb.bm4d_batch(vols, 24.0))
    for i in range(3):
        d = (batch[i].round() - tb.bm4d(vols[i], 24.0).round()).abs()
        assert float(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 8, 16, 16), 32, 32), ((1, 6, 10, 12), 64, 64),
    ((2, 5, 6, 18), 96, 160), ((1, 2, 2, 2), 32, 64),
])
def test_blocked_conv_kernel_matches_plain(shape, cin, cout):
    _card()
    from exaspim_tpu_torch.ops.blocked_conv import (
        blocked_conv3d,
        blocked_conv3d_plain,
    )

    rng = np.random.default_rng(8)
    x = torch.from_numpy(_rand(rng, (*shape, cin))).to("cuda", torch.bfloat16)
    k = torch.from_numpy(_rand(rng, (3, 3, 3, cin, cout), 0.05)).to(
        "cuda", torch.bfloat16)
    before = blocked_conv3d.launches
    y = blocked_conv3d(x, k)
    assert blocked_conv3d.launches == before + 1
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # a full-f32 plain reference
    try:
        py = blocked_conv3d_plain(x, k)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # One f32 sum rounded to bf16 in two orders: within two bf16 ulps.
    err = (y.float() - py.float()).abs().max().item()
    assert err <= 2.0 ** -7 * py.float().abs().max().item()


@pytest.mark.gpu
def test_blocked_conv_backward_runs_on_the_kernels():
    _card()
    from exaspim_tpu_torch.ops.blocked_conv import (
        blocked_conv3d,
        blocked_conv3d_plain,
    )
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw

    rng = np.random.default_rng(9)
    x = torch.from_numpy(_rand(rng, (2, 4, 8, 12, 32))).to(
        "cuda", torch.bfloat16)
    k = torch.from_numpy(_rand(rng, (3, 3, 3, 32, 64), 0.05)).to(
        "cuda", torch.bfloat16)
    g = torch.from_numpy(_rand(rng, (2, 4, 8, 12, 64), 0.1)).to(
        "cuda", torch.bfloat16)
    xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
    counts = blocked_conv3d.launches, nb_conv3d.launches, nb_conv3d_dw.launches
    blocked_conv3d(xr, kr).backward(g)
    # Forward and dL/dx on the blocked kernel, dL/dW on the dL/dW kernel,
    # nothing on the other conv.
    assert (blocked_conv3d.launches, nb_conv3d.launches,
            nb_conv3d_dw.launches) == (counts[0] + 2, counts[1],
                                       counts[2] + 1)
    xp, kp = x.float().requires_grad_(), k.float().requires_grad_()
    blocked_conv3d_plain(xp, kp).backward(g.float())
    # bf16 results of f32 sums: relative L2 within bf16's half ulp, 2^-8.
    for got, want in ((xr.grad, xp.grad), (kr.grad, kp.grad)):
        rel = (got.float() - want).norm() / want.norm()
        assert rel.item() <= 2.0 ** -8


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,shape,cin,cout,exc,match", [
    (torch.float32, (1, 2, 4, 4), 32, 32, TypeError, "bf16"),
    (torch.bfloat16, (1, 2, 4, 4), 16, 32, ValueError, "multiples of 32"),
    (torch.bfloat16, (1, 2, 4, 4), 32, 48, ValueError, "multiples of 32"),
    (torch.bfloat16, (1, 2, 5, 4), 32, 32, ValueError, "even"),
])
def test_blocked_conv_raises_on_the_card(x_dtype, shape, cin, cout, exc,
                                         match):
    _card()
    from exaspim_tpu_torch.ops.blocked_conv import blocked_conv3d

    x = torch.zeros((*shape, cin), device="cuda", dtype=x_dtype)
    k = torch.zeros((3, 3, 3, cin, cout), device="cuda", dtype=x_dtype)
    before = blocked_conv3d.launches
    with pytest.raises(exc, match=match):
        blocked_conv3d(x, k)
    assert blocked_conv3d.launches == before


@pytest.mark.gpu
def test_pipeline_streams_on_the_card():
    """Pointwise model on the card: streamed equals direct exactly; the
    reader thread makes no CUDA call (the run would fail otherwise only by
    chance, so the thread's work is checked to be numpy slices)."""
    _card()
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.pipeline import denoise_volume
    from exaspim_tpu_torch.transforms import build_transform

    class DoublePlusOne(torch.nn.Module):
        def forward(self, x):
            return x * 2.0 + 0.01

    t = build_transform({"kind": "linear", "params": {
        "mn": 0.0, "mx": 1000.0, "clip": 8.0}})
    img = np.random.default_rng(3).integers(0, 900, (40, 72, 60)).astype(
        np.uint16)
    kw = dict(patch_size=16, overlap=4, trim=2, batch_size=4)
    direct = predict(img, DoublePlusOne(), t, **kw)
    for extra in ({}, {"max_block_voxels": 20 * 60 * 60}):
        streamed = denoise_volume(img, DoublePlusOne(), t, slab_z=16, **kw,
                                  **extra)
        np.testing.assert_array_equal(streamed, direct)


def _conv_inputs(rng, b, ext, segs, cout):
    xs = tuple(torch.from_numpy(_rand(rng, (b, *ext, c))).to(
        "cuda", torch.bfloat16) for c in segs)
    k = torch.from_numpy(_rand(rng, (27, sum(segs), cout),
                               1.0 / np.sqrt(27 * sum(segs)))).to(
        "cuda", torch.bfloat16)
    return xs, k


# (B, (D, H, W), segments, Cout): each tile mode of csrc/nb_conv3d.cu
# (panel, resident, halo, flat) and the edge shapes of chip_smoke.py
# phase 3: extents no multiple of the tile, 16 and (8|8) channels, Cout 8,
# (64|64) at 6³, an odd width.
_CONV_SHAPES = [(2, (16, 16, 16), (1,), 32), (2, (40, 40, 40), (32, 32), 32),
                (2, (16, 16, 16), (64,), 128), (3, (4, 4, 4), (64,), 64),
                (2, (10, 12, 20), (32,), 32), (2, (8, 8, 8), (16,), 16),
                (2, (8, 8, 8), (8, 8), 8), (2, (8, 8, 8), (32,), 8),
                (2, (6, 6, 6), (64, 64), 64), (1, (5, 7, 9), (3,), 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,ext,segs,cout", _CONV_SHAPES, ids=str)
def test_conv_kernel_edge_shapes_match_plain_and_repeat_bit_equal(
        b, ext, segs, cout):
    _card()
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_plain

    xs, k = _conv_inputs(np.random.default_rng(11), b, ext, segs, cout)
    y, s1, s2 = nb_conv3d_stats(xs, k)
    y2, t1, t2 = nb_conv3d_stats(xs, k)
    # Fixed-order statistics, no atomics: the same bits every launch.
    assert torch.equal(y, y2) and torch.equal(s1, t1) and torch.equal(s2, t2)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        py = nb_conv3d_plain(xs, k)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # One f32 sum rounded to bf16 in two orders: within two bf16 ulps.
    err = (y.float() - py.float()).abs().max().item()
    assert err <= 2.0 ** -7 * py.float().abs().max().item()
    # The statistics are the f32 sums of the kernel's own rounded output.
    yf = y.float()
    assert ((s1 - yf.sum((1, 2, 3))).abs()
            <= 1e-3 * yf.abs().sum((1, 2, 3))).all()
    torch.testing.assert_close(s2, (yf * yf).sum((1, 2, 3)), rtol=1e-3,
                               atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,ext,segs,cout", _CONV_SHAPES[:4], ids=str)
def test_conv_kernel_planted_descriptor_fault_is_caught(b, ext, segs, cout):
    _card()
    from exaspim_tpu_torch.ops import nb_conv as nc

    xs, k = _conv_inputs(np.random.default_rng(12), b, ext, segs, cout)
    good = nc._launch(xs, k, False)
    bad = nc._launch(xs, k, False, debug=1)  # tap 0 reads tap 1's view
    ref = nc.nb_conv3d_plain(xs, k).float()
    scale = ref.abs().max().item()
    assert (good.float() - ref).abs().max().item() <= 2.0 ** -7 * scale
    assert (bad.float() - ref).abs().max().item() > 2.0 ** -7 * scale


# (B, (D, H, W), segments, Cout) whose plan changes with the batch size:
# the 256³ block's deep levels at its batch 9 (12³ BN 128 -> 64 and 6³ two
# warpgroups -> one at batch 2), resident tiles at batch 17 against halo
# tiles at batch 2, and FLAT tiles (BN 128 -> 32).
_SLOT_SHAPES = [(9, (12, 12, 12), (256, 256), 256), (9, (6, 6, 6), (256,), 256),
                (17, (16, 16, 16), (32,), 32), (9, (64, 4, 4), (64,), 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,ext,segs,cout", _SLOT_SHAPES, ids=str)
def test_conv_kernel_batch_slot_independent(b, ext, segs, cout):
    """Two elements launched alone, as a batch of 2 with another tile plan,
    give the bits they get in slots 1 and 2 of the whole batch."""
    _card()
    from exaspim_tpu_torch.ops.nb_conv import _plan

    xs, k = _conv_inputs(np.random.default_rng(13), b, ext, segs, cout)
    def tiling(n):
        p = _plan(n, *ext, segs, cout)
        return p["mode"], p["wg"], p["bn"]

    assert tiling(b) != tiling(2)
    y, s1, s2 = nb_conv3d_stats(xs, k)
    ys, t1, t2 = nb_conv3d_stats(tuple(x[1:3].clone() for x in xs), k)
    assert torch.equal(ys, y[1:3])
    assert torch.equal(t1, s1[1:3]) and torch.equal(t2, s2[1:3])


def _dw_inputs(rng, b, ext, segs, cout):
    xs = tuple(torch.from_numpy(_rand(rng, (b, *ext, c))).to(
        "cuda", torch.bfloat16) for c in segs)
    g = torch.from_numpy(_rand(rng, (b, *ext, cout), 0.1)).to(
        "cuda", torch.bfloat16)
    return xs, g


def _dw_reference(xs, g):
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw_plain

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return (nb_conv3d_dw_plain(xs, g),
                nb_conv3d_dw_plain(tuple(x.abs() for x in xs), g.abs()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# (B, (D, H, W), segments, Cout): each mode of csrc/nb_conv3d_dw.cu (panel,
# zstack for one chunk of at most 32 channels, halo with one or two chunks
# per Cin slice, two segments, three slices, flat for planes of 16 voxels:
# 4^3 of a training step, 8 x 2 and 16 x 1 planes with a partial last tile,
# a part chunk and a half-empty Cout pair), extents no multiple of the
# 8 x 8 x 4 tile, and widths that are no multiple of 8 (x and g staged
# with element loads, g rows not 16-byte aligned; 4^3 at such widths runs
# halo, whose empty rows are skipped).
_DW_SHAPES = [(2, (16, 16, 16), (1,), 32), (2, (12, 12, 12), (32,), 32),
              (2, (9, 11, 13), (64,), 64), (2, (8, 8, 8), (32, 32), 96),
              (3, (4, 4, 4), (128, 64), 256), (2, (6, 6, 6), (256,), 32),
              (2, (5, 7, 9), (19, 19), 9), (2, (8, 8, 8), (9,), 19),
              (2, (7, 7, 7), (1,), 9), (1, (3, 17, 10), (40, 24), 48),
              (4, (2, 3, 2), (8,), 8), (2, (6, 10, 9), (24,), 40),
              (4, (4, 4, 4), (256,), 256), (2, (7, 8, 2), (40,), 24),
              (5, (3, 16, 1), (8, 16), 8), (2, (4, 4, 4), (76,), 76)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,ext,segs,cout", _DW_SHAPES, ids=str)
def test_dw_kernel_modes_and_widths_match_plain(b, ext, segs, cout):
    _card()
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw

    xs, g = _dw_inputs(np.random.default_rng(14), b, ext, segs, cout)
    before = nb_conv3d_dw.launches
    got = nb_conv3d_dw(xs, g)
    assert nb_conv3d_dw.launches == before + 1
    assert torch.equal(got, nb_conv3d_dw(xs, g))  # fixed-order split-K
    ref, scale = _dw_reference(xs, g)
    # Exact bf16 products summed in f32 in two orders.
    assert ((got - ref).abs() <= DW_RTOL * scale).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b,ext,segs,cout", [_DW_SHAPES[i] for i in
                                             (0, 1, 3, 4, 13)], ids=str)
def test_dw_kernel_planted_fault_is_caught(b, ext, segs, cout):
    _card()
    from exaspim_tpu_torch.ops import nb_conv as nc

    xs, g = _dw_inputs(np.random.default_rng(15), b, ext, segs, cout)
    ref, scale = _dw_reference(xs, g)
    good = nc._launch_dw(xs, g)
    bad = nc._launch_dw(xs, g, debug=1)  # tap 0 reads tap 1's view
    assert ((good - ref).abs() <= DW_RTOL * scale).all()
    assert ((bad - ref).abs() > DW_RTOL * scale).any()


# Widths of build_model({"width_multiplier": 0.3}) (stages 9, 19, 38, 76),
# none a multiple of 8 but 76's input: the forward with statistics, dL/dx
# (the forward on the transposed taps, Cout = Cin) and dL/dW on the card.
_ODD_WIDTHS = [((1,), 9), ((9,), 9), ((9,), 19), ((19, 19), 19),
               ((19,), 38), ((38,), 76), ((76, 76), 76), ((9,), 76)]


@pytest.mark.gpu
@pytest.mark.parametrize("segs,cout", _ODD_WIDTHS, ids=str)
def test_conv_any_width_on_the_kernels(segs, cout):
    _card()
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw, nb_conv3d_plain

    rng = np.random.default_rng(16)
    xs, k = _conv_inputs(rng, 2, (8, 12, 10), segs, cout)
    gy = torch.from_numpy(_rand(rng, (2, 8, 12, 10, cout), 0.1)).to(
        "cuda", torch.bfloat16)
    counts = nb_conv3d.launches, nb_conv3d_dw.launches
    xr = tuple(x.clone().requires_grad_() for x in xs)
    kr = k.clone().requires_grad_()
    y, s1, s2 = nb_conv3d_stats(xr, kr)
    y.backward(gy)
    # Forward and dL/dx on the conv kernel, dL/dW on the dL/dW kernel.
    assert (nb_conv3d.launches, nb_conv3d_dw.launches) == (
        counts[0] + 2, counts[1] + 1)
    assert y.shape == (2, 8, 12, 10, cout) and s1.shape == (2, cout)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        py = nb_conv3d_plain(xs, k)
        xp = tuple(x.float().requires_grad_() for x in xs)
        kp = k.float().requires_grad_()
        nb_conv3d_plain(xp, kp).backward(gy.float())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = (y.float() - py.float()).abs().max().item()
    assert err <= 2.0 ** -7 * py.float().abs().max().item()
    yf = y.float()
    assert ((s1 - yf.sum((1, 2, 3))).abs()
            <= 1e-3 * yf.abs().sum((1, 2, 3))).all()
    torch.testing.assert_close(s2, (yf * yf).sum((1, 2, 3)), rtol=1e-3,
                               atol=0)
    # bf16 results of f32 sums against f32: relative L2 within 2^-8.
    grads = [(kr.grad, kp.grad)] + [(a.grad, b.grad) for a, b in zip(xr, xp)]
    for got, want in grads:
        rel = (got.float() - want).norm() / want.norm()
        assert rel.item() <= 2.0 ** -8


def _card_caches(root):
    from exaspim_tpu_torch.data.synthetic import make_synthetic_cache

    tcfg = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
    return (make_synthetic_cache(str(root / "train"), 16, (32, 32, 32), tcfg,
                                 seed=1),
            make_synthetic_cache(str(root / "val"), 4, (32, 32, 32), tcfg,
                                 seed=2))


@pytest.mark.gpu
def test_augmented_training_on_the_card(tmp_path):
    """``train(augment=True)`` on the card: the codes applied are
    ``orientation_code(seed, step)``, the losses finite, every step on
    the conv and dL/dW kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw
    from exaspim_tpu_torch.train import state as ts
    from exaspim_tpu_torch.train.train_bm4dnet import train

    train_dir, val_dir = _card_caches(tmp_path)
    codes, orient = [], ts.orient_batch

    def spy(batch, code):
        codes.append(code)
        return orient(batch, code)

    before = nb_conv3d_dw.launches
    ts.orient_batch = spy
    try:
        t = train([train_dir], [val_dir], str(tmp_path / "run"), epochs=1,
                  batch_size=4, seed=7, width_multiplier=0.25, augment=True,
                  exact_cratio_examples=0, log_every=1)
    finally:
        ts.orient_batch = orient
    assert codes == [ts.orientation_code(7, i) for i in range(4)]
    assert t.state.step == 4
    assert nb_conv3d_dw.launches - before == 4 * 18
    import glob
    import json

    (log,) = glob.glob(str(tmp_path / "run" / "session-*" / "log.jsonl"))
    losses = [json.loads(line).get("loss") for line in open(log)]
    losses = [v for v in losses if v is not None]
    assert len(losses) == 4 and np.all(np.isfinite(losses))


class _Preempted(Exception):
    """Stands for the end of a preempted process."""


@pytest.mark.gpu
def test_resume_on_the_card(tmp_path, monkeypatch):
    """A two-epoch run stopped after its first validation (which wrote
    ``latest_state.ckpt``), resumed by a fresh Trainer for the second
    epoch: the final params within 1e-4 of the same run uninterrupted
    (chip_smoke.py's RESUME_ATOL; on the CPU the two are bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from exaspim_tpu_torch.data.cache import (
        CachedPatchDataset,
        CachedValidateDataset,
    )
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train.train_bm4dnet import train
    from exaspim_tpu_torch.train.trainer import Trainer
    from exaspim_tpu_torch.transforms import build_transform

    train_dir, val_dir = _card_caches(tmp_path)
    cfg = dict(epochs=2, batch_size=4, val_every=4, seed=3,
               exact_cratio_examples=0)
    straight = train([train_dir], [val_dir], str(tmp_path / "a"),
                     width_multiplier=0.25, **cfg)
    save = Trainer.validate_and_checkpoint

    def preempt(self, *args):
        save(self, *args)
        raise _Preempted

    with monkeypatch.context() as m:
        m.setattr(Trainer, "validate_and_checkpoint", preempt)
        with pytest.raises(_Preempted):
            train([train_dir], [val_dir], str(tmp_path / "b"),
                  width_multiplier=0.25, **cfg)
    import glob

    (latest,) = glob.glob(str(tmp_path / "b" / "session-*" / "checkpoints"
                              / "latest_state.ckpt"))
    tcfg = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
    resumed = Trainer(str(tmp_path / "c"),
                      UNet(width_multiplier=0.25, dtype=torch.bfloat16),
                      build_transform(tcfg), **cfg)
    state = resumed.run(CachedPatchDataset([train_dir]),
                        CachedValidateDataset([val_dir]),
                        resume_state=latest)
    assert state.step == straight.state.step == 8
    want, got = straight.state.params, state.params
    gap = max((want[k] - got[k]).abs().max().item() for k in want)
    assert gap <= 1e-4, gap


@pytest.mark.gpu
@pytest.mark.parametrize("dilate", [0, 2])
def test_foreground_mask_on_the_card(dilate):
    """``make_foreground_mask`` of a CUDA tensor (threshold and dilation on
    the card) is the host's mask bit for bit, an odd and an even count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.ops.metrics import make_foreground_mask

    clean, _ = neurite_phantom((33, 41, 48), n_tubes=4, seed=5)
    for vol in (noisy_observation(clean, seed=6), noisy_observation(
            clean, seed=7)[:, :, :47]):
        want = make_foreground_mask(vol, dilate=dilate)
        got = make_foreground_mask(
            torch.from_numpy(vol.astype(np.int32)).cuda(), dilate=dilate)
        assert got.is_cuda
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_n2v_blind_spots_on_the_card():
    """The blind-spot draw of a training batch, made on the card in int64
    tensor arithmetic, has the CPU draw's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from exaspim_tpu_torch.train import prng
    from exaspim_tpu_torch.train.n2v import make_blind_spots

    for seed, step in ((0, 0), (5, 0), (3, 4321)):
        key = prng.fold_in(prng.key(seed), step)
        m_card, s_card = make_blind_spots(key, (16, 64, 64, 64))
        m_cpu, s_cpu = make_blind_spots(key, (16, 64, 64, 64), device="cpu")
        assert m_card.is_cuda and torch.equal(m_card.cpu(), m_cpu)
        assert torch.equal(s_card, s_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("family,kw", [
    ("UNet", dict(conv_bias=True, trilinear=False, residual=False,
                  align_corners=True)),
    ("N2V2UNet", dict(residual=False)),
], ids=["transposed-bias-value", "n2v2"])
def test_new_families_on_the_kernels(family, kw):
    """Every 3³ conv of the new families (N2V2's encoder included) runs
    the kernel: 18 forward launches, and in a backward 17 dL/dx and 18
    dL/dW launches; the output stays within bf16 reach of the f32 CPU
    model (relative L2 of 2e-2, about four times the width-0.3 readings
    of chip_smoke.py phase 10b)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from exaspim_tpu_torch.models import MODEL_REGISTRY
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw

    cls = MODEL_REGISTRY[family]
    cpu = cls(width_multiplier=0.5, head_init="normal", **kw).init_weights(1)
    card = cls(width_multiplier=0.5, head_init="normal",
               dtype=torch.bfloat16, **kw).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0.5, 0.2, (2, 33, 32, 34, 1)).astype(np.float32))
    c0, d0 = nb_conv3d.launches, nb_conv3d_dw.launches
    y = card(x.cuda())
    assert nb_conv3d.launches - c0 == 18
    y.float().square().mean().backward()
    assert nb_conv3d.launches - c0 == 18 + 17
    assert nb_conv3d_dw.launches - d0 == 18
    with torch.no_grad():
        ref = cpu(x)
    rel = ((y.detach().cpu() - ref).norm() / ref.norm()).item()
    assert np.isfinite(rel) and rel <= 2e-2
