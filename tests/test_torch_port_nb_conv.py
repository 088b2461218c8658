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


# The tile plan of csrc/nb_conv3d.cu, checked here because the kernel runs
# only on the card. Shapes (B, D, H, W, segments, Cout): the inference path's
# six (chip_smoke.py phase 3, B = 2, and the path's own B = 9), every conv of
# one training step (B = 32 of 64³), and extents that are no multiple of the
# tile, with narrow and odd widths.
def _plan_shapes():
    from exaspim_tpu_torch.ops.nb_bench import (
        INFERENCE_SHAPES,
        unet_conv_shapes,
    )

    shapes = {(b, n, n, n, s, c) for b, n, s, c in INFERENCE_SHAPES}
    shapes |= {(9, n, n, n, s, c) for _, n, s, c in INFERENCE_SHAPES}
    shapes |= {(32, n, n, n, segs, cout)
               for _, n, segs, cout in unet_conv_shapes(64)}
    shapes |= {(2, 10, 12, 20, (32,), 32), (2, 8, 8, 8, (16,), 16),
               (2, 8, 8, 8, (8, 8), 8), (2, 8, 8, 8, (32,), 8),
               (2, 6, 6, 6, (64, 64), 64), (1, 5, 7, 9, (3,), 16),
               (3, 13, 9, 17, (40, 24), 48), (1, 3, 17, 30, (1,), 24)}
    return sorted(shapes)


@pytest.mark.parametrize("shape", _plan_shapes(), ids=str)
def test_plan_covers_every_output_voxel_once(shape):
    from exaspim_tpu_torch.ops.nb_conv import (
        _plan,
        _tile_voxels,
        _ws_row_voxels,
    )

    b, d, h, w, segs, cout = shape
    plan = _plan(b, d, h, w, segs, cout)
    bn = plan["bn"]
    assert bn in (32, 64, 128) and plan["wg"] in (1, 2)
    assert plan["ntiles"] * bn >= cout > (plan["ntiles"] - 1) * bn
    if plan["mode"] == "res":
        assert (plan["bn"], plan["wg"]) == (32, 2)
        assert plan["blocks"] == plan["pblocks"] * plan["ntiles"]
    if plan["mode"] == "panel":
        assert segs == (1,)
    if plan["mode"] == "flat":
        assert all(c % 8 == 0 for c in segs)
    vox = torch.cat([_tile_voxels(plan, d, h, w, t)
                     for t in range(plan["tiles"])])
    assert torch.equal(vox.sort().values, torch.arange(d * h * w))
    # The grid has one tile per tile row: the last holds voxels, one more
    # would not. The statistics' workspace, (B, ws_rows, Cout), has a row
    # per unit (a z plane of an 8 x 8 tile, or 64 FLAT voxels); the units
    # cover each element's voxels once, and neither their count nor their
    # voxels depend on the batch size, so neither do the sums' order.
    assert len(_tile_voxels(plan, d, h, w, plan["tiles"] - 1)) > 0
    assert len(_tile_voxels(plan, d, h, w, plan["tiles"])) == 0
    units = [_ws_row_voxels(plan, d, h, w, r) for r in range(plan["ws_rows"])]
    assert all(len(u) > 0 for u in units)
    assert torch.equal(torch.cat(units).sort().values, torch.arange(d * h * w))
    for other in (1, 2, 9, 32):
        p2 = _plan(other, d, h, w, segs, cout)
        assert p2["ws_rows"] == plan["ws_rows"]
        assert (p2["mode"] == "flat") == (plan["mode"] == "flat")


@pytest.mark.parametrize("shape", [(9, 6, 6, 6, (256,), 256),
                                   (9, 6, 6, 6, (256, 256), 256),
                                   (32, 4, 4, 4, (256,), 256),
                                   (32, 8, 8, 8, (256, 256), 256),
                                   (9, 12, 12, 12, (256, 256), 256)],
                         ids=str)
def test_plan_fills_the_card_at_the_deep_levels(shape):
    from exaspim_tpu_torch.ops.nb_conv import SMS, _plan

    assert _plan(*shape)["blocks"] >= SMS == 132


@pytest.mark.parametrize("shape", [(2, 10, 12, 20, (32,), 32),
                                   (2, 6, 6, 6, (64, 64), 64),
                                   (3, 4, 4, 4, (64,), 64),
                                   (2, 40, 40, 40, (32, 32), 32)], ids=str)
def test_fixed_order_stats_model_matches_plain(shape):
    """The kernel's statistics, modelled in plain PyTorch: per workspace row
    (a unit: one z plane of an 8 x 8 tile, or 64 FLAT voxels) the f32 sums
    of the rounded outputs of its voxels, then the rows in order. They
    equal the plain version's to f32 rounding, and the model is
    deterministic by construction."""
    from exaspim_tpu_torch.ops.nb_conv import _plan, _ws_row_voxels

    b, d, h, w, segs, cout = shape
    rng = np.random.default_rng(3)
    xs = tuple(torch.from_numpy(_rand(rng, (b, d, h, w, c))).bfloat16()
               for c in segs)
    k = torch.from_numpy(_rand(rng, (27, sum(segs), cout), 0.05)).bfloat16()
    y, s1, s2 = nb_conv3d_stats(xs, k)
    plan = _plan(b, d, h, w, segs, cout)
    yf = y.float().reshape(b, d * h * w, cout)
    m1 = torch.zeros(b, cout)
    m2 = torch.zeros(b, cout)
    for r in range(plan["ws_rows"]):
        v = yf[:, _ws_row_voxels(plan, d, h, w, r)]
        m1 += v.sum(1)
        m2 += (v * v).sum(1)
    scale = yf.abs().sum(1)
    assert float(((m1 - s1).abs() / scale).max()) < 1e-5
    assert float(((m2 - s2).abs() / s2).max()) < 1e-5


# The dL/dW plan of csrc/nb_conv3d_dw.cu: every conv of one training step
# (B = 32 of 64³), the odd widths of width 0.3, and small or ragged volumes.
def _dw_plan_shapes():
    from exaspim_tpu_torch.ops.nb_bench import unet_dw_shapes

    shapes = {(32, n, n, n, segs, cout) for n, segs, cout
              in unet_dw_shapes(64)}
    shapes |= {(2, n, n, n, segs, cout) for n, segs, cout
               in unet_dw_shapes(32, width=0.3)}
    shapes |= {(2, 12, 12, 12, (1,), 32), (2, 9, 11, 13, (64,), 64),
               (3, 4, 4, 4, (128, 64), 256), (1, 3, 17, 10, (40, 24), 48),
               (4, 2, 3, 2, (8,), 8), (2, 5, 7, 9, (19, 19), 9),
               (2, 7, 8, 2, (40,), 24), (5, 3, 16, 1, (8, 16), 8),
               (2, 6, 4, 4, (32,), 9), (2, 4, 2, 8, (64,), 64)}
    return sorted(shapes)


@pytest.mark.parametrize("shape", _dw_plan_shapes(), ids=str)
def test_dw_plan_covers_every_tile_once_and_fills_the_card(shape):
    from exaspim_tpu_torch.ops.nb_conv import SMS, _cdiv, _dw_plan

    b, d, h, w, segs, cout = shape
    plan = _dw_plan(b, d, h, w, segs, cout)
    chunks = sum(_cdiv(c, 32) for c in segs)
    vec = all(c % 8 == 0 for c in segs) and cout % 8 == 0
    # FLAT: whole planes of 16 voxels, no padded K row (4³ of a step).
    flat = segs != (1,) and vec and h * w == 16 and (h + 2) * w <= 24
    zstack = not flat and chunks == 1 and segs[0] % 8 == 0
    assert plan["mode"] == ("panel" if segs == (1,) else "flat" if flat
                            else "zstack" if zstack else "halo")
    if flat:  # tiles of eight planes of the batch, across its elements
        assert plan["tiles"] == plan["total"] == _cdiv(b * d, 8)
    else:
        zt = 4 if segs == (1,) else 2
        assert plan["tiles"] == _cdiv(d, zt) * _cdiv(h, 8) * _cdiv(w, 8)
        assert plan["total"] == b * plan["tiles"]
    # Split s walks tiles [s·per, min((s+1)·per, total)): together every
    # tile once, and no split empty (each writes its workspace slice).
    spans = [range(s * plan["per"], min((s + 1) * plan["per"], plan["total"]))
             for s in range(plan["splits"])]
    assert all(len(r) > 0 for r in spans)
    assert [t for r in spans for t in r] == list(range(plan["total"]))
    assert plan["splits"] <= 65535
    slices = 1 if segs == (1,) else chunks if zstack else _cdiv(chunks, 2)
    # HALO, FLAT: a block per dz plane; FLAT's blocks take 64 columns.
    dz = 3 if plan["mode"] in ("halo", "flat") else 1
    bn = 64 if flat else 32
    assert (plan["slices"], plan["bn"], plan["ctiles"], plan["dz"]) == (
        slices, bn, _cdiv(cout, bn), dz)
    base = dz * slices * plan["ctiles"]
    assert plan["blocks"] == base * plan["splits"]
    if flat:  # one block per SM: as many splits as run in one wave
        s = plan["splits"]
        assert s == 1 or plan["blocks"] <= SMS
        assert s == plan["total"] or base * (s + 1) > SMS or _cdiv(
            plan["total"], _cdiv(plan["total"], s + 1)) == s
    else:
        assert plan["blocks"] >= min(SMS, base * plan["total"])
    # Deterministic: the same plan from a fresh computation.
    assert dict(_dw_plan.__wrapped__(b, d, h, w, segs, cout)) == dict(plan)
