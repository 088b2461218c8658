"""The port's BM4D block matching against exaspim_tpu.ops.pallas_bm4d.

On CPU tensors ``match_topk`` runs its plain versions; the JAX side runs
its Pallas kernels in interpret mode. Both keep the same three bf16
rounding points, so the starts are held equal on at least 99 % of the
references, and every member that differs must be a near-tie under an
independent float64 oracle (within 2 % of the oracle's worst accepted
distance: three bf16 roundings of 2⁻⁸ each).
"""

import numpy as np
import pytest
import torch

from exaspim_tpu.ops.pallas_bm4d import match_topk as jax_match_topk
from exaspim_tpu_torch.ops import bm4d_match as tm


def _oracle_distances(guide, block, step, search):
    """float64 distances ``(R, W, W, W)`` indexed by offset digits
    (dz, dy, dx), references z-major."""
    half = search // 2
    g = np.pad(guide.astype(np.float64), half, mode="reflect")
    Z, Y, X = guide.shape
    out = []
    for z in range(0, Z - block + 1, step):
        for y in range(0, Y - block + 1, step):
            for x in range(0, X - block + 1, step):
                ref = g[z + half: z + half + block,
                        y + half: y + half + block,
                        x + half: x + half + block]
                win = np.lib.stride_tricks.sliding_window_view(
                    g[z: z + block + search - 1, y: y + block + search - 1,
                      x: x + block + search - 1], (block,) * 3)
                out.append(((win - ref) ** 2).sum(axis=(3, 4, 5)))
    return np.asarray(out)


def _volume(shape, seed, block=4, step=3):
    rng = np.random.default_rng(seed)
    vol = rng.normal(100.0, 20.0, shape).astype(np.float32)
    return np.pad(vol, [(0, (-(d - block)) % step) for d in shape],
                  mode="reflect")


@pytest.mark.parametrize("shape,search,group", [
    ((16, 16, 16), 5, 8),
    ((19, 16, 13), 5, 8),
    ((22, 22, 22), 9, 16),  # the defaults
])
def test_match_topk_matches_jax(shape, search, group):
    vol = _volume(shape, 3)
    got = [s.numpy() for s in tm.match_topk(
        torch.from_numpy(vol), block=4, group=group, step=3,
        search=search)]
    _assert_matches_jax(vol, got, search, group)


@pytest.mark.parametrize("shape,search,group", [
    ((22, 22, 22), 9, 16),  # the defaults
    ((19, 16, 13), 5, 8),
])
def test_batched_match_topk_matches_jax(shape, search, group):
    """A batch of three guides: (N, R, K) starts, each volume's equal to
    the single-guide call's and held to the JAX matcher as one guide is."""
    vols = np.stack([_volume(shape, seed) for seed in (4, 5, 6)])
    got = tm.match_topk(torch.from_numpy(vols), block=4, group=group, step=3,
                        search=search)
    for i, vol in enumerate(vols):
        one = tm.match_topk(torch.from_numpy(vol), block=4, group=group,
                            step=3, search=search)
        for a, b in zip(got, one):
            assert a.shape == (3, *b.shape)
            assert torch.equal(a[i], b)
        _assert_matches_jax(vol, [s[i].numpy() for s in got], search, group)


def _assert_matches_jax(vol, got, search, group):
    B, step = 4, 3
    want = [np.asarray(s) for s in jax_match_topk(
        vol, block=B, group=group, step=step, search=search, interpret=True)]
    gz, gy, gx = tm.grid_shape(vol.shape, B, step)
    R = gz * gy * gx
    for g, w in zip(got, want):
        assert g.shape == w.shape == (R, group) and g.dtype == np.int32
    # Member 0 of every group is the reference itself.
    refs = np.stack(np.meshgrid(np.arange(gz) * step, np.arange(gy) * step,
                                np.arange(gx) * step, indexing="ij"),
                    -1).reshape(R, 3)
    np.testing.assert_array_equal(np.stack([g[:, 0] for g in got], -1), refs)

    got_o = np.stack(got, -1) - refs[:, None]   # (R, K, 3) signed offsets
    want_o = np.stack(want, -1) - refs[:, None]
    same = (got_o == want_o).all(axis=(1, 2))
    assert same.mean() >= 0.99, same.mean()
    half = search // 2
    oracle = _oracle_distances(vol, B, step, search)
    for r in np.nonzero(~same)[0]:
        gs = set(map(tuple, got_o[r]))
        ws = set(map(tuple, want_o[r]))
        cut = max(oracle[r][tuple(np.add(o, half))] for o in ws)
        for o in gs - ws:
            d = oracle[r][tuple(np.add(o, half))]
            assert d <= cut * (1 + 2e-2) + 1e-9, (r, o, d, cut)


def test_selection_is_an_exact_topk_with_near_offset_ties():
    """On a constant guide every distance is 0: the key's low half alone
    picks the group, nearest offsets first, the reference itself first."""
    vol = torch.full((10, 10, 10), 7.0)
    grid = tm.grid_shape(vol.shape, 4, 3)
    table = tm.match_distances(vol, 4, 3, 5)
    assert table.dtype == torch.bfloat16 and table.shape == (27, 125)
    assert not table.float().any()
    sz, sy, sx = tm.select_topk(table, grid, 7, 3, 5)
    r = 13  # the centre reference, start (3, 3, 3)
    offs = np.stack([sz[r].numpy() - 3, sy[r].numpy() - 3,
                     sx[r].numpy() - 3], -1)
    assert (offs[0] == 0).all()
    # The six face neighbours follow, ordered by the (dy, dx, dz) digits.
    assert sorted(map(tuple, offs[1:])) == sorted(
        [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
         (0, 0, 1)])
    assert [tuple(o) for o in offs[1:3]] == [(0, -1, 0), (0, 0, -1)]
    # Any exact top-K of the unique keys gives the same starts.
    keys = tm._keys(table, 5)
    best = torch.sort(keys, dim=1).values[:, :7]
    for a, b in zip((sz, sy, sx), tm._starts(best, grid, 3, 5)):
        assert torch.equal(a, b)


def test_table_keeps_the_three_rounding_points():
    """The table equals a direct evaluation with bf16 roundings after the
    z, y and x sums, entry for entry."""
    vol = _volume((10, 13, 10), 7)
    B, step, W = 4, 3, 3
    table = tm.match_distances_plain(torch.from_numpy(vol), B, step, W)
    gz, gy, gx = tm.grid_shape(vol.shape, B, step)
    g = np.pad(vol, 1, mode="reflect")

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).to(torch.float32).numpy()

    rng = np.random.default_rng(0)
    for _ in range(40):
        gi, gj, gk = (rng.integers(0, n) for n in (gz, gy, gx))
        dz, dy, dx = rng.integers(0, W, 3)
        z, y, x = gi * step + 1, gj * step + 1, gk * step + 1
        ref = g[z:z + B, y:y + B, x:x + B]
        cand = g[z + dz - 1:z + dz - 1 + B, y + dy - 1:y + dy - 1 + B,
                 x + dx - 1:x + dx - 1 + B]
        d = (ref - cand) ** 2
        fz = d[0]
        for t in range(1, B):
            fz = fz + d[t]
        fz = bf16(fz)
        fy = fz[0]
        for t in range(1, B):
            fy = fy + fz[t]
        fy = bf16(fy)
        fx = fy[0]
        for t in range(1, B):
            fx = fx + fy[t]
        want = bf16(fx)
        got = table[(gi * gy + gj) * gx + gk, (dz * W + dy) * W + dx]
        assert float(got) == float(want)


def test_rejects_bad_inputs():
    ok = torch.zeros(10, 10, 10)
    with pytest.raises(ValueError, match="matcher='dense'"):
        tm.match_topk(torch.zeros(22, 22, 22), search=17)
    with pytest.raises(ValueError, match="% 3 == 0"):
        tm.match_topk(torch.zeros(11, 10, 10))
    with pytest.raises(ValueError, match="too small"):
        tm.match_topk(torch.zeros(4, 10, 10), search=9)
    with pytest.raises(ValueError, match="odd"):
        tm.match_topk(ok, search=4)
    with pytest.raises(ValueError, match="3D"):
        tm.pad_guide(torch.zeros(10, 10), 5)
    table = tm.match_distances(ok, 4, 3, 3)
    with pytest.raises(ValueError, match="bf16 table"):
        tm.select_topk(table.float(), (3, 3, 3), 8, 3, 3)
    with pytest.raises(ValueError, match="group size"):
        tm.select_topk(table, (3, 3, 3), 28, 3, 3)
    assert tm.match_distances.launches == 0 and tm.select_topk.launches == 0


@pytest.mark.parametrize("search", [5, 7, 9, 15])
@pytest.mark.parametrize("block", [4, 5])
@pytest.mark.parametrize("table", [False, True])
def test_match_plan_fits_and_covers_every_reference(block, search, table):
    """The fused kernel's tile plan: its shared memory fits a block of an
    H100, its tiles cover every reference of the grid exactly once, and a
    warp's 32 consecutive offset tasks read 32 different banks."""
    for grid in ((21, 21, 21), (43, 43, 43), (6, 5, 4), (1, 1, 9)):
        p = tm._match_plan(grid, block, 3, search, table)
        ty, tx, d = p["ty"], p["tx"], p["d"]
        assert p["shared"] < 227 * 1024
        assert 32 <= p["threads"] <= 256 and p["threads"] % 32 == 0
        assert search % d == 0 and (d == 1 or (block, d) == (4, 3))
        assert ty in (3, 4) if block == 4 else 1 <= ty <= 4
        seen = np.zeros(grid, int)
        gz, tiles_y, tiles_x = p["tiles"]
        assert gz == grid[0]
        for tyi in range(tiles_y):
            for txi in range(tiles_x):
                ys = np.arange(tyi * ty, min((tyi + 1) * ty, grid[1]))
                xs = np.arange(txi * tx, min((txi + 1) * tx, grid[2]))
                assert len(ys) and len(xs)  # no empty tile
                seen[:, ys[:, None], xs[None, :]] += 1
        assert (seen == 1).all()
        # The union of a tile, and the pitches that spread its lanes.
        uy = (ty - 1) * 3 + block + search - 1
        ux = (tx - 1) * 3 + block + search - 1
        assert p["sy"] >= ux and p["sz"] >= uy * p["sy"]
        w3 = search ** 3
        keys = 0 if table else 2 * (-(-w3 // 8) * 8 + ty * tx * w3)
        union = 4 * (block + search - 1) * p["sz"]
        if block == 4:  # 16-byte aligned, then the float4 reference rows
            union = -(-union // 16) * 16 + 16 * (3 * tx + 1) * (3 * ty + 1)
        assert p["shared"] == union + keys
        groups = search // d
        tau = np.arange(search * groups * search)
        dx, dy0, dz = (tau % search, (tau // search) % groups * d,
                       tau // (search * groups))
        banks = (dz * p["sz"] + dy0 * p["sy"] + dx) % 32
        for lo in range(0, len(tau), 32):
            assert len(set(banks[lo:lo + 32])) == len(banks[lo:lo + 32])


def test_match_bench_runs_on_the_cpu():
    from exaspim_tpu_torch.ops import match_bench

    out = match_bench.main(["16", "--batch", "2", "--reps", "1", "--plain"],
                           device="cpu")
    rec, = out["matcher"]
    assert rec["fused"] and rec["refs"] == 125 and rec["shape"] == [16] * 3
    for key in ("match_topk_ms", "match_topk_batch_ms_per_guide",
                "table_batch_ms_per_guide", "table_ms", "select_ms",
                "topk_ms", "plain_ms", "bound_ms"):
        assert rec[key] > 0
    assert rec["bound_by"] == "operations"
    assert rec["device"].startswith("cpu")
