"""The port's multi-GPU layer at three ranks, on the CPU.

Two ranks are both end ranks; three give a middle rank that sends and
receives halos on both sides in one ``batch_isend_irecv``. Three gloo
ranks, started with the ``spawn`` method, run the port only
(``tests/_torch_port_parallel_ranks3_worker.py``) on the same
numpy-seeded inputs and a JAX-written width-0.25 UNet checkpoint; the JAX
side runs here, in the parent, on the conftest's virtual CPU mesh (3
devices where it shards). Held:

* ``exchange_halos``' ``(from_above, from_below)`` on every rank equal to
  the slices of the whole tensor next to its slab (zeros past the ends),
  at a halo narrower than the slab and at one as wide; ``gather_z`` the
  whole tensor and ``all_reduce_sum_`` the sum, on every rank;
* ``predict_sharded`` bit-equal to one ``predict`` in both stitch
  branches (the parity canvas, whose middle shard starts on an odd grid
  row, and the patch-by-patch stitch), uint16 and float, on every rank;
  its float result against the JAX package within
  ``test_torch_port_inference.py``'s cross-package tolerance (1e-3): the
  canvas branch against JAX's single-device ``predict`` and, on the
  planes the last core's rows past the global grid do not reach (JAX
  weights them; the port zeroes them), JAX's ``predict_sharded`` over 3
  devices; the scatter branch against JAX's single-device oracle of the
  same geometry (``test_torch_port_parallel.py``: JAX pads each shard's
  patch list by repeating its last patch);
* ``bm4d_sharded`` bit-equal to ``bm4d`` of the z-reflect-extended volume
  cropped back, on every rank; with the f32 dense matcher within the
  cross-package two-stage teacher bound (RMSE ≤ 5e-2·σ,
  ``test_torch_port_bm4d.py``) of JAX's ``bm4d`` of the same extended
  volume and of JAX's ``bm4d_sharded`` over 3 devices;
* the plan of every shard (``_shard_starts``, ``_canvas_rows``) against
  JAX's ``plan_shards`` at 3 and 4 shards, JAX's repeated padding starts
  left out;
* one data-parallel step (3 ranks × 2) against one step of the whole
  batch of 6, at ``chip_smoke.py``'s bounds for the card (loss 1e-6
  relative, gradient relative L2 6e-3, parameters 2·lr apart at most and
  at most 2.5 % of them by more than 1e-6), the parameters bit-equal
  across the ranks; the loss against ``jax.value_and_grad`` of the
  batch-of-6 loss (1e-5 relative) and the all-reduced gradient against
  ``jax.grad`` (relative L2 ≤ 5e-3 per parameter,
  ``test_torch_port_parallel.py``'s bound).
"""

import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import Mesh

import exaspim_tpu.inference as ji
from exaspim_tpu import parallel as jpar
from exaspim_tpu.losses import signal_preserving_loss as jax_loss
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.ops.bm4d import bm4d as jax_bm4d
from exaspim_tpu.train.checkpoint import save_checkpoint as jax_save
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.parallel.spatial import _canvas_rows, _shard_starts

import _torch_port_parallel_ranks3_worker as worker
from test_torch_port_parallel import _jax_scatter_oracle

WORLD = 3
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
KW = dict(width_multiplier=0.25, head_init="normal")
# z 54 over 3 ranks, cores of 18. Canvas (patch 16, stride 12): shard
# rows 0-1, 1-2 (the middle shard starts on odd row 1) and 2-4, whose
# last row runs past the volume. Patch by patch: stride 6.
PREDICT = {
    "canvas": dict(patch_size=16, overlap=4, trim=2, batch_size=4),
    "scatter": dict(patch_size=16, overlap=10, trim=2, batch_size=4),
}
BM4D = dict(sigma=25.0, search=5)  # halo 21; cores of 24 planes
DP = dict(lr=1e-3, total_steps=10, fg_weight=5.0)
HALOS = (2, 6)  # slabs of 6 planes
# chip_smoke.py's bounds on the data-parallel step (DP_*).
DP_LOSS_RTOL, DP_GRAD_REL_L2 = 1e-6, 6e-3
DP_PARAM_ATOL, DP_FLIP_SHARE = 2e-3 * 1.001, 0.025


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The job's inputs, then the three ranks' results."""
    root = tmp_path_factory.mktemp("ranks3")
    rng = np.random.default_rng(3)
    jm = JaxUNet(**KW)
    params = jax.jit(jm.init)(jax.random.key(7),
                              jnp.zeros((1, 16, 16, 16, 1)))["params"]
    ckpt = jax_save(str(root / "init.ckpt"), params, jm.config, TCFG)
    # A small residual keeps predictions near the input's counts, where
    # the asinh inverse does not amplify f32 rounding into counts
    # (test_torch_port_inference.py).
    small = {**params, "Conv_0": {
        "kernel": params["Conv_0"]["kernel"] * 0.02,
        "bias": params["Conv_0"]["bias"]}}
    predict_ckpt = jax_save(str(root / "predict.ckpt"), small, jm.config,
                            TCFG)
    x = rng.normal(0.0, 1.0, (6, 16, 16, 16, 1)).astype(np.float32)
    data = {
        "whole": rng.normal(size=(6 * WORLD, 4, 5)).astype(np.float32),
        "img": rng.poisson(300.0, (54, 20, 18)).astype(np.uint16),
        "bm4d_vol": rng.normal(300.0, 25.0, (72, 16, 16)).astype(np.float32),
        "dp_x": x,
        # Targets 5 away from the input: the Charbonnier derivative sits
        # at ±1, away from its knee.
        "dp_y": (x + 5.0 * rng.choice([-1.0, 1.0], x.shape)).astype(
            np.float32),
        "dp_fg": rng.random(x.shape) < 0.2,
    }
    job = {"ckpt": ckpt, "predict_ckpt": predict_ckpt, "tcfg": TCFG, "predict": PREDICT, "bm4d": BM4D,
           "dp": DP, "halos": list(HALOS)}
    np.savez(root / "job.npz", **data)
    with open(root / "job.json", "w") as f:
        json.dump(job, f)
    mp.start_processes(worker.run, args=(WORLD, _free_port(), str(root)),
                       nprocs=WORLD, start_method="spawn")
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    return {"data": data, "ranks": ranks, "params": params,
            "predict_params": small}


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("z",))


@pytest.mark.parametrize("halo", HALOS)
def test_exchange_halos_with_a_middle_rank(run, halo):
    whole = run["data"]["whole"]
    core = whole.shape[0] // WORLD
    zeros = np.zeros((halo,) + whole.shape[1:], np.float32)
    for r, got in enumerate(run["ranks"]):
        lo, hi = r * core, (r + 1) * core
        above = whole[lo - halo:lo] if r > 0 else zeros
        below = whole[hi:hi + halo] if r < WORLD - 1 else zeros
        np.testing.assert_array_equal(got[f"above_{halo}"], above)
        np.testing.assert_array_equal(got[f"below_{halo}"], below)


def test_gather_and_all_reduce_over_three_ranks(run):
    whole = run["data"]["whole"]
    core = whole.shape[0] // WORLD
    total = sum((r + 1) * whole[r * core:(r + 1) * core]
                for r in range(WORLD))
    for got in run["ranks"]:
        np.testing.assert_array_equal(got["gathered"], whole)
        np.testing.assert_allclose(got["summed"], total, rtol=1e-6)


@pytest.mark.parametrize("branch", sorted(PREDICT))
@pytest.mark.parametrize("kind", ["u16", "float"])
def test_predict_sharded_bit_equal_to_predict(run, branch, kind):
    want = run["ranks"][0][f"single_{branch}_{kind}"]
    assert want.shape == run["data"]["img"].shape
    assert np.isfinite(want).all()
    for r in run["ranks"]:
        got = r[f"sharded_{branch}_{kind}"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("branch", sorted(PREDICT))
def test_predict_sharded_matches_jax(run, branch):
    img, kw = run["data"]["img"], PREDICT[branch]
    jm, t, p = JaxUNet(**KW), jax_transform(TCFG), run["predict_params"]
    got = run["ranks"][1][f"sharded_{branch}_float"]  # the middle rank's
    if branch == "canvas":
        wants = [(ji.predict(img, jm, p, t, return_float=True, **kw),
                  img.shape[0])]
        # JAX's sharded canvas also weights the last core's rows past the
        # global grid; held on the planes before the first of them reaches.
        stride = kw["patch_size"] - kw["overlap"]
        last = ji.generate_patch_starts(img.shape, kw["patch_size"],
                                        kw["overlap"])[:, 0].max()
        k1 = _canvas_rows(img.shape[0], WORLD, kw["patch_size"],
                          kw["overlap"])[-1][1]
        extra = [k * stride for k in range(k1 + 1) if k * stride > last]
        z = extra[0] + kw["trim"] if extra else img.shape[0]
        assert z > 2 * img.shape[0] // WORLD  # the middle core is held
        wants.append((jpar.predict_sharded(img, jm, p, t, _mesh(WORLD),
                                           return_float=True, **kw), z))
    else:
        wants = [(_jax_scatter_oracle(img, jm, p, t, **kw), img.shape[0])]
    for want, z in wants:
        np.testing.assert_allclose(got[:z], np.asarray(want)[:z],
                                   rtol=1e-3, atol=1e-3)


def test_bm4d_sharded_equals_reflect_extended_bm4d(run):
    want = run["ranks"][0]["bm4d_oracle"]
    assert want.dtype == np.float32 and np.isfinite(want).all()
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["bm4d_kernel"], want)


def test_bm4d_sharded_matches_jax(run):
    vol = run["data"]["bm4d_vol"]
    sigma, search = BM4D["sigma"], BM4D["search"]
    halo = jpar.bm4d_halo(search=search)
    ext = np.pad(vol, ((halo, halo), (0, 0), (0, 0)), mode="reflect")
    wants = [np.asarray(jax_bm4d(ext, sigma, search=search))[halo:-halo],
             np.asarray(jpar.bm4d_sharded(vol, sigma, _mesh(WORLD),
                                          search=search))]
    got = run["ranks"][1]["bm4d_dense"]
    for want in wants:
        rmse = float(np.sqrt(np.mean((got - want) ** 2)))
        assert rmse <= 5e-2 * sigma, rmse
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["bm4d_dense"], got)


@pytest.mark.parametrize("z,n,p,ov,shape", [
    (54, 3, 16, 4, (54, 20, 18)), (54, 3, 16, 10, (54, 20, 18)),
    (64, 4, 16, 4, (64, 36, 33)), (256, 4, 64, 12, (256, 64, 64)),
    (256, 4, 64, 36, (256, 64, 64)), (288, 3, 96, 12, (288, 96, 96)),
])
def test_shard_plans_match_jax(z, n, p, ov, shape):
    _, jglob, n_max = jpar.plan_shards(z, n, p, ov, shape)
    stride = p - ov
    for s, (loc, glob) in enumerate(_shard_starts(z, n, p, ov, shape)):
        k = len(glob)
        assert 0 < k <= n_max
        np.testing.assert_array_equal(glob, jglob[s, :k])
        # JAX pads a shard's list to n_max by repeating its last start.
        assert (jglob[s, k:] == jglob[s, k - 1]).all()
        np.testing.assert_array_equal(loc[:, 0], glob[:, 0] - (s * z // n
                                                               - p))
        if p <= 2 * stride:
            k0, k1 = _canvas_rows(z, n, p, ov)[s]
            rows = np.unique(glob[:, 0]) // stride
            assert list(rows) == list(range(k0, k1 + 1))


def test_dp_step_over_three_ranks_matches_single_step(run):
    r0 = run["ranks"][0]
    for r in run["ranks"]:
        assert int(r["dp_share"]) == 2
        np.testing.assert_array_equal(r["dp_params"], r0["dp_params"])
        np.testing.assert_array_equal(r["dp_grads"], r0["dp_grads"])
        assert r["dp_loss"] == r0["dp_loss"]
    loss_rel = abs(float(r0["dp_loss"]) - float(r0["single_loss"])) / abs(
        float(r0["single_loss"]))
    g, g1 = r0["dp_grads"], r0["single_grads"]
    grad_rel = float(np.linalg.norm(g - g1) / np.linalg.norm(g1))
    d = np.abs(r0["dp_params"] - r0["single_params"])
    assert loss_rel <= DP_LOSS_RTOL, loss_rel
    assert grad_rel <= DP_GRAD_REL_L2, grad_rel
    assert d.max() <= DP_PARAM_ATOL, d.max()
    assert np.mean(d > 1e-6) <= DP_FLIP_SHARE


def test_dp_step_over_three_ranks_matches_jax(run):
    r0, d = run["ranks"][0], run["data"]
    jm = JaxUNet(**KW)

    def loss_fn(p):
        return jax_loss(jm.apply({"params": p}, d["dp_x"]), d["dp_y"],
                        d["dp_fg"], fg_weight=DP["fg_weight"])

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(run["params"])
    np.testing.assert_allclose(r0["dp_loss"], float(want_loss), rtol=1e-5)
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train.checkpoint import params_from_flax

    want = params_from_flax(jax.tree.map(np.asarray, want_g))
    off = 0
    for name, p in UNet(**KW).named_parameters():
        got = r0["dp_grads"][off:off + p.numel()]
        off += p.numel()
        w = np.asarray(want[name]).reshape(-1)
        err = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 5e-3, (name, err)
    assert off == r0["dp_grads"].size
