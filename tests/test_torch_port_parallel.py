"""The port's multi-GPU layer against exaspim_tpu.parallel, on the CPU.

Two gloo ranks, started with the ``spawn`` method, run the port's sharded
paths (``tests/_torch_port_parallel_worker.py``) on the same numpy-seeded
inputs and a JAX-written width-0.25 UNet checkpoint; the JAX side runs on
the conftest's virtual CPU mesh, 2 devices. Held:

* ``predict_sharded`` bit-equal to one port ``predict`` in both stitch
  branches (the parity canvas, ``patch ≤ 2·stride``; the patch-by-patch
  stitch otherwise), uint16 and float, on a z extent where the last
  core's canvas rows run past the global grid. The float result against
  the JAX package within ``test_torch_port_inference.py``'s
  cross-package tolerance (1e-3 relative; the uint16 output is the port's
  own ``predict``'s, held there against JAX's): on the canvas branch JAX's
  single-device ``predict``, and JAX's ``predict_sharded`` on the planes
  its extra rows do not reach (it weights the last core's rows past the
  global grid; the port zeroes them). On the scatter branch JAX pads
  each shard's patch list to an equal count by repeating its last patch,
  which weights that patch twice where it overlaps others; the port
  evaluates each patch once, so it is held to JAX's single-device oracle
  of the same geometry (JAX's ``tiled_accumulate`` over the whole volume
  without repeats);
* ``denoise_volume(mesh=)`` bit-equal to the unsharded stream;
* ``bm4d_sharded`` bit-equal to the port's ``bm4d`` of the
  z-reflect-extended volume cropped back, and with the f32 dense matcher
  within the cross-package two-stage teacher bound (RMSE ≤ 5e-2·σ,
  ``test_torch_port_bm4d.py``) of JAX's ``bm4d_sharded``;
* one data-parallel step (2 ranks × 2 against one step of 4): the loss
  against the port's single step (1e-6 relative) and JAX's
  ``make_dp_train_step`` (1e-5, ``test_torch_port_train_step.py``'s),
  the all-reduced gradient against ``jax.grad`` of the global batch loss
  (relative L2 ≤ 5e-3 per parameter: that test's bound is 2e-3 on its
  batch of 2, where a LeakyReLU input within f32 rounding of zero moves
  upstream gradients by up to 6e-4; on this batch of 4 one GroupNorm
  bias reads 2.1e-3. A gradient that misses the all-reduce, or sums where
  it should average, is off by O(1));
  parameters equal across the ranks, within 1e-5 of the single step (an
  all-reduced mean of two halves' gradients against one mean: Adam's
  first update ``lr·g/(|g| + ε)`` moves by up to ``lr`` where ``|g|`` is
  near ``ε = 1e-8``, so a gradient rounded otherwise there shifts it; one
  element of 810,033 measured 1.4e-6; the bound is 1 % of ``lr``). The
  parameters are not held to JAX's after the update: where a gradient
  element is near zero the two frameworks' f32 gradients take opposite
  signs and Adam's first step, about ``lr·sign(g)``, moves them ``2·lr``
  apart (34 of 810,033 elements measured);
* ``Trainer(mesh=)`` one step and one validation: the logged loss and
  every validation metric within 1e-3 relative of JAX's mesh Trainer
  (``test_torch_port_trainer.py``), parameters equal across ranks, only
  rank 0 writing, ``device_cache=True`` refused;
* the mesh helpers, ``initialize_multihost`` (a solo call with nothing
  configured is a no-op that returns False; a second call is ignored),
  ``is_primary``.
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import exaspim_tpu.inference as ji
from exaspim_tpu import parallel as jpar
from exaspim_tpu.data.cache import CachedPatchDataset as JCached
from exaspim_tpu.data.cache import CachedValidateDataset as JVal
from exaspim_tpu.data.synthetic import make_synthetic_cache
from exaspim_tpu.losses import signal_preserving_loss as jax_loss
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.train import Trainer as JaxTrainer
from exaspim_tpu.train import create_train_state as jax_state
from exaspim_tpu.train.checkpoint import save_checkpoint as jax_save
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch import parallel as par

import _torch_port_parallel_worker as worker

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
KW = dict(width_multiplier=0.25, head_init="normal")
PREDICT = {
    "canvas": dict(patch_size=16, overlap=4, trim=2, batch_size=4),
    "scatter": dict(patch_size=16, overlap=10, trim=2, batch_size=4),
}
BM4D = dict(sigma=25.0, search=5)
DP = dict(lr=1e-3, total_steps=10, fg_weight=5.0)
WEIGHTS = {"fg_mae": 1.0, "bg_mae": 0.2, "top_pct_error": 0.5,
           "cratio": 10.0}
RUN = dict(epochs=1, batch_size=4, val_every=1, exact_cratio_examples=2,
           checkpoint_weights=WEIGHTS, seed=42)
WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The job's inputs, then the two ranks' results (``rank0``, ``rank1``)."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    jm = JaxUNet(**KW)
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, 16, 16, 16, 1)))["params"]
    ckpt = jax_save(str(root / "init.ckpt"), params, jm.config, TCFG)
    # As in test_torch_port_inference.py: a small residual keeps predictions
    # near the input's counts, where the asinh inverse does not amplify f32
    # rounding into counts.
    small = {**params, "Conv_0": {
        "kernel": params["Conv_0"]["kernel"] * 0.02,
        "bias": params["Conv_0"]["bias"]}}
    predict_ckpt = jax_save(str(root / "predict.ckpt"), small, jm.config,
                            TCFG)
    # Targets 5 away from the input (test_torch_port_train_step.py): the
    # Charbonnier derivative sits at ±1, away from its knee.
    x = rng.normal(0.0, 1.0, (4, 16, 16, 16, 1)).astype(np.float32)
    data = {
        # z = 40 over 2 ranks at patch 16, stride 12: the last core's
        # canvas rows run past the global grid's last row (24) to 36.
        "img": rng.poisson(300.0, (40, 20, 18)).astype(np.uint16),
        "bm4d_vol": rng.normal(300.0, 25.0, (48, 16, 16)).astype(np.float32),
        "dp_x": x,
        "dp_y": (x + 5.0 * rng.choice([-1.0, 1.0], x.shape)).astype(
            np.float32),
        "dp_fg": rng.random(x.shape) < 0.2,
    }
    train = make_synthetic_cache(str(root / "train"), 4, (16, 16, 16), TCFG,
                                 seed=1)
    val = make_synthetic_cache(str(root / "val"), 2, (16, 16, 16), TCFG,
                               seed=2)
    job = {"ckpt": ckpt, "predict_ckpt": predict_ckpt, "tcfg": TCFG, "predict": PREDICT, "bm4d": BM4D,
           "dp": DP, "trainer": {"tcfg": TCFG, "run": RUN, "train": train,
                                 "val": val}}
    np.savez(root / "job.npz", **data)
    with open(root / "job.json", "w") as f:
        json.dump(job, f)
    mp.start_processes(worker.run, args=(WORLD, _free_port(), str(root)),
                       nprocs=WORLD, start_method="spawn")
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    return {"root": root, "data": data, "params": params, "ckpt": ckpt,
            "predict_params": small,
            "train": train, "val": val, "ranks": ranks}


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("z",))


@pytest.mark.parametrize("branch", sorted(PREDICT))
@pytest.mark.parametrize("kind", ["u16", "float"])
def test_predict_sharded_bit_equal_to_predict(run, branch, kind):
    r0, r1 = run["ranks"]
    want = r0[f"single_{branch}_{kind}"]
    for r in (r0, r1):
        got = r[f"sharded_{branch}_{kind}"]
        assert got.dtype == want.dtype and got.shape == run["data"][
            "img"].shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("branch", sorted(PREDICT))
def test_predict_sharded_matches_jax(run, branch):
    img, kw = run["data"]["img"], PREDICT[branch]
    jm, t, p = JaxUNet(**KW), jax_transform(TCFG), run["predict_params"]
    got = run["ranks"][0][f"sharded_{branch}_float"]
    if branch == "canvas":
        wants = [(ji.predict(img, jm, p, t, return_float=True, **kw),
                  img.shape[0])]
        # JAX's sharded canvas also adds the last core's rows past the
        # global grid (start 36 > 24), which reach planes 38-39 with
        # weight; held on the planes before them.
        wants.append((jpar.predict_sharded(img, jm, p, t, _mesh(2),
                                           return_float=True, **kw), 38))
    else:
        wants = [(_jax_scatter_oracle(img, jm, p, t, **kw),
                  img.shape[0])]
    for want, z in wants:
        np.testing.assert_allclose(got[:z], np.asarray(want)[:z],
                                   rtol=1e-3, atol=1e-3)


def _jax_scatter_oracle(img, model, params, t, patch_size, overlap, trim,
                        batch_size):
    """JAX's ``tiled_accumulate`` over the whole volume, every patch once:
    batches of 1 (not ``batch_size``), so no patch repeats to fill one."""
    starts = ji.generate_patch_starts(img.shape, patch_size, overlap)
    top = starts.max(axis=0) + patch_size
    x = t.forward(jnp.asarray(img, jnp.float32))
    x = jnp.pad(x, [(0, max(int(e) - d, 0)) for e, d in
                    zip(top, img.shape)])
    accum, wgt = ji.tiled_accumulate(
        ji._model_apply(model), params, x, jnp.asarray(starts),
        jnp.asarray(starts), img.shape, patch_size, 1, trim)
    out = (accum / (wgt + 1e-8))[:img.shape[0], :img.shape[1],
                                 :img.shape[2]]
    return t.inverse_float(out)


def test_denoise_volume_on_the_mesh(run):
    r0, r1 = run["ranks"]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["pipeline_mesh"],
                                      r0["pipeline_single"])


def test_bm4d_sharded_equals_reflect_extended_bm4d(run):
    r0, r1 = run["ranks"]
    assert r0["bm4d_kernel"].dtype == np.float32
    for r in (r0, r1):
        np.testing.assert_array_equal(r["bm4d_kernel"], r0["bm4d_oracle"])


def test_bm4d_sharded_matches_jax(run):
    vol = run["data"]["bm4d_vol"]
    want = np.asarray(jpar.bm4d_sharded(vol, BM4D["sigma"], _mesh(2),
                                        search=BM4D["search"]))
    got = run["ranks"][0]["bm4d_dense"]
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse <= 5e-2 * BM4D["sigma"], rmse
    np.testing.assert_array_equal(run["ranks"][1]["bm4d_dense"], got)


def test_dp_step_matches_single_step_and_jax(run):
    r0, r1 = run["ranks"]
    np.testing.assert_array_equal(r0["dp_params"], r1["dp_params"])
    assert r0["dp_loss"] == r1["dp_loss"]
    np.testing.assert_allclose(r0["dp_loss"], r0["single_loss"], rtol=1e-6)
    np.testing.assert_allclose(r0["dp_params"], r0["single_params"],
                               rtol=0, atol=1e-5)
    d = run["data"]
    jm = JaxUNet(**KW)
    state = jax_state(jm, patch_shape=(16, 16, 16), lr=DP["lr"],
                      total_steps=DP["total_steps"], params=run["params"])
    mesh = jpar.make_mesh(2, axis="data")
    step = jpar.make_dp_train_step(mesh, fg_weight=DP["fg_weight"])
    state, loss = step(state, *jpar.shard_batch(
        mesh, (d["dp_x"], d["dp_y"], d["dp_fg"])))
    np.testing.assert_allclose(r0["dp_loss"], float(loss), rtol=1e-5)

    def loss_fn(p):
        return jax_loss(jm.apply({"params": p}, d["dp_x"]), d["dp_y"],
                        d["dp_fg"], fg_weight=DP["fg_weight"])

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(run["params"])
    np.testing.assert_allclose(r0["dp_loss"], float(want_loss), rtol=1e-5)
    from exaspim_tpu_torch.train.checkpoint import params_from_flax

    want = params_from_flax(jax.tree.map(np.asarray, want_g))
    off = 0
    for name, p in _port_named_params():
        got = r0["dp_grads"][off:off + p.numel()]
        off += p.numel()
        w = np.asarray(want[name]).reshape(-1)
        err = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 5e-3, (name, err)
    np.testing.assert_array_equal(r0["dp_grads"], r1["dp_grads"])


def _port_named_params():
    from exaspim_tpu_torch.models import UNet

    return list(UNet(**KW).named_parameters())


def _events(session):
    with open(os.path.join(str(session), "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_on_the_mesh_matches_jax(run):
    r0, r1 = run["ranks"]
    assert int(r0["trainer_step"]) == int(r1["trainer_step"]) == 1
    np.testing.assert_array_equal(r0["trainer_params"], r1["trainer_params"])
    assert bool(r0["trainer_primary"]) and not bool(r1["trainer_primary"])
    assert bool(r0["forced_cache_raises"]) and bool(r1["forced_cache_raises"])
    jt = JaxTrainer(str(run["root"] / "jax"), JaxUNet(**KW),
                    jax_transform(TCFG), tensorboard=False, keep_mips=0,
                    mesh=jpar.make_mesh(2, axis="data"), **RUN)
    jt.load_pretrained_weights(run["ckpt"])
    jt.run(JCached(run["train"]), JVal(run["val"]))
    je = _events(jt.session_dir)
    te = _events(r0["trainer_session"])
    jtrain = [e for e in je if e["event"] == "train"]
    ttrain = [e for e in te if e["event"] == "train"]
    assert [e["step"] for e in ttrain] == [e["step"] for e in jtrain] == [1]
    np.testing.assert_allclose(ttrain[0]["loss"], jtrain[0]["loss"],
                               rtol=1e-3)
    jval = [e for e in je if e["event"] == "val"]
    tval = [e for e in te if e["event"] == "val"]
    assert [e["step"] for e in tval] == [e["step"] for e in jval] == [1]
    for k in jval[0]:
        if k in ("event", "step"):
            continue
        tol = 0.02 if k == "val_cratio" else 1e-3 * abs(jval[0][k])
        assert abs(tval[0][k] - jval[0][k]) <= tol, (k, tval[0][k],
                                                      jval[0][k])


def test_mesh_helpers_and_multihost(run, monkeypatch):
    r0, r1 = run["ranks"]
    assert bool(r0["is_primary"]) and not bool(r1["is_primary"])
    assert bool(r0["mesh_too_large_raises"])
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert par.initialize_multihost(device="cpu") is False
    assert par.is_primary()
    from torch.distributed.tensor import Replicate, Shard

    class OneAxis:  # the two helpers read only the mesh's axis names
        mesh_dim_names, ndim = ("z",), 1

    assert par.replicated(OneAxis()) == (Replicate(),)
    assert par.sharded_along(OneAxis(), "z", dim=1, ndim=3) == (Shard(1),)
    with pytest.raises(ValueError):
        par.sharded_along(OneAxis(), "data")


def test_plan_shards_matches_jax():
    for args in ((64, 4, 16, 4, (64, 36, 33)), (32, 2, 16, 10, (32, 20, 18))):
        for got, want in zip(par.plan_shards(*args),
                             jpar.plan_shards(*args)):
            np.testing.assert_array_equal(got, want)
    from exaspim_tpu_torch.parallel.spatial import _canvas_rows

    # Each shard's canvas rows are the global grid's rows that touch its
    # core, and no other.
    for z, n, p, ov in ((64, 4, 16, 4), (40, 2, 16, 4), (256, 2, 96, 12)):
        rows = ji.generate_patch_starts((z, p, p), p, ov)[:, 0] // (p - ov)
        core = z // n
        for s, (k0, k1) in enumerate(_canvas_rows(z, n, p, ov)):
            touch = [k for k in rows if k * (p - ov) + p > s * core
                     and k * (p - ov) < (s + 1) * core]
            assert list(range(k0, k1 + 1)) == touch
    with pytest.raises(ValueError):
        par.plan_shards(63, 4, 16, 4, (63, 36, 33))
    assert par.bm4d_halo() == jpar.bm4d_halo() == 30
    assert par.bm4d_halo(search=5) == jpar.bm4d_halo(search=5)


def test_train_data_parallel_under_torchrun_env(run, monkeypatch):
    """``train(data_parallel=True)`` joins the group that torchrun's
    environment describes (world size 1; gloo, as ``device="cpu"`` asks)
    and trains over a mesh: its losses equal the streamed run's without
    one, bit for bit (a one-rank mean is the gradient itself)."""
    import torch.distributed as dist

    from exaspim_tpu_torch.train.train_bm4dnet import train

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(epochs=1, batch_size=2, exact_cratio_examples=0, log_every=1,
              bf16=False, resume=run["ckpt"], device="cpu")
    try:
        dp = train([run["train"]], [run["val"]], str(run["root"] / "dp"),
                   data_parallel=True, **kw)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert dp.mesh is not None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    plain = train([run["train"]], [run["val"]], str(run["root"] / "plain"),
                  device_cache=False, **kw)
    losses = [[e["loss"] for e in _events(t.session_dir)
               if e["event"] == "train"] for t in (dp, plain)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
