"""The port's evaluators and evaluation script against exaspim_tpu's.

Width-0.25 UNet checkpoints saved by the JAX package are evaluated by both
packages in f32 on the same blocks. With the zero-initialised head of
``create_train_state`` (the identity denoiser of ``tests/test_evaluate.py``)
both packages produce the same uint16 volumes, so every compression ratio
is equal. With a non-zero head the denoised volumes agree within ±1 count
(f32 convs summed in another order), so their ratios may differ in the
last of the two printed decimals (≤ 0.011 on 24³ blocks). SSIM within 2e-5
(rounded to 5 digits), MAE within 0.01 counts and L∞ within 1 count against
the BM4D ground truth, whose two implementations agree within 1 count on
≤ 1e-3 of voxels (its ratio within 0.011). Columns and their order are
equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaspim_tpu.evaluate as je
import exaspim_tpu_torch.evaluate as te
from exaspim_tpu.data.synthetic import neurite_phantom, noisy_observation
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.train import checkpoint as jckpt
from exaspim_tpu.utils import img_io as jio

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 50.0}}
TILING = dict(patch_size=16, overlap=4, trim=2, batch_size=4)


def _save(tmp_path_factory, head_init, scale):
    model = JaxUNet(width_multiplier=0.25, head_init=head_init)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 16, 16, 16, 1)))["params"]
    params = {**params, "Conv_0": {
        "kernel": params["Conv_0"]["kernel"] * scale,
        "bias": params["Conv_0"]["bias"],
    }}
    d = tmp_path_factory.mktemp("ckpt")
    path = os.path.join(d, jckpt.checkpoint_filename(3, -1.0))
    jckpt.save_checkpoint(path, params, model.config, TCFG, step=3)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX checkpoint as ``create_train_state`` makes it: zero head."""
    return _save(tmp_path_factory, "zeros", 1.0)


@pytest.fixture(scope="module")
def ckpt_residual(tmp_path_factory):
    """A JAX checkpoint with a small non-zero residual head."""
    return _save(tmp_path_factory, "normal", 0.02)


@pytest.fixture()
def jax_f32(monkeypatch):
    """The JAX evaluators restore in bf16 by default; compare in f32."""
    restore = jckpt.restore_pipeline
    monkeypatch.setattr(je, "restore_pipeline",
                        lambda path: restore(path, dtype=jnp.float32))


def _block(seed, shape=(24, 24, 24)):
    clean, _ = neurite_phantom(shape, seed=seed)
    return noisy_observation(clean, seed=seed + 100)


def test_supervised_evaluator_matches_jax(tmp_path, ckpt, jax_f32):
    blocks = {"b0": _block(0), "b1": _block(1)}
    want = je.SupervisedEvaluator(
        blocks, os.path.join(tmp_path, "jax"), **TILING).run(ckpt)
    ev = te.SupervisedEvaluator(
        blocks, os.path.join(tmp_path, "torch"), dtype=torch.float32,
        device="cpu", **TILING)
    got = ev.run(ckpt)
    assert list(got.columns) == list(want.columns)
    assert list(got["block_id"]) == list(want["block_id"]) == ["b0", "b1"]
    for col in ("cratio_noisy", "cratio", "cratio_gain"):
        np.testing.assert_array_equal(got[col], want[col])
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=2e-5)
    for name in ("results.csv", "b0_noisy_mips.png", "b1_denoised_mips.png"):
        assert os.path.exists(os.path.join(tmp_path, "torch", name))
    with open(os.path.join(tmp_path, "torch", "results.csv")) as f:
        header = f.readline().strip()
    with open(os.path.join(tmp_path, "jax", "results.csv")) as f:
        assert header == f.readline().strip()


def test_supervised_evaluator_offset_and_no_mips(tmp_path, ckpt_residual,
                                                 jax_f32):
    ckpt = ckpt_residual
    blocks = [("b2", _block(2))]
    want = je.SupervisedEvaluator(
        blocks, os.path.join(tmp_path, "jax"), save_mips=False,
        **TILING).run(ckpt, offset=20.0)
    got = te.SupervisedEvaluator(
        blocks, os.path.join(tmp_path, "torch"), save_mips=False,
        dtype=torch.float32, device="cpu", **TILING).run(ckpt, offset=20.0)
    np.testing.assert_array_equal(got["cratio_noisy"], want["cratio_noisy"])
    assert (got["ssim"] < 1.0).all()  # this head does change the block
    np.testing.assert_allclose(got["cratio"], want["cratio"], atol=0.011)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=2e-5)
    assert os.listdir(os.path.join(tmp_path, "torch")) == ["results.csv"]


def test_unsupervised_evaluator_matches_jax(tmp_path, ckpt, jax_f32,
                                            monkeypatch):
    """On the CPU the JAX package's ``matcher="auto"`` is its dense XLA
    matcher (f32 distances), while the port's default is the plain version
    of its kernels (a bf16 table, as the Pallas kernel keeps): other
    near-ties, other groups. Like is compared with like: the port's BM4D
    runs ``matcher="dense"`` here (kernel against Pallas:
    ``tests/test_torch_port_bm4d.py``)."""
    import functools
    import importlib

    # The module: ``exaspim_tpu_torch.ops.bm4d`` is the function, as in the
    # JAX package, since ``ops`` re-exports it.
    tbm4d = importlib.import_module("exaspim_tpu_torch.ops.bm4d")

    monkeypatch.setattr(tbm4d, "bm4d",
                        functools.partial(tbm4d.bm4d, matcher="dense"))
    vol = _block(2, (32, 32, 32))

    def read_patch(brain_id, voxel):
        z, y, x = voxel
        if z < 0:
            return None
        return vol[z:z + 16, y:y + 16, x:x + 16]

    lists = {("val", "foreground", "b2"): [(0, 0, 0), (-1, 0, 0), (8, 8, 8)]}
    jev = je.UnsupervisedEvaluator(read_patch, os.path.join(tmp_path, "jax"),
                                   sigma_gt=20.0)
    jev.ingest_model(ckpt)
    want = jev.run(lists, offsets={"b2": 0})[("val", "foreground", "b2")]
    tev = te.UnsupervisedEvaluator(
        read_patch, os.path.join(tmp_path, "torch"), sigma_gt=20.0,
        dtype=torch.float32, device="cpu")
    tev.ingest_model(ckpt)
    got = tev.run(lists, offsets={"b2": 0})[("val", "foreground", "b2")]
    assert len(got) == len(want) == 2  # the None patch is skipped
    assert list(got.columns) == list(want.columns)
    assert list(got["voxel"]) == list(want["voxel"])
    for col in ("cratio_noise", "cratio"):
        np.testing.assert_array_equal(got[col], want[col])
    np.testing.assert_allclose(got["cratio_gt"], want["cratio_gt"],
                               atol=0.011)
    for col in ("ssim_noise", "ssim_gt"):
        np.testing.assert_allclose(got[col], want[col], atol=2e-5)
    np.testing.assert_allclose(got["l1_gt"], want["l1_gt"], atol=0.01)
    np.testing.assert_allclose(got["lmax_gt"], want["lmax_gt"], atol=1.0)
    assert os.path.exists(
        os.path.join(tmp_path, "torch", "val_foreground_b2.csv"))


def test_read_brain_ids_and_voxels(tmp_path):
    with open(os.path.join(tmp_path, "test_brain_ids.json"), "w") as f:
        json.dump(["653158", "653980"], f)
    with open(os.path.join(tmp_path, "foreground-653158.csv"), "w") as f:
        f.write('voxels\n"(1, 2, 3)"\n"(40, 50, 60)"\n')
    assert te.read_brain_ids(tmp_path) == je.read_brain_ids(tmp_path)
    assert te.read_voxels(tmp_path, "653158") == \
        je.read_voxels(tmp_path, "653158") == [(1, 2, 3), (40, 50, 60)]
    assert te.read_voxels(tmp_path, "653158", is_foreground=False) == []


def _load_script():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "evaluate_bm4dnet_script",
        os.path.join(root, "scripts", "evaluate_bm4dnet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("streaming_slab", [None, 16])
def test_evaluate_script_matches_jax(tmp_path, ckpt_residual, monkeypatch,
                                     streaming_slab):
    """``evaluate`` on a small local OME-Zarr: a crop by Neuroglancer
    coordinates, a given offset, the output written as OME-Zarr with the
    crop's translation, against the script's ``results.json``."""
    from exaspim_tpu_torch import evaluate_bm4dnet as tscript

    ckpt = ckpt_residual
    script = _load_script()
    restore = jckpt.restore_pipeline
    monkeypatch.setattr(script, "restore_pipeline",
                        lambda path: restore(path, dtype=jnp.float32))
    vol = _block(3, (40, 36, 32))
    store = os.path.join(tmp_path, "tile.ome.zarr")
    jio.write_ome_zarr(vol, store, chunks=(1, 1, 16, 16, 16),
                       translation=(0, 0, 1000.0, 748.0, 0.0))
    kw = dict(neuroglancer_xyz=(16.0, 19.0, 21.0), crop_shape=(32, 24, 24),
              offset=12.0, streaming_slab=streaming_slab, **TILING)
    want = script.evaluate(ckpt, f"{store}/0", os.path.join(tmp_path, "jax"),
                           write_output=os.path.join(tmp_path, "jax.zarr"),
                           **kw)
    got = tscript.evaluate(
        ckpt, f"{store}/0", os.path.join(tmp_path, "torch"),
        write_output=os.path.join(tmp_path, "torch.zarr"),
        dtype=torch.float32, device="cpu", **kw)
    with open(os.path.join(tmp_path, "torch", "results.json")) as f:
        saved = json.load(f)
    with open(os.path.join(tmp_path, "jax", "results.json")) as f:
        jsaved = json.load(f)
    assert list(saved) == list(jsaved)
    for key in ("checkpoint", "img", "crop_center", "crop_shape", "offset",
                "cratio_raw"):
        assert saved[key] == jsaved[key], key
    assert abs(saved["cratio_denoised"] - jsaved["cratio_denoised"]) <= 0.011
    assert abs(saved["cratio_gain"] - jsaved["cratio_gain"]) <= 0.006
    assert got["output"].endswith("torch.zarr") and want["output"]
    den = np.asarray(jio.read(got["output"], "0"))[0, 0].astype(np.int64)
    jden = np.asarray(jio.read(want["output"], "0"))[0, 0].astype(np.int64)
    assert den.shape == (32, 24, 24) and np.abs(den - jden).max() <= 1
    assert jio.get_ome_zarr_level_transform(f"{got['output']}/0") == \
        jio.get_ome_zarr_level_transform(f"{want['output']}/0")
    for name in ("raw_mips.png", "denoised_mips.png"):
        assert os.path.exists(os.path.join(tmp_path, "torch", name))


def test_evaluate_script_ranks_a_checkpoint_directory(tmp_path, ckpt):
    """A directory is ranked by score; without OME metadata the whole
    volume is taken and the offset comes from its low percentile."""
    import shutil

    from exaspim_tpu_torch import evaluate_bm4dnet as tscript
    from exaspim_tpu_torch.utils import img_io as tio

    runs = os.path.join(tmp_path, "runs")
    os.makedirs(runs)
    best = shutil.copy(ckpt, os.path.join(
        runs, jckpt.checkpoint_filename(9, -2.0)))
    shutil.copy(ckpt, os.path.join(runs, jckpt.checkpoint_filename(5, 0.5)))
    vol = _block(4, (20, 20, 24))
    path = os.path.join(tmp_path, "plain.zarr")
    tio.write_zarr(vol, path, chunks=(1, 1, 16, 16, 16))
    res = tscript.evaluate(
        runs, path, os.path.join(tmp_path, "out"), dtype=torch.float32,
        device="cpu", **TILING)
    assert res["checkpoint"] == best and res["offset"] is None
    assert res["crop_center"] is None and res["cratio_raw"] > 1.0
    assert "output" not in res
