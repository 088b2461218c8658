"""The port's tiled inference against exaspim_tpu.inference, plus the
port's import boundary.

Tolerances: the tiling plans, masks and the parity stitch are equal;
end-to-end ``predict`` (f32, same params) agrees within ±1 count for
uint16 output and 1e-3 relative for float output.
"""

import ast
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaspim_tpu.inference as ji
import exaspim_tpu_torch.inference as ti
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.train.checkpoint import params_from_flax
from exaspim_tpu_torch.transforms import build_transform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


@pytest.mark.parametrize("shape,patch,overlap", [
    ((40, 48, 56), 32, 12), ((256, 256, 256), 96, 12), ((64, 70, 100), 64, 12),
])
def test_tiling_plan_matches_jax(shape, patch, overlap):
    np.testing.assert_array_equal(
        ti.generate_patch_starts(shape, patch, overlap),
        ji.generate_patch_starts(shape, patch, overlap))
    assert ti.plan_tiling(shape, overlap) == ji.plan_tiling(shape, overlap)
    assert ti.plan_stream_cores(shape, patch, overlap, 50 ** 3) == \
        ji.plan_stream_cores(shape, patch, overlap, 50 ** 3)


def test_plan_tiling_bench_block():
    assert ti.plan_tiling((256, 256, 256), 12) == (96, 9)
    assert ti.count_patches((256, 256, 256), 96, 12) == 27


@pytest.mark.parametrize("start", [(0, 0, 0), (20, 20, 40), (0, 20, 24)])
def test_trim_mask_matches_jax(start):
    got = ti.trim_weight_mask(start, 32, 5, (40, 48, 56), device="cpu")
    want = ji.trim_weight_mask(jnp.asarray(start), 32, 5, (40, 48, 56))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_parity_canvas_matches_jax():
    rng = np.random.default_rng(0)
    grid, stride, P, vol = (2, 2, 3), 20, 32, (52, 52, 72)
    blocks = rng.normal(size=(12, P, P, P)).astype(np.float32)
    got = ti._parity_canvas(torch.from_numpy(blocks), grid, stride, P, vol)
    want = ji._parity_canvas(jnp.asarray(blocks), grid, stride, P, vol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def models():
    kw = dict(width_multiplier=0.25, head_init="normal")
    jm = JaxUNet(**kw)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 32, 1)))[
        "params"]
    # A small but non-zero residual keeps outputs near the input's counts,
    # where the asinh inverse does not amplify f32 rounding into counts.
    params = {**params, "Conv_0": {
        "kernel": params["Conv_0"]["kernel"] * 0.02,
        "bias": params["Conv_0"]["bias"],
    }}
    tm = UNet(**kw)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("kind", ["uint16", "float32"])
def test_predict_matches_jax(models, kind):
    jm, params, tm = models
    rng = np.random.default_rng(1)
    img = rng.poisson(300.0, (40, 48, 56)).astype(np.float64)
    img = img.astype(np.uint16) if kind == "uint16" else (
        img + rng.uniform(0, 1, img.shape)).astype(np.float32)
    kw = dict(patch_size=32, overlap=12, trim=5, batch_size=5)
    want = ji.predict(img, jm, params, jax_transform(TCFG), **kw)
    got = ti.predict(img, tm, build_transform(TCFG), device="cpu", **kw)
    assert got.dtype == np.uint16 and got.shape == img.shape
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
    wantf = ji.predict(img, jm, params, jax_transform(TCFG),
                       return_float=True, **kw)
    gotf = ti.predict(img, tm, build_transform(TCFG), return_float=True,
                      device="cpu", **kw)
    np.testing.assert_allclose(gotf, np.asarray(wantf), rtol=1e-3, atol=1e-3)


def test_streaming_equals_single_pass(models):
    _, _, tm = models
    img = np.random.default_rng(2).poisson(300.0, (40, 48, 56)).astype(
        np.uint16)
    kw = dict(patch_size=32, overlap=12, trim=5, batch_size=4, device="cpu")
    one = ti.predict(img, tm, build_transform(TCFG), **kw)
    streamed = ti.predict(img, tm, build_transform(TCFG),
                          max_device_voxels=40 * 48 * 40, **kw)
    np.testing.assert_array_equal(streamed, one)


def test_entry_points_default_to_the_card():
    for fn in (ti.predict, ti.predict_patch, ti.trim_weight_mask):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    from exaspim_tpu_torch.models import build_model
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    for fn in (build_model, restore_pipeline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _port_files():
    pkg = os.path.join(ROOT, "exaspim_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax():
    banned = ("jax", "flax", "exaspim_tpu")
    files = list(_port_files())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in banned, f"{path} imports {m}"
