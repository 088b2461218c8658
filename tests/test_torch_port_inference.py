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
    from exaspim_tpu_torch import ckpt_quality
    from exaspim_tpu_torch.models import build_model
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    for fn in (build_model, restore_pipeline, ckpt_quality.quality_records,
               ckpt_quality.score, ckpt_quality.proxy_ratios):
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


class _Overshoot(torch.nn.Module):
    """Pointwise, and past the input's range at bright voxels; counts map
    to whole counts, so no output sits on a rounding tie."""

    def forward(self, x):
        return x * 2.0 - 0.05


class _JaxOvershoot:
    def apply(self, variables, x):
        return x * 2.0 - 0.05


@pytest.mark.parametrize("clip", [None, "input", (0.1, 0.45)])
@pytest.mark.parametrize("streamed", [False, True])
def test_output_clip_matches_jax(clip, streamed):
    """All three forms of ``output_clip``, direct and streamed (where
    ``"input"`` is taken per super-tile). The model is pointwise and the
    transform linear, so the uint16 outputs are equal."""
    lin = {"kind": "linear", "params": {"mn": 0.0, "mx": 1000.0, "clip": 8.0}}
    img = np.random.default_rng(7).integers(0, 900, (40, 24, 20)).astype(
        np.uint16)
    kw = dict(patch_size=16, overlap=4, trim=2, batch_size=4,
              output_clip=clip)
    if streamed:
        kw["max_device_voxels"] = 20 * 24 * 20
    want = ji.predict(img, _JaxOvershoot(), {}, jax_transform(lin), **kw)
    got = ti.predict(img, _Overshoot(), build_transform(lin), device="cpu",
                     **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    free = ti.predict(img, _Overshoot(), build_transform(lin), device="cpu",
                      **{**kw, "output_clip": None})
    if clip is None:
        np.testing.assert_array_equal(got, free)
    else:
        assert got.max() < free.max()
        hi = img.max() if clip == "input" else 450
        assert got.max() <= hi


def test_output_clip_program_argument():
    t = build_transform(TCFG)
    program, starts = ti.build_tiled_program(
        _Overshoot(), t, (16, 16, 16), 16, 4, 2, 1, output_clip=[0.2, 0.3])
    raw = torch.full((16, 16, 16), 5000.0)
    out = program(raw, starts)
    want = t.inverse(torch.tensor(0.3))
    assert out.dtype == np.uint16 and (out == want).all()


@pytest.mark.parametrize("kind", ["asinh", "linear"])
def test_build_volume_transform_matches_jax(kind):
    cfg = TCFG if kind == "asinh" else {
        "kind": "linear", "params": {"mn": 0.0, "mx": 1000.0}}
    img = np.random.default_rng(8).poisson(150.0, (12, 12, 12)).astype(
        np.uint16)
    for kw in (dict(offset=37.0), dict(img=img), dict(img=img, percentile=5.0)):
        jt_ = ji.build_volume_transform(jax_transform(cfg), **kw)
        tt_ = ti.build_volume_transform(build_transform(cfg), **kw)
        assert tt_.cfg == jt_.cfg
        x = img.astype(np.float32)
        np.testing.assert_allclose(tt_.forward(x).numpy(),
                                   np.asarray(jt_.forward(x)), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="offset or an img"):
        ti.build_volume_transform(build_transform(cfg))


def test_scan_covers_this_slice():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("exaspim_tpu_torch/ops/blocked_conv.py",
                "exaspim_tpu_torch/ops/nb_bench.py",
                "exaspim_tpu_torch/ops/filters.py",
                "exaspim_tpu_torch/utils/img_io.py",
                "exaspim_tpu_torch/utils/plots.py",
                "exaspim_tpu_torch/pipeline.py",
                "exaspim_tpu_torch/pipeline_bench.py",
                "exaspim_tpu_torch/evaluate.py",
                "exaspim_tpu_torch/evaluate_bm4dnet.py", "chip_smoke.py"):
        assert rel in names, rel


@pytest.mark.parametrize("path,what", [
    ("gs://bucket/vol.zarr", "cloud storage"),
    ("s3://bucket/vol.zarr/0", "cloud storage"),
    ("precomputed://vol", "precomputed"),
])
def test_img_io_defers_remote_stores(path, what):
    from exaspim_tpu_torch.utils import img_io

    with pytest.raises(NotImplementedError, match=what):
        img_io.read(path)
    if path.startswith(("gs", "s3")):
        with pytest.raises(NotImplementedError, match=what):
            img_io.write_zarr(np.zeros((2, 2, 2), np.uint16), path)
