"""The port's QA modules against ``scripts/visualize_patches.py`` and
``scripts/visualize_swc_masks.py``, on the CPU.

The same JAX-written cache and the same seeded points go through both:
the picked indices and examples are equal, the skeleton masks of the
panels are the JAX package's, and each module's ``main`` writes its PNG.
Without matplotlib the modules still import and ``render`` raises an
``ImportError`` that names it.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from exaspim_tpu.data.synthetic import make_synthetic_cache
from exaspim_tpu.ops.metrics import make_skeleton_mask as jax_mask
from exaspim_tpu_torch import visualize_patches as vp
from exaspim_tpu_torch import visualize_swc_masks as vs
from exaspim_tpu_torch.data.cache import CachedPatchDataset
from exaspim_tpu_torch.ops.metrics import make_skeleton_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis")
    return make_synthetic_cache(str(root / "c"), 12, (16, 16, 16), TCFG,
                                seed=3)


@pytest.mark.parametrize("n,seed", [(4, 0), (3, 7), (12, 1), (20, 2)])
def test_pick_indices_match_the_script(cache, n, seed):
    script = _script("visualize_patches")
    ds_j = script.CachedPatchDataset(cache)
    ds_t = CachedPatchDataset(cache)
    assert vp.pick_indices(ds_t, n, seed=seed) == script.pick_indices(
        ds_j, n, seed=seed)
    img = np.random.default_rng(seed).random((16, 16)) * 1000
    np.testing.assert_array_equal(vp.stretch(img), script.stretch(img))
    np.testing.assert_array_equal(vp.overlay(vp.stretch(img), img > 500),
                                  script.overlay(script.stretch(img),
                                                 img > 500))


def test_patches_main_writes_the_grid(cache, tmp_path):
    out = str(tmp_path / "grid.png")
    idx = vp.main(["--cache", cache, "--out", out, "--n", "3"])
    assert len(idx) == 3 and os.path.getsize(out) > 0
    from PIL import Image

    assert Image.open(out).size == (9 * 110, 3 * 3 * 110)  # 3 rows, 110 dpi


def _points(seed=0, n=60, shape=(80, 96, 96)):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)[:, None]
    a, b = rng.uniform(0, 1, (2, 3)) * np.asarray(shape)
    return np.round(a + t * (b - a)).astype(int)


@pytest.mark.parametrize("seed,patch", [(0, (32, 32, 32)), (1, (16, 48, 24)),
                                        (2, (64, 64, 64))])
def test_pick_examples_and_masks_match_the_script(seed, patch):
    script = _script("visualize_swc_masks")
    pts, shape = _points(seed), (80, 96, 96)
    try:
        want = script.pick_examples(pts, shape, patch, 4, seed=seed)
    except ValueError:
        with pytest.raises(ValueError, match="no in-bounds"):
            vs.pick_examples(pts, shape, patch, 4, seed=seed)
        return
    got = vs.pick_examples(pts, shape, patch, 4, seed=seed)
    np.testing.assert_array_equal(got, want)
    for c in got:
        start = [int(v) - p // 2 for v, p in zip(c, patch)]
        np.testing.assert_array_equal(make_skeleton_mask(pts, start, patch),
                                      jax_mask(pts, start, patch))


def test_swc_main_writes_the_panels(tmp_path):
    shape = (80, 96, 96)
    pts = _points(4, shape=shape)
    vol = np.random.default_rng(0).poisson(200, shape).astype(np.uint16)
    tif = str(tmp_path / "vol.tif")
    from PIL import Image

    frames = [Image.fromarray(a) for a in vol]
    frames[0].save(tif, save_all=True, append_images=frames[1:])
    from exaspim_tpu_torch.utils.swc import ANISOTROPY

    xyz = pts[:, ::-1] * np.asarray(ANISOTROPY)  # (z, y, x) → physical x, y, z
    swc = tmp_path / "trace.swc"
    swc.write_text("".join(
        f"{i + 1} 2 {x:.3f} {y:.3f} {z:.3f} 1.0 {i if i else -1}\n"
        for i, (x, y, z) in enumerate(xyz)))
    out = str(tmp_path / "masks.png")
    centers = vs.main(["--img", tif, "--swc", str(swc), "--out", out,
                       "--n", "2", "--patch", "32", "32", "32"])
    assert len(centers) == 2 and os.path.getsize(out) > 0


def test_render_without_matplotlib_names_it(monkeypatch, cache, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        vp.render(CachedPatchDataset(cache), [0], str(tmp_path / "a.png"))
    with pytest.raises(ImportError, match="matplotlib"):
        vs.render(np.zeros((8, 8, 8), np.uint16), np.zeros((1, 3)),
                  [(4, 4, 4)], (4, 4, 4), str(tmp_path / "b.png"))
