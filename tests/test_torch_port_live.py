"""The port's live sampling (``data/live.py``) and ``precompute(source=
"live")`` against the JAX package's, on small synthetic brains.

Two 48³ brains, as a user ingests them: one with a labelled segmentation
(the tube and a salt-and-pepper block the coherence gate must reject) and
a background offset of 37, one with an SWC trace along its tube, read
from a file. The same seed must draw the same brains, voxels, raw patches
and masks in both packages, bit for bit: the generator's draw order, the
submission-order candidate prefetch, the gate's bounded resampling and
the mask hierarchy are host numpy, as in the reference.

The teachers are the one exception (``test_torch_port_precompute.py``):
the port's plain BM4D uses the bf16-table matcher, the JAX package's CPU
route the f32 XLA matcher; among near-ties they pick other, equally good
group members. So teachers are held to that test's bound, RMSE of the
difference ≤ 0.2·σ, and nearer each other than the raw patch.
"""

import importlib.util
import json
import os
import pickle

import numpy as np
import pytest

from exaspim_tpu.data import live as jl
from exaspim_tpu.data.cache import CachedPatchDataset as JCached
from exaspim_tpu_torch.data import live as tl
from exaspim_tpu_torch.data import precompute as tp
from exaspim_tpu_torch.data.cache import CachedPatchDataset
from exaspim_tpu_torch.utils import img_io
from tests.phantoms import salt_pepper_block, tube_phantom

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = (16, 16, 16)
SIGMA = 24.0
ANISO = (0.748, 0.748, 1.0)


def _brains(root):
    """``(specs of arrays, specs of paths)`` for the same two brains."""
    a = tube_phantom((48, 48, 48), noise=20.0, seed=0)
    a[30:42, 30:42, 30:42] = salt_pepper_block(
        (12, 12, 12), block=(12, 12, 12), origin=(0, 0, 0), seed=3)
    a = a.astype(np.uint16)
    seg = np.zeros(a.shape, np.uint32)
    seg[:, 21:27, 21:27] = 4  # the tube
    seg[30:42, 30:42, 30:42] = 9  # the artifact
    b = tube_phantom((48, 48, 48), noise=25.0, seed=5).astype(np.uint16)
    z = np.arange(4, 44, 3)
    xyz = np.stack([np.full(z.size, 24.0) * ANISO[0],
                    np.full(z.size, 23.0) * ANISO[1], z * ANISO[2]], -1)
    os.makedirs(root, exist_ok=True)
    swc = os.path.join(root, "b.swc")
    with open(swc, "w") as f:
        f.write("# trace\n")
        for i, (x, y, zz) in enumerate(xyz, 1):
            f.write(f"{i} 3 {x} {y} {zz} 1.0 {i - 1 if i > 1 else -1}\n")
    img_io.write_zarr(a, os.path.join(root, "a.zarr"))
    img_io.write_zarr(seg, os.path.join(root, "seg.zarr"))
    img_io.write_zarr(b, os.path.join(root, "b.zarr"))
    arrays = [{"brain_id": "a", "img": a, "segmentation": seg, "offset": 37},
              {"brain_id": "b", "img": b, "swc": swc}]
    paths = [{"brain_id": "a", "img": os.path.join(root, "a.zarr"),
              "segmentation": os.path.join(root, "seg.zarr"), "offset": 37},
             {"brain_id": "b", "img": os.path.join(root, "b.zarr"),
              "swc": swc}]
    return arrays, paths


@pytest.fixture(scope="module")
def brains(tmp_path_factory):
    return _brains(str(tmp_path_factory.mktemp("brains")))


KW = dict(patch_shape=PATCH, boundary_buffer=0, sigma_bm4d=SIGMA,
          max_resample_attempts=6, seed=11)


def _pair(specs, **kw):
    kw = {**KW, **kw}
    ours = tl.TrainDataset(device="cpu", **kw)
    theirs = jl.TrainDataset(**kw)
    for spec in specs:
        for ds in (ours, theirs):
            ds.ingest_brain(spec["brain_id"], spec["img"],
                            segmentation=spec.get("segmentation"),
                            swc_source=spec.get("swc"),
                            offset=spec.get("offset", 0))
    return ours, theirs


def _teacher_close(a, b, raw):
    a, b, raw = (np.asarray(v, np.float64) for v in (a, b, raw))
    gap = np.sqrt(np.mean((a - b) ** 2))
    assert gap <= 0.2 * SIGMA, gap
    assert gap < np.sqrt(np.mean((a - raw) ** 2))


def test_draws_and_masks_bit_equal(brains):
    arrays, _ = brains
    ours, theirs = _pair(arrays)
    np.testing.assert_array_equal(ours.brains["b"].swc_voxels,
                                  theirs.brains["b"].swc_voxels)
    seen = set()
    for _ in range(24):
        bo, vo, ro = ours.sample_clean()
        bt, vt, rt = theirs.sample_clean()
        assert (bo, vo) == (bt, vt)
        np.testing.assert_array_equal(ro, rt)
        np.testing.assert_array_equal(ours.annotation_mask(bo, vo, ro),
                                      theirs.annotation_mask(bt, vt, rt))
        seen.add(bo)
    assert seen == {"a", "b"}
    np.testing.assert_array_equal(ours.sample_intensity_values(3),
                                  theirs.sample_intensity_values(3))
    assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state


@pytest.mark.parametrize("fn", ["sample_segmentation_voxel",
                                "sample_bright_voxel",
                                "sample_skeleton_voxel",
                                "sample_interior_voxel"])
def test_each_voxel_sampler_bit_equal(brains, fn):
    arrays, _ = brains
    ours, theirs = _pair(arrays)
    brain = "b" if fn == "sample_skeleton_voxel" else "a"
    for _ in range(6):
        assert getattr(ours, fn)(brain) == getattr(theirs, fn)(brain)


def test_coherence_gate_and_mask_hierarchy(brains):
    arrays, _ = brains
    ours, _ = _pair(arrays, foreground_rate=0.0, max_resample_attempts=12)
    from exaspim_tpu_torch.ops.metrics import patch_has_incoherent_segment

    for _ in range(8):
        brain, voxel, raw = ours.sample_clean()
        seg = ours._segmentation_patch(brain, voxel)
        assert seg is None or not patch_has_incoherent_segment(seg, raw)
    # Segmentation, skeleton, else the robust-intensity fallback.
    raw = ours.read_counts("a", (24, 24, 24))
    assert raw.max() == np.clip(
        arrays[0]["img"][16:32, 16:32, 16:32].astype(np.int64) - 37,
        0, None).max()
    np.testing.assert_array_equal(ours.annotation_mask("a", (24, 24, 24),
                                                       raw), arrays[0][
        "segmentation"][16:32, 16:32, 16:32] > 0)
    assert ours.annotation_mask("b", (24, 24, 24),
                                ours.read_counts("b", (24, 24, 24))).any()
    ours.ingest_brain("plain", arrays[1]["img"])
    plain = ours.read_counts("plain", (24, 24, 24))
    from exaspim_tpu_torch.ops.metrics import make_foreground_mask

    np.testing.assert_array_equal(
        ours.annotation_mask("plain", (24, 24, 24), plain),
        make_foreground_mask(plain, k=ours.bright_k))


def test_examples_and_validation_pool_match_jax(brains):
    arrays, _ = brains
    ours, theirs = _pair(arrays)
    for _ in range(2):
        ro, to, fo, bo, vo = ours.sample_example()
        rt, tt, ft, bt, vt = theirs.sample_example()
        assert (bo, vo) == (bt, vt)
        np.testing.assert_array_equal(ro, rt)
        np.testing.assert_array_equal(fo, ft)
        assert to.dtype == np.uint16 and to.shape == PATCH
        _teacher_close(to, tt, ro)
    state = ours.rng.bit_generator.state
    vo = tl.ValidateDataset(ours, n_examples=2, seed=5)
    vt = jl.ValidateDataset(theirs, n_examples=2, seed=5)
    assert ours.rng.bit_generator.state == state  # the train stream kept
    assert len(vo) == len(vt) == 2
    for eo, et in zip(vo.examples, vt.examples):
        assert eo[3:] == et[3:]
        np.testing.assert_array_equal(eo[0], et[0])
        np.testing.assert_array_equal(eo[2], et[2])
        _teacher_close(eo[1], et[1], eo[0])
    raw, teacher, counts, fg = vo[1]
    np.testing.assert_array_equal(raw, counts)


def test_init_datasets_with_calibration_matches_jax(brains):
    _, paths = brains
    cfg = {"kind": "asinh", "params": {"scale": 50.0},
           "calibrate": {"offset": True}}
    kw = dict(patch_shape=PATCH, transform_cfg=cfg, calibrate=True,
              n_val_examples=1, seed=3, boundary_buffer=0, sigma_bm4d=SIGMA)
    ot, ov, otf = tl.init_datasets(paths, device="cpu", **kw)
    jt, jv, jtf = jl.init_datasets(paths, **kw)
    assert otf.cfg == jtf.cfg and otf.cfg["params"]["offset"] > 0
    assert ov.examples[0][3:] == jv.examples[0][3:]
    np.testing.assert_array_equal(ov[0][0], jv[0][0])
    np.testing.assert_array_equal(ov[0][3], jv[0][3])
    assert ot.rng.bit_generator.state == jt.rng.bit_generator.state
    assert ot.device == "cpu" and tl.TrainDataset().device == "cuda"


def test_precompute_live_matches_the_script(brains, tmp_path):
    _, paths = brains
    config = str(tmp_path / "brains.json")
    with open(config, "w") as f:
        json.dump(paths, f)
    spec = importlib.util.spec_from_file_location(
        "precompute_script", os.path.join(ROOT, "scripts", "precompute.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    kw = dict(split="train", source="live", config=config, n=3, patch=PATCH,
              sigma_bm4d=SIGMA, seed=9)
    ours = tp.precompute(str(tmp_path / "torch"), device="cpu", **kw)
    theirs = script.precompute(str(tmp_path / "jax"), **kw)
    for name in ("raw.npy", "fg.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(ours, name)),
                                      np.load(os.path.join(theirs, name)))
    for name in ("transform.json", "config.json"):
        with open(os.path.join(ours, name)) as f, \
                open(os.path.join(theirs, name)) as g:
            assert json.load(f) == json.load(g)
    a, b = CachedPatchDataset(ours), JCached(theirs)
    assert len(a) == len(b) == 3
    for i in range(3):
        _teacher_close(a[i][1], b[i][1], a[i][0])
    # Patch i is drawn from SeedSequence([seed, stream, i]) alone.
    ds = tl.init_datasets(paths, patch_shape=PATCH, sigma_bm4d=SIGMA,
                          n_val_examples=0, seed=9, device="cpu")[0]
    ds.reseed(tp._seed_task(9, tp.SEED_STREAMS["train"], 2))
    np.testing.assert_array_equal(ds.sample_clean()[2], a[2][0])


def test_worker_copies_draw_the_same_patches(brains):
    """A copy of the dataset in each loader worker starts from the same
    generator state, in both packages (ROADMAP §3, notes on the
    reference): two workers draw the same patches. ``precompute`` reseeds
    each patch from its index instead."""
    arrays, _ = brains
    for ds in _pair(arrays):
        w1, w2 = (pickle.loads(pickle.dumps(ds)) for _ in range(2))
        for _ in range(3):
            (b1, v1, r1), (b2, v2, r2) = w1.sample_clean(), w2.sample_clean()
            assert (b1, v1) == (b2, v2)
            np.testing.assert_array_equal(r1, r2)
