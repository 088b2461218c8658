"""The port's streaming pipeline against its own ``predict`` and against
``exaspim_tpu.pipeline.denoise_volume``.

The model is pointwise (``x * 2 + 0.01``, as ``tests/test_pipeline.py``), so
nothing depends on summation order: the streamed output equals the direct
``predict`` output exactly, and the port's uint16 volume equals the JAX
package's on the same input (the linear transform and the stitch are the
same f32 operations in both; tolerance 0).
"""

import os

import numpy as np
import pytest
import torch

import exaspim_tpu.pipeline as jp
import exaspim_tpu_torch.pipeline as tp
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu.utils import img_io as jio
from exaspim_tpu_torch.inference import predict
from exaspim_tpu_torch.transforms import build_transform
from exaspim_tpu_torch.utils import img_io as tio

TCFG = {"kind": "linear", "params": {"mn": 0.0, "mx": 1000.0, "clip": 8.0}}


class JaxDoublePlusOne:
    def apply(self, variables, x):
        return x * 2.0 + 0.01


class DoublePlusOne(torch.nn.Module):
    def forward(self, x):
        return x * 2.0 + 0.01


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 900, shape).astype(
        np.uint16)


def _jax_streamed(img, **kw):
    return jp.denoise_volume(img, JaxDoublePlusOne(), {},
                             jax_transform(TCFG), **kw)


CASES = {
    "z_slabs": dict(seed=0, shape=(80, 24, 20), kw=dict(
        slab_z=32, patch_size=16, overlap=4, trim=2, batch_size=4)),
    "yx_supertiles": dict(seed=3, shape=(20, 72, 60), kw=dict(
        slab_z=16, patch_size=16, overlap=4, trim=2, batch_size=4,
        max_block_voxels=20 * 60 * 60)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_equals_direct_and_jax(case):
    c = CASES[case]
    img = _img(c["seed"], c["shape"])
    t = build_transform(TCFG)
    pk = {k: v for k, v in c["kw"].items()
          if k not in ("slab_z", "max_block_voxels")}
    direct = predict(img, DoublePlusOne(), t, device="cpu", **pk)
    streamed = tp.denoise_volume(img, DoublePlusOne(), t, device="cpu",
                                 **c["kw"])
    assert streamed.dtype == np.uint16 and streamed.shape == img.shape
    np.testing.assert_array_equal(streamed, direct)
    np.testing.assert_array_equal(streamed, _jax_streamed(img, **c["kw"]))


@pytest.mark.parametrize("seed,shape,extra", [
    (1, (48, 20, 18), {}),
    (4, (20, 48, 40), {"max_block_voxels": 20 * 44 * 40}),
])
def test_streamed_zarr_to_zarr(tmp_path, seed, shape, extra):
    """Zarr→Zarr (z slabs, then y/x super-tiles): per-tile writes
    reassemble; the JAX package reads the port's output store and the port
    reads the JAX package's."""
    img = _img(seed, shape)
    t = build_transform(TCFG)
    in_path = os.path.join(tmp_path, "in.zarr")
    out_path = os.path.join(tmp_path, "out.zarr")
    jax_out = os.path.join(tmp_path, "out_jax.zarr")
    tio.write_zarr(img, in_path, chunks=(1, 1, 16, 16, 16))
    kw = dict(slab_z=16, patch_size=16, overlap=4, trim=2, batch_size=4,
              chunks=(1, 1, 16, 16, 16), **extra)
    result = tp.denoise_volume(in_path, DoublePlusOne(), t,
                               output_path=out_path, device="cpu", **kw)
    assert result == out_path
    direct = predict(img, DoublePlusOne(), t, patch_size=16, overlap=4,
                     trim=2, batch_size=4, device="cpu")
    back = np.asarray(tio.read(out_path)[...].read().result())[0, 0]
    np.testing.assert_array_equal(back, direct)
    np.testing.assert_array_equal(np.asarray(jio.read(out_path))[0, 0],
                                  direct)
    # The JAX pipeline on the store the port wrote, read back by the port.
    jp.denoise_volume(in_path, JaxDoublePlusOne(), {}, jax_transform(TCFG),
                      output_path=jax_out, **kw)
    np.testing.assert_array_equal(
        np.asarray(tio.read(jax_out)[...].read().result())[0, 0], direct)


def test_streamed_auto_patch_matches_explicit():
    """patch_size='auto' plans on the slab geometry: (48, 40, 40) fits no
    64+ candidate, so the planner falls back to patch 32, batch 1."""
    img = _img(5, (80, 40, 40))
    t = build_transform(TCFG)
    auto = tp.denoise_volume(img, DoublePlusOne(), t, slab_z=48,
                             patch_size="auto", overlap=4, trim=2,
                             device="cpu")
    explicit = tp.denoise_volume(img, DoublePlusOne(), t, slab_z=48,
                                 patch_size=32, overlap=4, trim=2,
                                 batch_size=1, device="cpu")
    np.testing.assert_array_equal(auto, explicit)
    np.testing.assert_array_equal(auto, _jax_streamed(
        img, slab_z=48, patch_size="auto", overlap=4, trim=2))


@pytest.mark.parametrize("shape,cores,halo,stride", [
    ((80, 24, 20), (32, 24, 20), 16, 12),
    ((20, 72, 60), (16, 28, 40), 16, 12),
    ((512, 512, 512), (256, 512, 512), 96, 84),
])
def test_tile_plan_equals_jax(shape, cores, halo, stride):
    plan = tp._tile_plan(shape, cores, halo, stride)
    assert plan == jp._tile_plan(shape, cores, halo, stride)
    for tile in plan:
        for (d0, d1, lo, hi), dim in zip(tile, shape):
            assert lo % stride == 0 and 0 <= lo <= d0 < d1 <= hi <= dim


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_stores_cross_between_the_packages(tmp_path, writer, reader):
    img = _img(6, (20, 24, 28))
    path = os.path.join(tmp_path, "v.zarr")
    (tio if writer == "torch" else jio).write_zarr(
        img, path, chunks=(1, 1, 16, 16, 16))
    arr = (tio if reader == "torch" else jio).read(path)
    assert tuple(arr.shape) == (1, 1, 20, 24, 28)
    np.testing.assert_array_equal(np.asarray(arr[...].read().result())[0, 0],
                                  img)


def test_reader_exception_reaches_the_caller():
    class Broken:
        shape = (40, 20, 20)
        ndim = 3

        def __getitem__(self, idx):
            raise OSError("chunk fetch failed")

    with pytest.raises(OSError, match="chunk fetch failed"):
        tp.denoise_volume(Broken(), DoublePlusOne(), build_transform(TCFG),
                          slab_z=16, patch_size=16, overlap=4, trim=2,
                          batch_size=4, device="cpu")


def test_reader_thread_ends_when_the_model_raises():
    """Many slabs and ``prefetch=1``: when ``predict`` raises on the first
    one the reader sits on a full queue, and must leave, not block."""
    import threading
    import time

    class Raises(torch.nn.Module):
        def forward(self, x):
            raise ValueError("model failed")

    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="model failed"):
        tp.denoise_volume(_img(9, (96, 20, 20)), Raises(),
                          build_transform(TCFG), slab_z=16, patch_size=16,
                          overlap=4, trim=2, batch_size=4, prefetch=1,
                          device="cpu")
    deadline = time.time() + 5.0
    while time.time() < deadline and set(threading.enumerate()) - before:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def test_mesh_is_a_later_slice():
    """``mesh=`` (ported with the multi-GPU layer) over a one-rank mesh
    equals the unsharded stream, slab by slab (two ranks:
    tests/test_torch_port_parallel.py)."""
    import torch.distributed as dist

    from exaspim_tpu_torch.parallel import make_mesh

    img = _img(7, (40, 20, 20))
    kw = dict(slab_z=24, patch_size=16, overlap=4, trim=2, device="cpu")
    want = tp.denoise_volume(img, DoublePlusOne(), build_transform(TCFG),
                             **kw)
    mesh = make_mesh(device="cpu")
    try:
        got = tp.denoise_volume(img, DoublePlusOne(), build_transform(TCFG),
                                mesh=mesh, **kw)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)


def test_defaults_follow_the_port_conventions():
    import inspect

    sig = inspect.signature(tp.denoise_volume).parameters
    assert list(sig)[:3] == ["img", "model", "transform"]
    assert sig["device"].default == "cuda"
    jsig = inspect.signature(jp.denoise_volume).parameters
    for name in ("slab_z", "patch_size", "overlap", "trim", "batch_size",
                 "clevel", "chunks", "prefetch", "progress",
                 "max_block_voxels", "output_path"):
        assert sig[name].default == jsig[name].default, name


# -- uint16 staging: a tile goes up as uint16 and only its core comes back --

ASINH = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
STAGE_KW = dict(patch_size=16, overlap=4, trim=2, batch_size=4)


class Blur(torch.nn.Module):
    """A seeded 3³ conv on the channels-last patches: each output voxel
    depends on its neighbours, so a tile's halo and crop matter."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(1, 1, 3, padding=1)
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            self.conv.weight.copy_(torch.rand(1, 1, 3, 3, 3, generator=g)
                                   / 13.5)
            self.conv.bias.fill_(0.01)

    def forward(self, x):
        return self.conv(x.movedim(-1, 1)).movedim(1, -1)


def _recipe(block, model, t, return_float=False):
    """The host-staged recipe: float32 cast on the host, the same tiled
    program, ``inverse_counts`` on the whole block, ``.astype(uint16)``
    (or the float inverse)."""
    from exaspim_tpu_torch.inference import build_tiled_program

    program, starts = build_tiled_program(model, t, block.shape,
                                          return_float=return_float,
                                          **STAGE_KW)
    with torch.inference_mode():
        out = program(torch.from_numpy(np.asarray(block, np.float32)),
                      starts)
    return out.numpy() if return_float else out


def _volume_recipe(img, model, t, slab_z):
    """The parent's ``denoise_volume``: each tile of the slab plan through
    the recipe, its core cropped on the host."""
    out = np.empty(img.shape, np.uint16)
    halo = STAGE_KW["patch_size"]
    stride = halo - STAGE_KW["overlap"]
    plan = tp._tile_plan(img.shape, (slab_z,) + img.shape[1:], halo, stride)
    for tile in plan:
        res = _recipe(img[tuple(slice(lo, hi) for _, _, lo, hi in tile)],
                      model, t)
        out[tuple(slice(d0, d1) for d0, d1, _, _ in tile)] = res[tuple(
            slice(d0 - lo, d1 - lo) for d0, d1, lo, _ in tile)]
    return out


@pytest.mark.parametrize("case", ["predict-u16", "predict-f32",
                                  "predict-u16-float", "predict-f32-float",
                                  "predict-u16-streamed", "volume-u16",
                                  "volume-f32"])
def test_staged_path_equals_the_host_recipe(case, tmp_path):
    """uint16 blocks take the staged path, anything else and float output
    the host's; every output is bit for bit the host-staged recipe's, in
    memory and through Zarr (whose writes must not see a staging buffer
    reused under them)."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 3000, (72, 22, 20))
    # A bright cube across two slabs: counts above 32767 come back too.
    img[20:52, 4:16, 4:16] = rng.integers(33000, 65536, (32, 12, 12))
    if "f32" in case:  # off the integers: the host cast's own input
        img = img + rng.random(img.shape) * 0.9
    img = img.astype(np.float32 if "f32" in case else np.uint16)
    model, t = Blur(), build_transform(ASINH)
    if case.startswith("predict"):
        return_float = case.endswith("float")
        kw = dict(STAGE_KW, return_float=return_float, device="cpu")
        if case.endswith("streamed"):
            kw["max_device_voxels"] = 40 * 22 * 20  # three super-tiles
        got = predict(img, model, t, **kw)
        want = _recipe(img, model, t, return_float)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        return
    want = _volume_recipe(img.astype(np.uint16), model, t, slab_z=24)
    kw = dict(STAGE_KW, slab_z=24, device="cpu")
    got = tp.denoise_volume(img, model, t, prefetch=1, **kw)
    np.testing.assert_array_equal(got, want)
    in_path, out_path = str(tmp_path / "in.zarr"), str(tmp_path / "out.zarr")
    tio.write_zarr(img.astype(np.uint16), in_path, chunks=(1, 1, 8, 8, 8))
    tp.denoise_volume(in_path, model, t, output_path=out_path, prefetch=1,
                      chunks=(1, 1, 8, 8, 8), **kw)
    np.testing.assert_array_equal(
        np.asarray(tio.read(out_path)[...].read().result())[0, 0], got)


def _counters():
    return predict.staged_u16, predict.staged_host, predict.bus_bytes


def _plan_sums(plan):
    """Tiles, tile voxels and core voxels of a super-tile plan."""
    def vox(tile, lo_hi):
        return int(np.prod([lo_hi(*axis) for axis in tile]))

    return (len(plan),
            sum(vox(tile, lambda d0, d1, lo, hi: hi - lo) for tile in plan),
            sum(vox(tile, lambda d0, d1, lo, hi: d1 - d0) for tile in plan))


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("entry", ["denoise_volume", "predict"])
def test_staging_counters(entry, dtype):
    """A run of N tiles counts N staged blocks of its kind and the bytes
    that cross: 2 (uint16) or 4 (float32, cast on the host) a tile voxel
    up, 2 a core voxel down. ``denoise_volume``'s reader hands over every
    tile as uint16; ``predict`` (here over its own super-tiles) stages by
    the input's dtype."""
    from exaspim_tpu_torch.inference import plan_stream_cores

    img = np.random.default_rng(12).integers(0, 900, (80, 24, 20)).astype(
        dtype)
    t = build_transform(TCFG)
    limit = 60 * 24 * 20
    if entry == "denoise_volume":
        plan = tp._tile_plan(img.shape, (32, 24, 20), 16, 12)
        staged_u16 = True
    else:
        plan = tp._tile_plan(img.shape, plan_stream_cores(
            img.shape, 16, 4, limit), 16, 12)
        staged_u16 = dtype == np.uint16
    n, tile_voxels, core_voxels = _plan_sums(plan)
    assert n >= 3
    before = _counters()
    if entry == "denoise_volume":
        tp.denoise_volume(img, DoublePlusOne(), t, slab_z=32, device="cpu",
                          **STAGE_KW)
    else:
        predict(img, DoublePlusOne(), t, device="cpu",
                max_device_voxels=limit, **STAGE_KW)
    u16, host, nbytes = (a - b for a, b in zip(_counters(), before))
    assert (u16, host) == ((n, 0) if staged_u16 else (0, n))
    assert nbytes == (2 if staged_u16 else 4) * tile_voxels + 2 * core_voxels


def test_tiles_above_the_device_limit_get_no_staging_pool(monkeypatch):
    """A tile above the device block limit streams through super-tiles that
    stage their own sub-blocks, so the pool makes no buffer for it; the
    volume is still the host-staged recipe's."""
    wide = tp._tile_plan((352, 1536, 1536), (256, 1536, 1536), 96, 84)
    assert tp._staging_pool(wide, 4, "cpu") == []
    slabs = tp._tile_plan((72, 22, 20), (24, 22, 20), 16, 12)
    pool = tp._staging_pool(slabs, 4, "cpu")
    assert len(pool) == 4 and pool[0][1].size == 64 * 22 * 20  # z 0..64

    made = []
    pool_of = tp._staging_pool
    monkeypatch.setattr(tp, "_staging_pool",
                        lambda *a: made.append(pool_of(*a)) or made[-1])
    monkeypatch.setattr(tp, "_MAX_DEVICE_VOXELS", 30 * 22 * 20)
    img = np.random.default_rng(13).integers(0, 65536, (72, 22, 20)).astype(
        np.uint16)
    model, t = Blur(), build_transform(ASINH)
    before = predict.staged_u16
    got = tp.denoise_volume(img, model, t, slab_z=24, prefetch=1,
                            device="cpu", **STAGE_KW)
    assert made == [[]] and predict.staged_u16 - before > len(slabs)
    np.testing.assert_array_equal(
        got, _volume_recipe(img, model, t, slab_z=24))
