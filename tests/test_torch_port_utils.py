"""The port's host utilities against the JAX package's, on local files.

* ``utils.util``: directory, txt and JSON helpers write the same files and
  return the same values; cloud-path parsing, ``time_writer`` equal.
* ``utils.cloud``: every listing, discovery, copy, upload and download over
  a local mirror of the bucket layout (as ``tests/test_cloud.py`` builds
  it) returns the same URLs and bytes in both packages.
* ``utils.swc``: the same parsed traces (ids, radii, parents, xyz, soma
  nodes) from a file, a directory and a zip; ``to_voxels`` equal.
* The live sampler's mask metrics (``local_autocorr``,
  ``highfreq_energy_fraction``, ``make_segmentation_mask``,
  ``patch_has_incoherent_segment``, ``make_skeleton_mask``): bit-equal on
  the repository's phantoms (both are numpy + scipy).
* ``utils.img_io``: a neuroglancer precomputed store opens to the same
  (z, y, x) view, with and without the ``precomputed://`` hint; the
  ``<prefix>/info`` probe of a URL agrees on fsspec's memory filesystem.
* ``estimate_background_offsets.main`` writes the JSON that
  ``scripts/estimate_background_offsets.py`` writes.
"""

import importlib.util
import json
import os
import zipfile

import numpy as np
import pytest

from exaspim_tpu.ops import metrics as jm
from exaspim_tpu.utils import cloud as jcloud
from exaspim_tpu.utils import img_io as jio
from exaspim_tpu.utils import swc as jswc
from exaspim_tpu.utils import util as jutil
from exaspim_tpu_torch.ops import metrics as tm
from exaspim_tpu_torch.utils import cloud as tcloud
from exaspim_tpu_torch.utils import img_io as tio
from exaspim_tpu_torch.utils import swc as tswc
from exaspim_tpu_torch.utils import util as tutil
from tests.phantoms import salt_pepper_block, smooth_blob, tube_phantom

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ util

def test_util_files_and_values_match_jax(tmp_path):
    for pkg, name in ((jutil, "jax"), (tutil, "port")):
        d = pkg.mkdir(str(tmp_path / name / "sub"))
        pkg.write_txt(os.path.join(d, "a.txt"), ["x", 3, "", "  y "])
        pkg.write_json(os.path.join(d, "b.json"),
                       {"z": 1, "a": [1, 2], "p": tmp_path})
        open(os.path.join(d, "c.swc"), "w").close()
        pkg.mkdir(str(tmp_path / name / "gone"))
        pkg.mkdir(str(tmp_path / name / "gone"), delete=True)
    a, b = tmp_path / "jax" / "sub", tmp_path / "port" / "sub"
    for f in ("a.txt", "b.json", "c.swc"):
        assert (a / f).read_bytes() == (b / f).read_bytes()
    assert tutil.list_dir(str(b)) == jutil.list_dir(str(a))
    assert tutil.list_dir(str(b), ".swc") == ["c.swc"]
    assert [os.path.basename(p) for p in tutil.list_paths(str(b), "txt")] \
        == [os.path.basename(p) for p in jutil.list_paths(str(a), "txt")]
    assert tutil.read_txt(str(b / "a.txt")) == jutil.read_txt(str(a / "a.txt"))
    assert tutil.read_json(str(b / "b.json")) \
        == jutil.read_json(str(a / "b.json"))
    tutil.rmdir(str(b))
    assert not b.exists()
    for path in ("gs://bucket/pre/fix", "s3://b", "s3://b/k/", "/local/x",
                 "memory://m"):
        assert tutil.is_cloud_path(path) == jutil.is_cloud_path(path)
        if jutil.is_cloud_path(path):
            assert tutil.parse_cloud_path(path) \
                == jutil.parse_cloud_path(path)
        else:
            with pytest.raises(ValueError, match="not a cloud path"):
                tutil.parse_cloud_path(path)
    for t, unit in ((12.0, "seconds"), (4000.0, "seconds"),
                    (90.0, "minutes"), (1e6, "seconds"), (5.0, "hours")):
        assert tutil.time_writer(t, unit) == jutil.time_writer(t, unit)
    assert tutil.sample_once([7]) == 7


# ----------------------------------------------------------------- cloud

@pytest.fixture()
def bucket(tmp_path):
    """A local bucket with the image-block layout of ``tests/test_cloud.py``."""
    root = tmp_path / "from_aind"
    for brain, blocks in (("brain_653158", 2), ("brain_706301", 1)):
        for b in range(blocks):
            d = root / brain / "blocks" / f"block_{b:03d}" / "input.zarr"
            d.mkdir(parents=True)
            (d / "0.0.0").write_bytes(bytes(range(64)))
            (d / ".zarray").write_text("{}")
        (root / brain / "blocks" / "block_000" / "notes.txt").write_text("hi")
    return tmp_path


def test_cloud_listing_and_discovery_match_jax(bucket):
    root = str(bucket / "from_aind")
    for fn, args in (("list_files", (str(bucket),)),
                     ("list_files", (str(bucket), ".zarray")),
                     ("list_subprefixes", (root,)),
                     ("find_subprefix_with_keyword", (root, "706301")),
                     ("list_block_paths", ("653158", root)),
                     ("exists", (root + "/brain_706301",)),
                     ("exists", (root + "/nothing",)),
                     ("is_file_in_prefix", (root, ".zarray")),
                     ("is_file_in_prefix", (root, "absent")),
                     ("directory_size_gb", (str(bucket),))):
        assert getattr(tcloud, fn)(*args) == getattr(jcloud, fn)(*args), fn
    assert len(tcloud.list_block_paths("653158", root=root)) == 2
    with pytest.raises(FileNotFoundError):
        tcloud.find_subprefix_with_keyword(root, "nope")


def test_cloud_copy_upload_download_match_jax(bucket, tmp_path):
    src = str(bucket / "from_aind" / "brain_653158")
    out = {}
    for pkg, name in ((jcloud, "jax"), (tcloud, "port")):
        dst = str(tmp_path / name / "copy")
        pkg.copy_tree(src, dst)
        pkg.copy_file(pkg.list_files(dst)[0], str(tmp_path / name / "one"))
        pkg.upload_tree(dst, str(tmp_path / name / "up"))
        pkg.download_tree(str(tmp_path / name / "up"),
                          str(tmp_path / name / "down"))
        out[name] = {
            os.path.relpath(os.path.join(r, f), tmp_path / name):
                open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(tmp_path / name) for f in fs}
    assert out["port"] == out["jax"] and len(out["port"]) == 1 + 3 * 5


# ------------------------------------------------------------------- swc

SWC = """# a trace
# OFFSET 10.0 20.0 30.0
1 1 0.0 0.0 0.0 250.0 -1
2 3 7.48 0.0 1.0 300.0 1
3 3 14.96 7.48 2.0 310.0 2
4 3 22.44 14.96 3.0 320.0 3
"""


def _swc_sources(tmp_path):
    d = tmp_path / "swcs"
    d.mkdir()
    (d / "n1.swc").write_text(SWC)
    (d / "n2.swc").write_text(SWC.replace("250.0", "1.5").replace(
        "# OFFSET 10.0 20.0 30.0\n", ""))
    with zipfile.ZipFile(d / "more.zip", "w") as z:
        z.writestr("deep/n3.swc", SWC.replace(" 1 0.0", " 2 0.0"))
        z.writestr("skip.txt", "x")
    (tmp_path / "tiny.swc").write_text("1 1 0 0 0 1 -1\n")
    return [str(d / "n1.swc"), str(d), str(d / "more.zip"),
            [str(d / "n2.swc"), str(tmp_path / "tiny.swc")]]


def _same_traces(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name]["soma_nodes"] == b[name]["soma_nodes"]
        for k in ("id", "radius", "pid", "xyz"):
            np.testing.assert_array_equal(a[name][k], b[name][k])


@pytest.mark.parametrize("min_size", [0, 2])
def test_swc_reader_matches_jax(tmp_path, min_size):
    for src in _swc_sources(tmp_path):
        ours = tswc.Reader(min_size=min_size).read(src)
        theirs = jswc.Reader(min_size=min_size).read(src)
        _same_traces(ours, theirs)
        assert ours
        for d in ours.values():
            np.testing.assert_array_equal(
                tswc.Reader().voxels(d), jswc.Reader().voxels(d))
    with pytest.raises(ValueError, match="unsupported"):
        tswc.Reader().read(str(tmp_path / "x.txt"))
    xyz = np.random.default_rng(0).uniform(0, 500, (20, 3))
    np.testing.assert_array_equal(tswc.to_voxels(xyz), jswc.to_voxels(xyz))
    assert tswc.ANISOTROPY == jswc.ANISOTROPY


# ----------------------------------------------------------- mask metrics

def _volumes():
    blob = smooth_blob((24, 24, 24), seed=1)
    artifact = salt_pepper_block((24, 24, 24), block=(10, 10, 10),
                                 origin=(6, 6, 6), seed=2)
    tube = tube_phantom((24, 24, 24), seed=3)
    labels = np.zeros((24, 24, 24), np.uint32)
    labels[6:16, 6:16, 6:16] = 3
    labels[9:12, 9:20, 2:22] = 7
    labels[0:2, 0:2, 0:2] = 9  # a segment under min_segment_voxels
    return {"blob": blob, "artifact": artifact, "tube": tube}, labels


@pytest.mark.parametrize("name", ["blob", "artifact", "tube"])
def test_mask_metrics_bit_equal(name):
    vols, labels = _volumes()
    raw = vols[name]
    seg = labels == 3
    for lag in (1, 2, 3):
        assert tm.local_autocorr(raw, seg, lag=lag) \
            == jm.local_autocorr(raw, seg, lag=lag)
    assert tm.local_autocorr(raw, np.zeros_like(seg)) == 1.0
    for sigma in (0.5, 1.0, 2.0):
        assert tm.highfreq_energy_fraction(raw, seg, smooth_sigma=sigma) \
            == jm.highfreq_energy_fraction(raw, seg, smooth_sigma=sigma)
    assert tm.highfreq_energy_fraction(np.ones_like(raw), seg) == 0.0
    for kw in ({}, {"min_autocorr": 0.9}, {"max_highfreq_frac": 0.05},
               {"min_segment_voxels": 2000}):
        assert tm.patch_has_incoherent_segment(labels, raw, **kw) \
            == jm.patch_has_incoherent_segment(labels, raw, **kw)
    assert tm.patch_has_incoherent_segment(np.zeros_like(labels), raw) \
        is False
    for dilate in (0, 1, 2):
        np.testing.assert_array_equal(
            tm.make_segmentation_mask(labels, dilate),
            jm.make_segmentation_mask(labels, dilate))


def test_incoherence_gate_reads_the_artifact():
    vols, labels = _volumes()
    assert tm.patch_has_incoherent_segment(labels, vols["artifact"])
    assert not tm.patch_has_incoherent_segment(labels, vols["tube"])


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_skeleton_mask_bit_equal(dilate):
    pts = np.random.default_rng(4).integers(-5, 60, (300, 3))
    for start in ((0, 0, 0), (10, 20, 5), (40, 40, 40)):
        np.testing.assert_array_equal(
            tm.make_skeleton_mask(pts, start, (16, 20, 24), dilate),
            jm.make_skeleton_mask(pts, start, (16, 20, 24), dilate))


# ---------------------------------------------------------------- img_io

def _precomputed(path, arr):
    import tensorstore as ts

    z, y, x = arr.shape
    ts.open({
        "driver": "neuroglancer_precomputed",
        "kvstore": {"driver": "file", "path": str(path)},
        "multiscale_metadata": {"type": "image", "data_type": "uint16",
                                "num_channels": 1},
        "scale_metadata": {"size": [x, y, z], "resolution": [748, 748, 1000],
                           "chunk_size": [4, 5, 4], "encoding": "raw"},
        "create": True,
    }).result()[...] = arr.transpose(2, 1, 0)[..., None]


def test_precomputed_read_matches_jax(tmp_path, monkeypatch):
    arr = np.random.default_rng(4).integers(0, 1000, (8, 10, 12)).astype(
        np.uint16)
    _precomputed(tmp_path / "ng", arr)
    monkeypatch.chdir(tmp_path)
    for path in (str(tmp_path / "ng"), "precomputed://ng"):
        ours, theirs = tio.read(path), jio.read(path)
        assert tuple(ours.shape) == tuple(theirs.shape) == arr.shape
        np.testing.assert_array_equal(np.asarray(ours), arr)
        np.testing.assert_array_equal(tio.get_patch(ours, (4, 5, 6),
                                                    (2, 4, 6)),
                                      jio.get_patch(theirs, (4, 5, 6),
                                                    (2, 4, 6)))
    # A Zarr store with a stray info file stays Zarr.
    tio.write_zarr(arr, str(tmp_path / "z"))
    (tmp_path / "z" / "info").write_text("{}")
    assert not tio._is_neuroglancer_precomputed(str(tmp_path / "z"))
    np.testing.assert_array_equal(tio.as_5d(tio.read(str(tmp_path / "z"))),
                                  tio.as_5d(arr))


def test_precomputed_probe_of_a_url_matches_jax():
    import fsspec

    fs = fsspec.filesystem("memory")
    for p in ("tseg/info", "tzarr/info", "tzarr/zarr.json"):
        with fs.open(p, "wb") as f:
            f.write(b"{}")
    try:
        for url in ("memory://tseg", "memory://tzarr", "memory://nothing",
                    "unknownscheme://x"):
            assert tio._is_neuroglancer_precomputed(url) \
                == jio._is_neuroglancer_precomputed(url), url
        assert tio._is_neuroglancer_precomputed("memory://tseg")
        assert tio._store_bytes("memory://tseg/info") == b"{}"
        assert tio._store_bytes("memory://tseg/none") is None
    finally:
        fs.rm("/tseg", recursive=True)
        fs.rm("/tzarr", recursive=True)


# ----------------------------------------------------- background offsets

def test_estimate_background_offsets_matches_the_script(tmp_path, capsys):
    from exaspim_tpu_torch import estimate_background_offsets as ebo

    rng = np.random.default_rng(6)
    brains = []
    for i, ped in enumerate((90, 140)):
        vol = (rng.poisson(30, (16, 16, 16)) + ped).astype(np.uint16)
        vol[:4] = 0
        tio.write_ome_zarr(vol, str(tmp_path / f"b{i}.zarr"), n_levels=2,
                           chunks=(1, 1, 8, 8, 8))
        brains.append({"brain_id": f"b{i}", "img": str(tmp_path / f"b{i}.zarr")})
    flat = (rng.poisson(30, (8, 8, 8)) + 60).astype(np.uint16)
    tio.write_zarr(flat, str(tmp_path / "flat.zarr"))  # no levels: fallback
    brains += [{"brain_id": "flat", "img": str(tmp_path / "flat.zarr")},
               {"brain_id": "missing", "img": str(tmp_path / "none")}]
    with open(tmp_path / "brains.json", "w") as f:
        json.dump(brains, f)
    spec = importlib.util.spec_from_file_location(
        "offsets_script",
        os.path.join(ROOT, "scripts", "estimate_background_offsets.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    def lines(out):  # a failure's message names the store's own error
        return [ln.split(" (")[0] if "FAILED" in ln else ln
                for ln in out.replace("ours", "theirs").splitlines()]

    for level in ("0", "1"):
        args = ["--config", str(tmp_path / "brains.json"), "--level", level,
                "--percentile", "2.0"]
        ebo.main(args + ["--out", str(tmp_path / "ours.json")])
        ours = capsys.readouterr().out
        script.main(args + ["--out", str(tmp_path / "theirs.json")])
        theirs = capsys.readouterr().out
        assert (tmp_path / "ours.json").read_text() \
            == (tmp_path / "theirs.json").read_text()
        assert lines(ours) == lines(theirs)
        got = json.loads((tmp_path / "ours.json").read_text())
        assert sorted(got) == ["b0", "b1", "flat"]
        assert got["b1"] > got["b0"] > got["flat"] > 0
