"""The port's own blosc1 zstd codec against libblosc, on the CPU.

``exaspim_tpu_torch/csrc/blosc1_zstd.cpp`` writes blosc1 zstd frames over
libzstd alone. Each behaviour of ``blosc_compress_ctx(clevel, shuffle,
typesize, n, src, dest, n + 16, "zstd", 0, 1)`` is pinned here against
libblosc itself, byte for byte: one block and several, a leftover block,
buffers under blosc's minimum, incompressible data (the memcpyed frame)
and a block stored raw, type sizes 1, 2 and 4, every clevel, shuffle on
and off. Frames of either writer decode to the input. The chunk walk's
ratio equals the JAX package's ``compute_cratio`` (libblosc) and, unrounded,
the libblosc native walk. Then the machine without libblosc is
reproduced (the port's ``_load_blosc`` and the native walk's load made to
fail): ``best_codec()`` is still the exact codec, and the trainer's
validation, ``ckpt_quality.score`` and the supervised evaluator give the
ratios that libblosc gives.
"""

import ctypes

import numpy as np
import pytest
import torch

from exaspim_tpu import compression as jc
from exaspim_tpu_torch import compression as tc
from exaspim_tpu_torch.compression import blosc as tblosc
from exaspim_tpu_torch.compression import blosc1, native

pytestmark = pytest.mark.skipif(
    not (tblosc.blosc_available() and blosc1.available()),
    reason="needs libblosc (the yardstick) and libzstd with g++")

KIB = 1024
WEIGHTS = {"fg_mae": 1.0, "bg_mae": 0.2, "top_pct_error": 0.5,
           "cratio": 10.0}
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


def _libblosc(raw, typesize, clevel, shuffle, cname=b"zstd"):
    """``blosc_compress_ctx`` as the port's ``BloscCodec`` calls it."""
    lib = tblosc._load_blosc()
    dest = ctypes.create_string_buffer(len(raw) + 16)
    n = lib.blosc_compress_ctx(clevel, shuffle, typesize, len(raw), raw,
                               dest, len(raw) + 16, cname, 0, 1)
    assert n > 0
    return dest.raw[:n]


def _structured(shape, seed=0):
    """uint16 counts with structure and Poisson noise."""
    rng = np.random.default_rng(seed)
    idx = np.indices(shape).sum(0)
    return (100 + idx % 50 + rng.poisson(5, shape)).astype(np.uint16)


def _random_bytes(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _starts(frame):
    h = blosc1.frame_header(frame)
    n = -(-h["nbytes"] // h["blocksize"]) if h["nbytes"] else 0
    return [int.from_bytes(frame[16 + 4 * j:20 + 4 * j], "little")
            for j in range(n)]


def _block_sizes(frame):
    return [int.from_bytes(frame[s:s + 4], "little") for s in _starts(frame)]


# (buffer, typesize, clevel, shuffle, expected header fields, check)
CASES = {
    "one_block_64cubed": (lambda: _structured((64, 64, 64)).tobytes(), 2, 6,
                          1, {"blocksize": 512 * KIB, "flags": 0x91}, None),
    "one_block_40x64x64": (lambda: _structured((40, 64, 64)).tobytes(), 2, 6,
                           1, {"blocksize": 40 * 64 * 64 * 2}, None),
    "eight_blocks_32x256x256": (
        lambda: _structured((32, 256, 256)).tobytes(), 2, 6, 1,
        {"blocksize": 512 * KIB}, lambda f: len(_starts(f)) == 8),
    "leftover_block": (
        lambda: _structured((70, 64, 64)).tobytes() + b"\x07", 2, 6, 1,
        {"blocksize": 512 * KIB, "nbytes": 70 * 64 * 64 * 2 + 1},
        lambda f: len(_starts(f)) == 2),
    "empty": (lambda: b"", 2, 6, 1, {"memcpyed": True, "cbytes": 16}, None),
    "under_typesize": (lambda: b"\x01", 2, 6, 1,
                       {"memcpyed": True, "blocksize": 1}, None),
    "under_min_buffer_127": (lambda: bytes(range(127)), 2, 6, 1,
                             {"memcpyed": True, "cbytes": 127 + 16}, None),
    "at_min_buffer_128": (lambda: bytes(128), 2, 6, 1,
                          {"memcpyed": False}, None),
    "incompressible": (lambda: _random_bytes(300_000), 2, 6, 1,
                       {"memcpyed": True, "flags": 0x93,
                        "cbytes": 300_000 + 16}, None),
    "raw_stored_block": (
        lambda: _structured((16, 64, 64)).tobytes()
        + _random_bytes(600_000), 2, 1, 1, {"memcpyed": False},
        lambda f: 32 * KIB in _block_sizes(f)),
    "typesize_1": (lambda: _structured((20, 64, 64)).astype(np.uint8)
                   .tobytes(), 1, 6, 1, {"typesize": 1}, None),
    "typesize_4": (lambda: _structured((20, 64, 64)).astype(np.float32)
                   .tobytes() + b"\x01\x02\x03", 4, 6, 1,
                   {"typesize": 4}, None),
    "noshuffle": (lambda: _structured((40, 64, 64)).tobytes(), 2, 6, 0,
                  {"shuffle": 0, "flags": 0x90}, None),
    "noshuffle_typesize_4": (lambda: _structured((24, 64, 64))
                             .astype(np.int32).tobytes(), 4, 5, 0,
                             {"shuffle": 0}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_equal_libblosc(case):
    make, typesize, clevel, shuffle, fields, check = CASES[case]
    raw = make()
    want = _libblosc(raw, typesize, clevel, shuffle)
    got = blosc1.encode(raw, typesize, clevel, shuffle)
    assert got == want, (len(got), len(want), got[:16].hex(),
                         want[:16].hex())
    head = blosc1.frame_header(got)
    assert head["version"] == 2 and head["versionlz"] == 1
    assert head["compressor"] == "zstd" and head["dont_split"]
    assert head["cbytes"] == len(got) and head["nbytes"] == len(raw)
    for k, v in fields.items():
        assert head[k] == v, (k, head[k], v)
    if check is not None:
        assert check(got)


# blosc's block size for zstd (no split) by clevel, for a large buffer.
BLOCKSIZE = {0: 16, 1: 32, 2: 64, 3: 128, 4: 256, 5: 256, 6: 512, 7: 512,
             8: 512, 9: 1024}


@pytest.mark.parametrize("clevel", range(10))
def test_clevels_equal_libblosc(clevel):
    """Each clevel's block size and zstd level (``2·clevel − 1``, zstd's
    maximum at 9), on a buffer of two blocks and a leftover, and on one
    between 32 KiB and the block size (one block of the whole buffer)."""
    n_big = 2 * BLOCKSIZE[clevel] * KIB + 6 * KIB
    big = _structured((n_big // 2,)).tobytes()
    small = _structured((20 * KIB,)).tobytes()  # 40 KiB
    for raw in (big, small):
        got = blosc1.encode(raw, 2, clevel, 1)
        assert got == _libblosc(raw, 2, clevel, 1)
        head = blosc1.frame_header(got)
        assert head["memcpyed"] == (clevel == 0)
        want = min(BLOCKSIZE[clevel] * KIB, len(raw))
        assert head["blocksize"] == want, (clevel, head["blocksize"], want)


DECODE = {
    "zstd_shuffled": (lambda: _structured((64, 64, 64)), "zstd", 6, 1),
    "zstd_plain": (lambda: _structured((40, 64, 64)), "zstd", 6, 0),
    "zstd_blocks_and_leftover": (lambda: _structured((33, 128, 128)),
                                 "zstd", 6, 1),
    "zstd_typesize_4": (lambda: _structured((20, 64, 63))
                        .astype(np.uint32), "zstd", 4, 1),
    "zstd_raw_block": (lambda: np.frombuffer(
        _structured((16, 64, 64)).tobytes() + _random_bytes(600_000),
        np.uint16), "zstd", 1, 1),
    "memcpyed_incompressible": (lambda: np.frombuffer(
        _random_bytes(70_000), np.uint16), "zstd", 6, 1),
    "memcpyed_small": (lambda: np.arange(30, dtype=np.uint16), "zstd", 6, 1),
    "memcpyed_clevel_0": (lambda: _structured((8, 64, 64)), "zstd", 0, 1),
    "memcpyed_lz4": (lambda: np.arange(30, dtype=np.uint16), "lz4", 6, 1),
}


@pytest.mark.parametrize("case", sorted(DECODE))
def test_decode_libblosc_and_own_frames(case):
    make, cname, clevel, shuffle = DECODE[case]
    arr = make()
    raw = arr.tobytes()
    ts = arr.dtype.itemsize
    frames = [_libblosc(raw, ts, clevel, shuffle, cname.encode())]
    if cname == "zstd":
        frames.append(blosc1.encode(arr, ts, clevel, shuffle))
    for frame in frames:
        assert blosc1.decode(frame) == raw
        assert tblosc.BloscCodec().decode(frame) == raw


@pytest.mark.parametrize("cname", ["blosclz", "lz4", "lz4hc", "zlib"])
def test_decode_names_another_compressor(cname):
    frame = _libblosc(_structured((16, 64, 64)).tobytes(), 2, 6, 1,
                      cname.encode())
    assert not blosc1.frame_header(frame)["memcpyed"]
    with pytest.raises(ValueError, match=cname[:3]):
        blosc1.decode(frame)


def test_codec_interface_is_blosc_codecs():
    vol = _structured((40, 64, 64))
    ours, theirs = tc.Blosc1ZstdCodec(clevel=6), tblosc.BloscCodec(clevel=6)
    assert ours.config == theirs.config == jc.BloscCodec().config
    for buf in (vol, vol.astype(np.uint8), vol.tobytes()):
        enc = ours.encode(buf)
        assert enc == theirs.encode(buf)
        raw = buf.tobytes() if isinstance(buf, np.ndarray) else buf
        assert ours.decode(enc) == theirs.decode(enc) == raw
    with pytest.raises(ValueError, match="shuffle"):
        tc.Blosc1ZstdCodec(shuffle=2)
    assert blosc1.zstd_version().count(".") == 2


@pytest.fixture(scope="module")
def phantom_pair():
    """The 256³ bench phantom (clean) and its noisy observation."""
    from exaspim_tpu_torch.ckpt_quality import bench_volumes

    return bench_volumes(256)


def _ragged():
    return _structured((40, 48, 56), seed=3)


@pytest.mark.parametrize("which", ["clean_256", "noisy_256", "ragged"])
def test_walk_equals_jax_compute_cratio(which, phantom_pair):
    vol = {"clean_256": phantom_pair[0], "noisy_256": phantom_pair[1],
           "ragged": _ragged()}[which]
    chunk = (64, 64, 64) if which != "ragged" else (16, 32, 24)
    want = jc.compute_cratio(vol, jc.BloscCodec(), patch_shape=chunk)
    walk = blosc1.chunked_cratio(vol, chunk, n_threads=0)
    assert walk == native.chunked_cratio(vol, chunk)  # unrounded
    assert walk == blosc1.chunked_cratio(vol, chunk, n_threads=1)
    assert round(walk, 2) == want
    codec = tc.Blosc1ZstdCodec()
    assert tc.compute_cratio(vol, codec, patch_shape=chunk) == want
    assert tc.compute_cratio(vol, codec, patch_shape=chunk,
                             use_native=False) == want


@pytest.fixture
def no_libblosc(monkeypatch):
    """The card's machine: libblosc cannot be loaded, by the port's binding
    or by the native walk."""
    def refuse(*a, **k):
        raise OSError("libblosc shared library not found")

    monkeypatch.setattr(tblosc, "_load_blosc", refuse)
    monkeypatch.setattr(native, "_state", None)
    monkeypatch.setattr(
        native, "_build",
        lambda: (None, "libblosc.so.1 not found (the native walk links it)"))
    assert not tblosc.blosc_available() and not native.available()
    yield
    monkeypatch.undo()


def test_best_codec_without_libblosc(no_libblosc, phantom_pair):
    codec = tc.best_codec()
    assert type(codec) is tc.Blosc1ZstdCodec
    assert codec.config == jc.BloscCodec().config
    with pytest.raises(OSError):
        tc.BloscCodec()
    noisy = phantom_pair[1]
    assert tc.compute_cratio(noisy, codec) == jc.compute_cratio(
        noisy, jc.BloscCodec())
    with pytest.raises(RuntimeError, match="libblosc"):
        tc.best_codec(cname="lz4")


def test_best_codec_raises_with_the_reason(monkeypatch):
    real = ctypes.CDLL

    def no_zstd(name, *a, **k):
        if "zstd" in str(name):
            raise OSError(f"{name}: cannot open shared object file")
        return real(name, *a, **k)

    monkeypatch.setattr(ctypes, "CDLL", no_zstd)
    monkeypatch.setattr(blosc1, "_state", None)
    assert not blosc1.available()
    assert "libzstd.so.1 not found" in blosc1.unavailable_reason()
    with pytest.raises(RuntimeError, match="libzstd.so.1 not found"):
        tc.best_codec()
    with pytest.raises(RuntimeError, match="libzstd.so.1 not found"):
        blosc1.encode(b"x" * 200, 1)
    monkeypatch.setattr(ctypes, "CDLL", real)
    monkeypatch.setattr(blosc1, "_state", None)
    assert blosc1.available()


def test_ckpt_quality_score_without_libblosc(no_libblosc, phantom_pair):
    from exaspim_tpu_torch.ckpt_quality import exact_codec, score

    clean, noisy = (v[:96, :128, :80] for v in phantom_pair)
    got = score(noisy, clean, exact_codec(), device="cpu")
    assert got["cratio"] == jc.compute_cratio(noisy, jc.BloscCodec())


@pytest.fixture(scope="module")
def val_cache(tmp_path_factory):
    from exaspim_tpu.data.synthetic import make_synthetic_cache

    root = tmp_path_factory.mktemp("blosc1_val")
    return root, make_synthetic_cache(str(root / "val"), 4, (32, 32, 32),
                                      TCFG, seed=2)


@pytest.mark.parametrize("device_metrics", [True, False])
def test_trainer_validation_without_libblosc_matches_jax(
        no_libblosc, val_cache, device_metrics):
    """Both trainers validate the same predictions (an eval step that
    returns them) of the same batch; ``val_cratio`` is equal and so is
    ``val_score`` under the train script's weights (cratio 10)."""
    import jax.numpy as jnp

    from exaspim_tpu.data.cache import CachedValidateDataset as JVal
    from exaspim_tpu.data.loader import make_count_val_collate as jcollate
    from exaspim_tpu.models import UNet as JaxUNet
    from exaspim_tpu.train import Trainer as JaxTrainer
    from exaspim_tpu.transforms import build_transform as jax_transform
    from exaspim_tpu_torch.data.cache import CachedValidateDataset
    from exaspim_tpu_torch.data.loader import make_count_val_collate
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train.trainer import Trainer
    from exaspim_tpu_torch.transforms import build_transform

    root, val = val_cache
    jds, tds = JVal(val), CachedValidateDataset(val)
    jbatch = jcollate()([jds[i] for i in range(4)])
    tbatch = make_count_val_collate()([tds[i] for i in range(4)])
    teacher = np.asarray(tbatch[1])[..., 0].astype(np.int64)
    rng = np.random.default_rng(5)
    pred = np.clip(teacher + rng.integers(-3, 4, teacher.shape), 0,
                   65535).astype(np.uint16)[..., None]

    def jax_step(state, x, y, fg):
        return jnp.float32(0.25), jnp.asarray(pred)

    def port_step(state, x, y, fg):
        return (torch.tensor(0.25),
                torch.from_numpy(pred.astype(np.int32)))

    kw = dict(checkpoint_weights=WEIGHTS, exact_cratio_examples=3,
              keep_mips=0, tensorboard=False,
              val_device_metrics=device_metrics)
    jt = JaxTrainer(str(root / f"jax{device_metrics}"),
                    JaxUNet(width_multiplier=0.25), jax_transform(TCFG),
                    **kw)
    tt = Trainer(str(root / f"port{device_metrics}"),
                 UNet(width_multiplier=0.25), build_transform(TCFG),
                 device="cpu", **kw)
    assert type(tt.codec) is tc.Blosc1ZstdCodec
    want = jt.validate(None, jax_step, [jbatch], 0)
    got = tt.validate(None, port_step, [tbatch], 0)
    assert got["val_cratio"] == want["val_cratio"] > 1.0
    assert got["val_score"] == pytest.approx(want["val_score"], rel=1e-6)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def test_supervised_evaluator_without_libblosc(no_libblosc, tmp_path,
                                               monkeypatch):
    """The evaluator's ratio columns with the port's codec equal the JAX
    package's ``compute_cratio`` (libblosc) of the same volumes. A fixed
    map stands in for the model: the columns under test are the ratios."""
    from exaspim_tpu_torch import evaluate as ev
    from exaspim_tpu_torch.transforms import build_transform

    def denoise(noisy, *a, **k):
        return (np.asarray(noisy) // 8 * 8).astype(np.uint16)

    monkeypatch.setattr(ev, "restore_pipeline",
                        lambda *a, **k: (None, build_transform(TCFG)))
    monkeypatch.setattr(ev, "predict", denoise)
    blocks = {"a": _structured((32, 40, 36), seed=4),
              "b": _structured((70, 32, 48), seed=5)}
    sup = ev.SupervisedEvaluator(blocks, tmp_path, save_mips=False,
                                 device="cpu")
    assert type(sup.codec) is tc.Blosc1ZstdCodec
    df = sup.run("unused.ckpt")
    codec = jc.BloscCodec()
    for row, (_, vol) in zip(df.to_dict("records"), sorted(blocks.items())):
        noisy = jc.compute_cratio(vol, codec)
        den = jc.compute_cratio(denoise(vol), codec)
        assert row["cratio_noisy"] == noisy
        assert row["cratio"] == den
        assert row["cratio_gain"] == round(den / noisy, 3)
        assert den > noisy > 1.0
