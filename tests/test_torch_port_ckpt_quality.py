"""The port's quality check (``ckpt_quality``) against the JAX script.

``exaspim_tpu_torch.ckpt_quality.quality_records`` and
``scripts/ckpt_quality.py`` (its ``main``, run as it is, its printed JSON
records read back) score the shipped checkpoint on the same block of the
bench's phantom with the same arguments. Both run f32 on the CPU at patch
32: the script's ``build_model`` and ``predict`` are wrapped for the call to
pass ``dtype=float32`` and ``patch_size=32`` (the script itself builds bf16
and tiles with ``"auto"``); the port takes both as arguments. Tolerances are
those of ``tests/test_torch_port_quality.py``: the two f32 outputs differ by
a count on a few voxels (f32 sums in other orders), so the cratio gain is
held within 0.02, PSNR within 0.01 dB, the script's rounding, and SSIM
within 1e-4 (the JAX package's ``ssim3d`` reads above the f64 formula by
up to ~1e-4 near SSIM = 1; ROADMAP §3). Both sides round as the script
prints (PSNR to 0.01, SSIM to 1e-4), so each comparison allows the float
representation of one rounding step beside it. The noisy volume's ratio,
PSNR and SSIM are the same computation on the same uint16 volume. The
tests skip only where libblosc is missing.

The port's records also carry the entropy-proxy gain of the f32 output,
the figure the card's bf16 gain (``chip_smoke.py`` phase 5) is read
against; it is printed and held to agree in sign with the exact gain.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.compression.blosc import blosc_available as jax_blosc_ok
from exaspim_tpu_torch.ckpt_quality import bench_volumes, quality_records
from exaspim_tpu_torch.compression import blosc_available

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "bm4dnet.msgpack")
BLOCK, PATCH = 48, 32
GAIN_ATOL, PSNR_ATOL_DB, SSIM_ATOL = 0.02, 0.01, 1e-4
ROUNDING_SLACK = 1e-9  # two values rounded to 0.01 (1e-4) differ by k·0.01


def _need_blosc():
    if not (blosc_available() and jax_blosc_ok()):
        pytest.skip("libblosc is not installed on this host")


def _jax_records(monkeypatch, capsys, argv):
    """Run ``scripts/ckpt_quality.py``'s main with ``argv`` in f32 at patch
    32 on the CPU; its printed records."""
    import exaspim_tpu.inference as jinf
    import exaspim_tpu.models as jmodels

    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_quality_script", os.path.join(ROOT, "scripts",
                                                "ckpt_quality.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    build, predict, update = (jmodels.build_model, jinf.predict,
                              jax.config.update)
    monkeypatch.setattr(jmodels, "build_model", lambda cfg, dtype=None:
                        build(cfg, dtype=jnp.float32))
    monkeypatch.setattr(jinf, "predict", lambda *a, patch_size=None, **k:
                        predict(*a, patch_size=PATCH, **k))
    # The script points JAX's compilation cache at a directory of its own;
    # the test keeps JAX's configuration as it is.
    monkeypatch.setattr(jax.config, "update", lambda name, value: None
                        if name == "jax_compilation_cache_dir"
                        else update(name, value))
    capsys.readouterr()
    script.main(argv)
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.strip().splitlines()]


def _r05_record():
    """The JAX package's quality record on the bench block: the last JSON
    line with a ``cratio_gain`` in the tail of ``BENCH_r05.json``."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    recs = []
    for line in tail.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "cratio_gain" in rec:
            recs.append(rec)
    assert recs, "BENCH_r05.json holds no quality record"
    return recs[-1]


def _close(got, want, atol):
    return abs(got - want) <= atol + ROUNDING_SLACK


@pytest.mark.parametrize("family,offset", [("a", "none"), ("a", "auto"),
                                           ("b", "auto")])
def test_quality_records_match_the_jax_script(monkeypatch, capsys, family,
                                              offset):
    _need_blosc()
    want = _jax_records(monkeypatch, capsys, [
        CKPT, "--block", str(BLOCK), "--family", family,
        "--volume-offset", offset])
    got = quality_records([CKPT], block=BLOCK, family=family,
                          volume_offset=offset, device="cpu",
                          dtype=torch.float32, patch_size=PATCH)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(w) <= set(g), (sorted(w), sorted(g))
    (gn, gd), (wn, wd) = got, want
    print(f"{family}/{offset}: port {gn} {gd}; jax {wn} {wd}")
    assert gn["family"] == wn["family"] == family
    assert gn["cratio_noisy"] == wn["cratio_noisy"]
    assert gn["psnr_noisy_db"] == wn["psnr_noisy_db"]
    assert _close(gn["ssim_noisy"], wn["ssim_noisy"], SSIM_ATOL)
    assert gd["ckpt"] == wd["ckpt"] == CKPT
    assert _close(gd["cratio_gain"], wd["cratio_gain"], GAIN_ATOL)
    assert _close(gd["psnr_denoised_db"], wd["psnr_denoised_db"],
                  PSNR_ATOL_DB)
    assert _close(gd["ssim_denoised"], wd["ssim_denoised"], SSIM_ATOL)
    # The proxy gain of the f32 output, the yardstick of the card's bf16
    # one, moves the way the exact gain does.
    assert gn["cratio_proxy_noisy"] > 1.0
    assert (gd["cratio_proxy_gain"] - 1.0) * (gd["cratio_gain"] - 1.0) > 0


def test_bench_volumes_equal_the_jax_phantoms():
    from exaspim_tpu.data.synthetic import (
        neurite_phantom,
        neurite_phantom_b,
        noisy_observation,
    )

    for family, make in (("a", lambda: neurite_phantom(
            (BLOCK,) * 3, n_tubes=24, seed=3)[0]),
            ("b", lambda: neurite_phantom_b((BLOCK,) * 3, seed=3)[0])):
        clean, noisy = bench_volumes(BLOCK, family, seed_clean=3,
                                     seed_noise=4)
        jclean = make()
        np.testing.assert_array_equal(clean, jclean)
        np.testing.assert_array_equal(noisy, noisy_observation(jclean,
                                                               seed=4))


def test_quality_records_refuse_bad_arguments():
    with pytest.raises(ValueError, match="family"):
        bench_volumes(16, family="c")
    with pytest.raises(ValueError, match="volume_offset"):
        quality_records([CKPT], block=16, volume_offset="yes", device="cpu")


@pytest.mark.slow
def test_full_block_passes_the_bench_guard_near_r05():
    """The bench's 256³ block through the port (f32, CPU, patch "auto" as
    the bench tiles it): ``bench.quality_ok`` passes, and the gains are
    within 0.02 (cratio) and 0.1 dB (PSNR) of the JAX record in
    BENCH_r05.json."""
    _need_blosc()
    from bench import quality_ok

    r05 = _r05_record()
    noisy, den = quality_records([CKPT], block=256, device="cpu",
                                 dtype=torch.float32)
    rec = {"cratio_gain": den["cratio_gain"],
           "ssim_noisy": noisy["ssim_noisy"],
           "ssim_denoised": den["ssim_denoised"],
           "psnr_gain_db": den["psnr_denoised_db"] - noisy["psnr_noisy_db"]}
    print(f"256^3: {noisy} {den}")
    assert quality_ok(rec)
    assert abs(rec["cratio_gain"] - r05["cratio_gain"]) <= GAIN_ATOL
    assert abs(rec["psnr_gain_db"] - r05["psnr_gain_db"]) <= 0.1
