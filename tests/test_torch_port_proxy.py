"""The port's compressibility proxy and validation metrics against JAX.

``byte_histogram`` (plain version on the CPU) equals the reference's
scatter-add histogram (its Pallas histogram has no CPU mode), and
``chunk_byte_histograms`` (plain version) equals the reference's
``_byte_planes`` + ``_histogram_jnp`` on every chunk, exactly, on the
kernel's edge cases (``ops/hist_bench.edge_cases``, which the card's tests
run through the kernel); the proxy ratio agrees to 1e-5 relative (f32
entropy sums in another order); the
device metrics agree with ``evaluate_batch`` to 1e-5 relative, including
medians of even-length inputs (the mean of the two middle values, as
``jnp.median``); the host oracle and the score are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.compression import proxy as jp
from exaspim_tpu.data.synthetic import neurite_phantom, noisy_observation
from exaspim_tpu.ops import metrics as jm
from exaspim_tpu.ops import metrics_device as jmd
from exaspim_tpu_torch.compression import proxy as tp
from exaspim_tpu_torch.ops import metrics as tm
from exaspim_tpu_torch.ops import metrics_device as tmd


@pytest.fixture(scope="module")
def edge_cases():
    from exaspim_tpu_torch.ops.hist_bench import edge_cases

    return edge_cases("cpu")


def _jax_chunk_histograms(vols, chunk):
    """The reference's chunk walk, then per chunk ``_byte_planes`` and
    ``_histogram_jnp`` of each plane → ``(B, n_chunks, 2, 256)``."""
    b, z, y, x = vols.shape
    c = min(chunk, z, y, x)
    nz, ny, nx = z // c, y // c, x // c
    ch = (vols[:, :nz * c, :ny * c, :nx * c].astype(np.uint16)
          .reshape(b, nz, c, ny, c, nx, c).transpose(0, 1, 3, 5, 2, 4, 6)
          .reshape(-1, c, c, c))
    per = jax.jit(jax.vmap(lambda v: jnp.stack(
        [jp._histogram_jnp(p) for p in jp._byte_planes(v)])))
    return np.asarray(per(jnp.asarray(ch))).reshape(b, nz * ny * nx, 2, 256)


EDGE_CASES = ("one repeated byte", "uniform bytes", "noisy phantom planes",
              "wrap at 0 and 65535", "lengths no multiple of 16",
              "27^3 chunk", "more rows than 65535", "misaligned base")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_histogram_entries_equal_jax_per_chunk_and_row(edge_cases, case):
    rows, vols, chunk = edge_cases[case]
    got = tp.chunk_byte_histograms(vols, chunk)
    want = _jax_chunk_histograms(vols.numpy(), chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tp.byte_histogram(rows).numpy(),
        np.asarray(jax.jit(jax.vmap(jp._histogram_jnp))(
            jnp.asarray(rows.numpy()))))


@pytest.mark.parametrize("case,chunk", [
    ("wrap at 0 and 65535", 8), ("lengths no multiple of 16", 16),
    ("27^3 chunk", 64), ("noisy phantom planes", 32)])
def test_cratio_proxy_batch_matches_jax_on_edge_cases(edge_cases, case,
                                                      chunk):
    vols = edge_cases[case][1]
    want = [float(jp.cratio_proxy(jnp.asarray(v.numpy().astype(np.uint16)),
                                  chunk=chunk)) for v in vols]
    got = tp.cratio_proxy_batch(vols, chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_chunk_entry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="int32"):
        tp.chunk_byte_histograms(torch.zeros(1, 8, 8, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        tp.chunk_byte_histograms(torch.zeros(8, 8, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        tp.byte_histogram(torch.zeros(2, 8, dtype=torch.int32))


def test_hist_bench_runs_on_the_cpu():
    from exaspim_tpu_torch.ops import hist_bench

    out = hist_bench.main(["--block", "32", "--reps", "1"], device="cpu")
    val, pair = out["workloads"]
    assert val["rows"] == [2, 32 ** 3] and pair["rows"] == [4, 32 ** 3]
    for w in (val, pair):
        assert w["chunk_entry"]
        assert w["byte_histogram"]["bound_by"] == "bytes"
        assert w["chunk_byte_histograms"]["bound_ms"] > \
            w["byte_histogram"]["bound_ms"]


@pytest.fixture(scope="module")
def vols():
    clean, fg = neurite_phantom((32, 32, 32), n_tubes=4, seed=2)
    raw = noisy_observation(clean, seed=3)
    rng = np.random.default_rng(4)
    pred = np.clip(clean + rng.normal(0, 2, clean.shape), 0,
                   65535).astype(np.uint16)
    return raw, pred, fg


def test_byte_histogram_equals_scatter_add():
    rng = np.random.default_rng(0)
    rows = rng.choice(np.array([0, 255, 3, 128], np.uint8), size=(3, 1000),
                      p=[0.5, 0.3, 0.1, 0.1])
    got = tp.byte_histogram(torch.from_numpy(rows))
    assert got.shape == (3, 256) and got.dtype == torch.float32
    for r in range(3):
        np.testing.assert_array_equal(
            got[r].numpy(), np.asarray(jp._histogram_jnp(jnp.asarray(rows[r]))))
    np.testing.assert_array_equal(tp.byte_histogram_plain(
        torch.from_numpy(rows)).numpy(), got.numpy())


@pytest.mark.parametrize("shape,chunk", [((32, 32, 32), 16), ((20, 24, 28), 64),
                                         ((40, 36, 44), 16)])
def test_cratio_proxy_matches_jax(vols, shape, chunk):
    raw = vols[0][:shape[0], :shape[1], :shape[2]]
    if raw.shape != shape:  # (40, 36, 44): a larger odd volume
        raw = noisy_observation(neurite_phantom(shape, n_tubes=3, seed=1)[0],
                                seed=2)
    want = float(jp.cratio_proxy(jnp.asarray(raw), chunk=chunk))
    got = tp.cratio_proxy(torch.from_numpy(raw.astype(np.int32)), chunk)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    bits = float(tp.chunk_entropy_bits(torch.from_numpy(
        raw[:8, :8, :8].astype(np.int32))))
    np.testing.assert_allclose(
        bits, float(jp.chunk_entropy_bits(jnp.asarray(raw[:8, :8, :8]))),
        rtol=1e-5)


def test_cratio_proxy_batch_matches_vmapped_jax(vols):
    raw, pred, _ = vols
    batch = np.stack([raw, pred])
    want = jax.vmap(lambda v: jp.cratio_proxy(v, chunk=16))(jnp.asarray(batch))
    got = tp.cratio_proxy_batch(torch.from_numpy(batch.astype(np.int32)), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_evaluate_batch_matches_jax(vols):
    raw, pred, fg = vols
    teacher = np.clip(raw.astype(np.float32) * 0.9 + 10, 0, 65535)
    args = [np.stack([a, a[::-1]]).astype(np.float32)
            for a in (pred, raw, teacher, fg)]
    want = jmd.evaluate_batch(*map(jnp.asarray, args))
    got = tmd.evaluate_batch(*map(torch.from_numpy, args))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    # ... and against the port's host oracle, per example: f32 vs f64
    # (the device threshold adds 1e-6 inside the MAD, the host outside).
    for i in range(2):
        host = tm.evaluate_example(*(a[i] for a in args[:3]),
                                   args[3][i].astype(bool))
        for k, v in host.items():
            np.testing.assert_allclose(float(got[k][i]), v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_even_length_median_interpolates():
    x = np.array([[4.0, 1.0, 3.0, 2.0, 10.0, 7.0]], np.float32)
    got = tmd.quantile(torch.from_numpy(x), 0.5)
    assert float(got) == float(jnp.median(jnp.asarray(x[0]))) == 3.5
    assert float(torch.median(torch.from_numpy(x))) == 3.0  # lower middle
    np.testing.assert_allclose(
        float(tmd.percentile(torch.from_numpy(x), 99.9)),
        float(jnp.percentile(jnp.asarray(x[0]), 99.9)), rtol=1e-6)


def test_host_metrics_and_score_equal_jax(vols):
    raw, pred, fg = vols
    teacher = (raw * 0.9).astype(np.uint16)
    got = tm.evaluate_example(pred, raw, teacher, fg)
    want = jm.evaluate_example(pred, raw, teacher, fg)
    assert got == want
    w = {"fg_mae": 1.0, "bg_mae": 0.2, "top_pct_error": 0.5, "cratio": 10.0}
    assert tm.checkpoint_score(got, 2.5, w) == jm.checkpoint_score(want, 2.5, w)
    assert tm.DEFAULT_CHECKPOINT_WEIGHTS == jm.DEFAULT_CHECKPOINT_WEIGHTS
