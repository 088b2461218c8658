"""3D-RCAN in the port (``models/rcan3d.py``) on the CPU, at a small size
(8 channels, 2 residual groups of 2 blocks, reduction 4; seeded weights):

* the model against the benchmark's plain reference
  (``benchmark/reference/rcan3d.py``), and the comparison fails with the
  attention taken out;
* the attention's mean from the conv's Σy plus its bias against the mean
  of the biased activation, the attention from either, and the counter of
  attentions;
* a checkpoint written and restored through ``restore_pipeline`` gives
  the same bits; ``denoise_volume`` against the reference's tiled
  denoising; two training steps through ``train_bm4dnet.train``;
* the benchmark's conv counts at the published widths.

Nothing here imports JAX: the reference is the benchmark's plain torch.
"""

import numpy as np
import pytest
import torch

from benchmark import weights, yardstick
from benchmark.reference import rcan3d as ref_rcan
from benchmark.reference import tiled
from exaspim_tpu_torch.models import MODEL_REGISTRY, RCAN3D, build_model
from exaspim_tpu_torch.models import rcan3d

CFG = {"model": "RCAN3D", "num_channels": 8, "num_residual_groups": 2,
       "num_residual_blocks": 2, "channel_reduction": 4}
TRANSFORM = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
SEED = 2 ** 31 + 17
# Both sides run float32 on the CPU; they differ in the order of their sums
# (the plain conv over channels-last views against NCDHW, the mean from Σy
# against a reduction of the activation), so the outputs (about 0.5, spread
# about 0.5) agree to a few float32 ulps: 1e-5 leaves room above the 1.5e-6
# the two read and stays far below the 1.5 that dropping the attention
# moves.
ATOL = 1e-5


def _model(seed=SEED):
    model = build_model(CFG, device="cpu")
    params = weights.seeded(model, seed, "cpu")
    model.load_state_dict(params)
    return model, weights.flat_names(params)


def _input(shape=(2, 16, 20, 24), seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.05, 0.75, (*shape, 1)).astype(
        np.float32))


def _reference(params, x):
    with torch.no_grad():
        r = ref_rcan.forward(params, x.permute(0, 4, 1, 2, 3), CFG)
    return r.permute(0, 2, 3, 4, 1)


def test_registered_and_counted_as_published():
    assert MODEL_REGISTRY["RCAN3D"] is RCAN3D
    model = build_model({"model": "RCAN3D"}, device="cpu")
    assert model.config == {
        "model": "RCAN3D", "num_channels": 32, "num_residual_groups": 5,
        "num_residual_blocks": 3, "channel_reduction": 8,
        "residual_scaling": 1.0}
    assert sum(p.numel() for p in model.parameters()) == 1_002_621
    shapes = yardstick.conv_shapes(model.config, 96)
    fwd = [s for s in shapes if s[0] == "fwd"]
    assert len(fwd) == 38 and len(shapes) == 38 + 37
    assert sum(1 for s in fwd if s[2] == (32,) and s[3] == 32) == 36
    assert fwd[0][2:] == ((1,), 32) and fwd[-1][2:] == ((32,), 1)
    # 2 · 27 · (32 + 36 · 32² + 32) FLOP a voxel forward.
    assert yardstick.forward_flops(model.config, 1, 1) == 1_994_112


def test_matches_the_plain_reference():
    model, params = _model()
    x = _input()
    with torch.no_grad():
        y = model(x)
    ref = _reference(params, x)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert float(ref.std()) > 0.1  # a non-trivial output
    assert float((y - ref).abs().max()) <= ATOL


def _mean_of_the_block_input(self, h):
    y = torch.relu_(self.Conv_0(h, stats=False))
    y, _, _ = self.Conv_1(y)
    a = self.ChannelAttention_0(h.float().mean(dim=(1, 2, 3)))
    return torch.addcmul(h, y, a[:, None, None, None, :].to(y.dtype))


@pytest.mark.parametrize("fault", ["attention_one", "mean_of_block_input"])
def test_the_comparison_fails_without_the_attention(monkeypatch, fault):
    model, params = _model()
    x = _input()
    if fault == "attention_one":
        monkeypatch.setattr(rcan3d.ChannelAttention, "forward",
                            lambda self, mean: torch.ones_like(mean))
    else:
        monkeypatch.setattr(rcan3d.RCAB, "forward", _mean_of_the_block_input)
    with torch.no_grad():
        y = model(x)
    assert float((y - _reference(params, x)).abs().max()) > 100 * ATOL


def test_attention_mean_from_the_conv_sums_and_the_counters():
    model, _ = _model()
    conv = model.ResidualGroup_1.RCAB_0.Conv_1
    h = torch.relu(_input(seed=3).expand(-1, -1, -1, -1, 8).contiguous())
    with torch.no_grad():
        y, s1, _ = conv(h)
        y_plain = conv(h, stats=False)
    mean = s1 / (y.shape[1] * y.shape[2] * y.shape[3])
    own = y.mean(dim=(1, 2, 3))
    torch.testing.assert_close(mean, own, rtol=0, atol=1e-6)
    assert torch.equal(y, y_plain)
    before = dict(rcan3d.counters)
    with torch.no_grad():
        model(_input())
        att = model.ResidualGroup_0.RCAB_1.ChannelAttention_0
        a_sums, a_own = att(mean), att(own)
    torch.testing.assert_close(a_sums, a_own, rtol=0, atol=1e-6)
    assert rcan3d.counters["attention"] - before["attention"] == 4 + 2


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    from exaspim_tpu_torch.train.checkpoint import (
        restore_pipeline,
        save_checkpoint,
    )

    model, _ = _model()
    path = save_checkpoint(str(tmp_path / "rcan.msgpack"),
                           model.state_dict(), model.config, TRANSFORM)
    again, transform = restore_pipeline(path, dtype=torch.float32,
                                        device="cpu")
    assert again.config == model.config and transform.cfg == TRANSFORM
    x = _input()
    with torch.no_grad():
        assert torch.equal(again(x), model(x))


def test_denoise_volume_matches_the_tiled_reference():
    from exaspim_tpu_torch.pipeline import denoise_volume
    from exaspim_tpu_torch.transforms import build_transform

    model, params = _model()
    # A gentle exit conv, so that the output counts lie well inside uint16.
    with torch.no_grad():
        model.Conv_2.kernel.mul_(0.05)
    params["Conv_2/kernel"] = model.Conv_2.kernel.detach().clone()
    rng = np.random.default_rng(4)
    noisy = rng.poisson(300.0, (28, 30, 26)).astype(np.uint16)
    kw = dict(patch_size=16, overlap=4, trim=1)
    out = denoise_volume(noisy, model, build_transform(TRANSFORM), slab_z=16,
                         batch_size=2, device="cpu", **kw)
    ref = tiled.denoise(ref_rcan, params, CFG, TRANSFORM, noisy,
                        kw["patch_size"], kw["overlap"], kw["trim"], 2,
                        "cpu").numpy()
    assert out.dtype == np.uint16 and out.shape == noisy.shape
    assert 50 < ref.min() and ref.max() < 60000
    # The program rounds to counts, the reference does not; both sides'
    # float32 errors (~1e-6 in the transform domain) reach ~1e-3 count
    # through the inverse's slope (~1e4 counts a unit at 2,000 counts).
    assert np.abs(out - ref).max() <= 0.51


def test_two_training_steps_through_the_entry(tmp_path):
    from exaspim_tpu_torch.data.synthetic import make_synthetic_cache
    from exaspim_tpu_torch.train import train_bm4dnet
    from exaspim_tpu_torch.train.checkpoint import (
        find_best_checkpoint,
        load_checkpoint,
    )

    caches = [make_synthetic_cache(str(tmp_path / name), 4, (16, 16, 16),
                                   TRANSFORM, seed=s)
              for name, s in (("train", 1), ("val", 2))]
    trainer = train_bm4dnet.train(
        [caches[0]], [caches[1]], str(tmp_path / "run"), epochs=1,
        batch_size=2, lr=1e-3, model_cfg=CFG, bf16=False,
        exact_cratio_examples=0, device="cpu")
    assert trainer.state.step == 2
    assert isinstance(trainer.model, RCAN3D)
    ckpt = load_checkpoint(find_best_checkpoint(str(tmp_path / "run")))
    assert ckpt["model_config"] == {**CFG, "residual_scaling": 1.0}
    init = build_model(CFG, device="cpu").init_weights(42)
    moved = [k for k, v in init.state_dict().items()
             if not torch.equal(v, trainer.model.state_dict()[k])]
    assert "ResidualGroup_0.RCAB_0.ChannelAttention_0.Conv_0.kernel" in moved


def test_the_cli_passes_a_model_config(monkeypatch):
    import json

    from exaspim_tpu_torch.train import train_bm4dnet

    seen = []
    monkeypatch.setattr(train_bm4dnet, "train",
                        lambda *a, **kw: seen.append(kw))
    train_bm4dnet.main(["--train-cache", "t", "--val-cache", "v", "--out",
                        "o", "--model-config", json.dumps(CFG), "--device",
                        "cpu"])
    assert seen[0]["model_cfg"] == CFG


def test_the_reference_trainer_writes_what_the_program_restores(tmp_path):
    """``benchmark/train_rcan3d.py``, the shipped checkpoint's
    trainer (the plain reference alone), at the small size: two steps move
    the leaves, and the file it writes restores through
    ``restore_pipeline`` to a model that gives the reference's output."""
    import json

    from benchmark import train_rcan3d
    from benchmark.reference import msgpack_read, unet
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_config": CFG, "transform": TRANSFORM}))
    out = str(tmp_path / "rcan.msgpack")
    log = train_rcan3d.main([
        "--out", out, "--device", "cpu", "--config", str(cfg), "--steps",
        "2", "--batch", "2", "--patch", "16", "--block", "32", "--patches",
        "4"])
    assert len(log) == 2 and all(np.isfinite(r["loss"]) for r in log)
    tree, meta = msgpack_read.read_checkpoint(out)
    params = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in unet.flatten(tree).items()}
    init = train_rcan3d.init(CFG, 21)
    assert set(params) == set(init)
    for k in ("Conv_0/kernel", "Conv_2/bias",
              "ResidualGroup_1/RCAB_1/ChannelAttention_0/Conv_1/bias"):
        assert not torch.equal(params[k], init[k]), k
    assert meta["model_config"] == CFG and meta["step"] == 2
    model, _ = restore_pipeline(out, dtype=torch.float32, device="cpu")
    x = _input()
    with torch.no_grad():
        got = model(x)
        want = ref_rcan.forward(params, x.permute(0, 4, 1, 2, 3), CFG)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 4, 1), rtol=0,
                               atol=ATOL)


def test_the_attention_host_reader_leaves_out_the_runtime_calls():
    """``model.attention_host_ms``: the host's time inside the
    ``rcan.attention`` spans less its CUDA runtime calls there, a unit;
    None without the spans."""
    import importlib.util
    import os
    from types import SimpleNamespace

    path = os.path.join(os.path.dirname(__file__), "..", "benchmark",
                        "metrics", "model.attention_host_ms.py")
    spec = importlib.util.spec_from_file_location("attention_host", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    host = [(0.0, 100.0, "rcan.attention"), (10.0, 60.0, "cudaLaunchKernel"),
            (20.0, 30.0, "aten::addmm"), (150.0, 180.0, "cudaLaunchKernel"),
            (200.0, 300.0, "rcan.attention"), (250.0, 260.0, "cuLaunchKernel"),
            (290.0, 320.0, "cudaMemcpyAsync")]
    run = SimpleNamespace(trace=SimpleNamespace(host=host, device=[]),
                          units=[1, 2])
    # (200 µs of spans − 50 − 10 − 10 µs of calls inside them) / 2 units.
    assert abs(reader.read(run) - 0.065) < 1e-12
    run.trace.host = [h for h in host if h[2] != "rcan.attention"]
    assert reader.read(run) is None
