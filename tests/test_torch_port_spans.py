"""The port's spans (``utils/profiling.span``) inside the pipeline,
inference, the loader and the trainer.

* With no profiler running, ``span`` hands back one shared null context
  and never reaches ``record_function``, in the function and in whole
  ``denoise_volume`` and ``Trainer.run`` calls.
* Under ``torch.profiler`` a tiny ``denoise_volume`` records every
  ``pipeline.*`` and ``inference.*`` span, each forward inside a slab and
  each slab inside the volume; a two-epoch ``Trainer.run`` on the
  streaming loader records the loader's and the trainer's spans.
* A span's interval brackets the torch operations it wraps: the spans and
  the operations are events of one session, on one clock.
* A span entered before the profiler starts, or left after it stops,
  raises nothing.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from exaspim_tpu_torch.data.cache import (
    CachedPatchDataset,
    CachedValidateDataset,
    write_cache,
)
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.pipeline import denoise_volume
from exaspim_tpu_torch.train.trainer import Trainer
from exaspim_tpu_torch.transforms import build_transform
from exaspim_tpu_torch.utils import profiling

LINEAR = {"kind": "linear", "params": {"mn": 0.0, "mx": 1000.0, "clip": 8.0}}
ASINH = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
DENOISE = dict(slab_z=32, patch_size=16, overlap=4, trim=2, batch_size=4,
               device="cpu")
PIPELINE_SPANS = {"pipeline.volume", "pipeline.wait", "pipeline.slab",
                  "pipeline.write", "pipeline.drain", "inference.cast",
                  "inference.upload", "inference.forward",
                  "inference.stitch", "inference.download"}
TRAINER_SPANS = {"loader.wait", "loader.upload", "trainer.step",
                 "trainer.log", "trainer.validate"}


class DoublePlusOne(torch.nn.Module):
    def forward(self, x):
        return x * 2.0 + 0.01


def _img(shape=(80, 24, 20)):
    return np.random.default_rng(0).integers(0, 900, shape).astype(np.uint16)


def _host_events(prof):
    """``[(start_ns, end_ns, name)]`` of the session's host events."""
    return [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
            for ev in prof.profiler.kineto_results.events()]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _host_events(prof)


def _inside(inner, outers):
    a, b, _ = inner
    return any(a0 <= a and b <= b0 for a0, b0, _ in outers)


@pytest.fixture
def no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _trainer_run(root, epochs=2):
    rng = np.random.default_rng(1)
    raw = rng.integers(90, 900, (8, 16, 16, 16)).astype(np.uint16)
    teacher = np.clip(raw.astype(np.int32) // 2 + 50, 0, 65535).astype(
        np.uint16)
    fg = rng.random(raw.shape) < 0.2
    write_cache(str(root / "cache"), raw, teacher, fg, ASINH)
    t = Trainer(str(root / "out"), UNet(width_multiplier=0.25),
                build_transform(ASINH), epochs=epochs, batch_size=4,
                device_cache=False, val_every=1000, log_every=1,
                exact_cratio_examples=0, tensorboard=False, keep_mips=0,
                device="cpu")
    t.run(CachedPatchDataset(str(root / "cache")),
          CachedValidateDataset(str(root / "cache")))


def test_no_profiler_hands_back_one_null_context(no_record_function):
    assert not torch._C._autograd._profiler_enabled()
    first = profiling.span("pipeline.wait")
    assert first is profiling.span("trainer.step")
    with first:
        with profiling.span("inference.forward"):
            torch.ones(4).add_(1)


def test_no_profiler_no_record_function_in_the_program(no_record_function,
                                                       tmp_path):
    img = _img()
    out = denoise_volume(img, DoublePlusOne(), build_transform(LINEAR),
                         **DENOISE)
    assert out.shape == img.shape
    _trainer_run(tmp_path, epochs=1)


def test_denoise_volume_records_every_pipeline_and_inference_span():
    img = _img()
    out, events = _profiled(lambda: denoise_volume(
        img, DoublePlusOne(), build_transform(LINEAR), **DENOISE))
    assert out.shape == img.shape
    names = {n for _, _, n in events}
    assert PIPELINE_SPANS <= names, PIPELINE_SPANS - names
    by = {k: [e for e in events if e[2] == k] for k in PIPELINE_SPANS}
    assert len(by["pipeline.volume"]) == 1
    assert len(by["pipeline.slab"]) == 3  # 80 planes in slabs of 32
    assert len(by["pipeline.wait"]) == 4  # three tiles and the end
    for child in ("pipeline.wait", "pipeline.slab", "pipeline.write",
                  "pipeline.drain"):
        assert all(_inside(e, by["pipeline.volume"]) for e in by[child])
    for child in ("inference.cast", "inference.upload", "inference.forward",
                  "inference.stitch", "inference.download"):
        assert by[child] and all(_inside(e, by["pipeline.slab"])
                                 for e in by[child]), child


def test_trainer_records_loader_and_trainer_spans(tmp_path):
    _, events = _profiled(lambda: _trainer_run(tmp_path))
    count = {k: sum(1 for e in events if e[2] == k) for k in TRAINER_SPANS}
    assert count["trainer.step"] == 4  # two epochs of two batches
    assert count["trainer.log"] == 4  # log_every=1
    assert count["trainer.validate"] == 1  # after the loop
    # Each batch is waited for and uploaded once, and each epoch's
    # producer hands over its end: 2 × (2 + 1) waits in training, 2 + 1
    # more in the validation's loader.
    assert count["loader.upload"] == 4
    assert count["loader.wait"] == 9


def test_a_span_brackets_the_operations_it_wraps():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.outer"):
            x = torch.ones(256)
            with profiling.span("test.inner"):
                x.mul_(3)
            x.add_(1)
    events = _host_events(prof)
    one = {n: (a, b) for a, b, n in events
           if n in ("test.outer", "test.inner", "aten::mul_", "aten::add_")}
    assert len(one) == 4
    (oa, ob), (ia, ib) = one["test.outer"], one["test.inner"]
    assert oa <= ia <= one["aten::mul_"][0] <= one["aten::mul_"][1] <= ib
    assert ib <= one["aten::add_"][0] <= one["aten::add_"][1] <= ob


def test_spans_across_the_profiler_start_and_stop_do_not_raise():
    early = profiling.span("test.early")
    early.__enter__()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    early.__exit__(None, None, None)
    late = profiling.span("test.late")
    late.__enter__()
    torch.ones(8).add_(1)
    prof.stop()
    late.__exit__(None, None, None)
    names = [n for _, _, n in _host_events(prof)]
    assert "test.early" not in names
    assert names.count("test.late") == 1
