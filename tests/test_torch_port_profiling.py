"""The port's observability (``utils/profiling.py``), the Trainer's two
validation paths and the kernel build lock.

* ``device_memory_stats`` keeps the JAX package's keys per device
  (``bytes_in_use``, ``bytes_limit``), ``log_jsonl`` writes the JAX
  package's lines, ``StepTimer`` its keys; ``trace`` writes a
  Chrome-trace JSON that names the traced ops, and nothing when disabled.
* ``Trainer._validate_host`` (every example scored on the host by
  ``evaluate_example``) against the device path (``evaluate_batch`` and
  the proxy on the batch): the same exact cratio and loss, the metrics
  within 1e-5 relative (the device path reads the same f64 formulas
  batched; its percentile interpolates in f64 as numpy does), MIPs of
  both paths named by the step.
* ``ops/_build.py`` holds an exclusive ``flock`` on the build directory
  while it builds, so a second process waits.
"""

import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from exaspim_tpu.utils import profiling as jp
from exaspim_tpu_torch.utils import profiling as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


def test_device_memory_stats_keys_match_jax(monkeypatch):
    import jax

    assert tp.device_memory_stats() == {"cpu": None}  # no card here
    fake = types.SimpleNamespace(memory_stats=lambda: {
        "bytes_in_use": 5, "bytes_limit": 9, "peak_bytes_in_use": 7})
    monkeypatch.setattr(jax, "devices", lambda: [fake])
    theirs = next(iter(jp.device_memory_stats().values()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 100 + i)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=80 << 30))
    ours = tp.device_memory_stats()
    assert list(ours) == ["cuda:0", "cuda:1"]
    for i, v in enumerate(ours.values()):
        assert set(v) == set(theirs)
        assert v == {"bytes_in_use": 100 + i, "bytes_limit": 80 << 30}


def test_log_jsonl_and_step_timer_match_jax(tmp_path):
    recs = [{"event": "train", "step": 3, "loss": np.float32(0.25)},
            {"a": [1, 2], "b": None, "c": np.float64(1.5)}]
    for r in recs:
        tp.log_jsonl(tmp_path / "ours.jsonl", r)
        jp.log_jsonl(tmp_path / "theirs.jsonl", r)
    assert (tmp_path / "ours.jsonl").read_text() \
        == (tmp_path / "theirs.jsonl").read_text()
    ours, theirs = tp.StepTimer(100), jp.StepTimer(100)
    assert ours.step() is theirs.step() is None
    assert set(ours.step()) == set(theirs.step())


def test_trace_writes_a_chrome_trace(tmp_path):
    with tp.trace(tmp_path / "off", enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with tp.trace(tmp_path / "on") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())


@pytest.fixture(scope="module")
def val_dir(tmp_path_factory):
    from exaspim_tpu_torch.data.synthetic import make_synthetic_cache

    return make_synthetic_cache(
        str(tmp_path_factory.mktemp("val") / "v"), 6, (16, 16, 16), TCFG,
        seed=2)


def test_validate_host_matches_the_device_path(val_dir, tmp_path):
    from exaspim_tpu_torch.data.cache import CachedValidateDataset
    from exaspim_tpu_torch.data.loader import (
        DataLoader,
        make_count_val_collate,
    )
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train.state import (
        create_train_state,
        make_eval_step,
    )
    from exaspim_tpu_torch.train.trainer import Trainer
    from exaspim_tpu_torch.transforms import build_transform

    t = build_transform(TCFG)
    model = UNet(width_multiplier=0.25, head_init="normal")
    tr = Trainer(tmp_path, model, t, batch_size=4, keep_mips=5,
                 tensorboard=False, device="cpu",
                 checkpoint_weights={"fg_mae": 1.0, "bg_mae": 0.2,
                                     "top_pct_error": 0.5, "cratio": 10.0})
    state = create_train_state(model, lr=1e-3, total_steps=4, seed=0)
    eval_step = make_eval_step(0.0, transform=t)
    loader = DataLoader(CachedValidateDataset(val_dir), 4,
                        make_count_val_collate())
    dev = tr.validate(state, eval_step, loader, step=3)
    tr.val_device_metrics = False
    host = tr.validate(state, eval_step, loader, step=4)
    assert "val_cratio_proxy" in dev and "val_cratio_proxy" not in host
    assert set(dev) - {"val_cratio_proxy"} == set(host)
    assert dev["val_cratio"] == host["val_cratio"] > 0
    assert dev["val_loss"] == host["val_loss"]
    for k in host:
        np.testing.assert_allclose(dev[k], host[k], rtol=1e-5, err_msg=k)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(tr.mip_dir, "*.png")))
    assert names == [f"step{s:07d}_ex{i}.png" for s in (3, 4)
                     for i in range(5)]
    tr.max_val_examples = 3
    assert tr.validate(state, eval_step, loader, step=5).keys() == host.keys()


def test_build_lock_excludes_another_process(tmp_path, monkeypatch):
    from exaspim_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    probe = ("import fcntl, os, sys; fd = os.open(sys.argv[1], os.O_RDONLY)\n"
             "try:\n    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
             "except BlockingIOError:\n    print('held')\n"
             "else:\n    print('free')\n")

    def other():
        return subprocess.run([sys.executable, "-c", probe,
                               _build.BUILD_DIR], capture_output=True,
                              text=True, check=True).stdout.strip()

    with _build._build_lock():
        assert other() == "held"
    assert other() == "free"
    with _build._build_lock():  # taken again, in the same process
        pass
