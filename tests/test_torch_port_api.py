"""The port's public surface against the JAX package's.

* An AST scan of ``exaspim_tpu/__init__.py`` and the ``__init__`` of each
  sub-package (its ``__all__`` and the module each name is imported
  from): every name whose module is ported and defines it is in the
  port's ``__all__`` of the same package and resolves there. The names
  still to port are exactly the list below (ROADMAP §1).
* ``import exaspim_tpu_torch`` imports neither torch nor a sub-package;
  its lazy names are the sub-modules' objects.
* ``exaspim_tpu_torch.config`` round-trips JSON with the JAX package's
  ``exaspim_tpu.config`` both ways (fields, defaults, unknown keys);
  ``train_bm4dnet --config-json`` calls ``train`` with the arguments the
  JAX script passes, and the CLI flags with the script's.
* ``ckpt_average`` writes what ``scripts/ckpt_average.py`` writes:
  params bit-equal, the same meta; a config mismatch raises in both.
* The scan of ``test_torch_port_inference.py`` (no JAX import) covers this
  slice's modules.
"""

import ast
import dataclasses
import importlib
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from exaspim_tpu import config as jax_config
from exaspim_tpu.train.checkpoint import load_checkpoint as jax_load
from exaspim_tpu.train.checkpoint import save_checkpoint as jax_save
from exaspim_tpu_torch import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("", "ops", "data", "train", "models", "compression", "utils",
            "parallel")

#: reference names whose function is not ported yet (ROADMAP.md §1).
NOT_PORTED = set()


def _init(pkg, sub):
    return os.path.join(ROOT, pkg, sub, "__init__.py")


def _reference_names(sub):
    """``{name: (module, attribute)}`` of the reference package's
    ``__all__``: where each name is imported from and under which name it
    is defined there (``import available as jxl_available``; the lazy
    table at the top level)."""
    tree = ast.parse(open(_init("exaspim_tpu", sub)).read())
    origin = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                origin[a.asname or a.name] = (node.module, a.name)
        if isinstance(node, ast.Dict):  # the top level's lazy table
            for k, v in zip(node.keys, node.values):
                if isinstance(v, ast.Tuple):
                    origin[k.value] = (v.elts[0].value, v.elts[1].value)
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names = ast.literal_eval(node.value)
    if not sub:
        names = list(origin)
    return {n: origin[n] for n in names}


def _defines(origin):
    """Whether the port's counterpart of the ``(module, attribute)``
    ``origin`` exists and defines the attribute (or re-exports it from a
    sub-module)."""
    module, name = origin
    rel = module.replace("exaspim_tpu", "exaspim_tpu_torch", 1).split(".")
    base = os.path.join(ROOT, *rel)
    path = base + ".py" if os.path.exists(base + ".py") else os.path.join(
        base, "__init__.py")
    if not os.path.exists(path):
        return False
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == name:
            return True
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return True
        if isinstance(node, ast.ImportFrom) and any(
                (a.asname or a.name) == name for a in node.names):
            return True
    return False


@pytest.mark.parametrize("sub", PACKAGES)
def test_ported_names_are_exported(sub):
    pkg = importlib.import_module(
        "exaspim_tpu_torch" + (f".{sub}" if sub else ""))
    missing, left = [], set()
    for name, origin in _reference_names(sub).items():
        if _defines(origin):
            if name not in pkg.__all__:
                missing.append(name)
            getattr(pkg, name)
        else:
            left.add(name)
    assert not missing, missing
    assert left <= NOT_PORTED, left - NOT_PORTED
    for name in pkg.__all__:
        getattr(pkg, name)


def test_not_ported_list_is_current():
    left = set()
    for sub in PACKAGES:
        left |= {n for n, o in _reference_names(sub).items()
                 if not _defines(o)}
    assert left == NOT_PORTED


def test_top_level_import_stays_light():
    code = ("import sys, exaspim_tpu_torch as t; "
            "assert 'torch' not in sys.modules, 'torch'; "
            "assert not [m for m in sys.modules "
            "if m.startswith('exaspim_tpu_torch.')]; print(t.__all__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert "predict" in out
    import exaspim_tpu_torch as t
    from exaspim_tpu_torch import inference, ops, train

    assert t.predict is inference.predict and t.bm4d is ops.bm4d
    assert t.Trainer is train.Trainer
    assert sorted(t.__all__) == sorted(_reference_names("").keys()
                                       - NOT_PORTED)


@pytest.mark.parametrize("cls,over", [
    ("PrecomputeConfig", {"n": 5, "patch": (32, 32, 32), "out_dir": "/c"}),
    ("TrainConfig", {"train_cache": ["/t"], "epochs": 3, "resume": "/r"}),
    ("EvaluateConfig", {"ckpt": "/k", "crop_shape": (8, 8, 8)}),
])
def test_config_round_trips_with_jax(cls, over, tmp_path):
    ours, theirs = getattr(port_config, cls), getattr(jax_config, cls)
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
        (f.name, f.default) for f in dataclasses.fields(theirs)]
    assert ours().to_dict() == theirs().to_dict()
    a = ours().replace(**over).to_json(str(tmp_path / "port.json"))
    b = theirs().replace(**over).to_json(str(tmp_path / "jax.json"))
    with open(a) as f, open(b) as g:
        assert f.read() == g.read()
    assert ours.from_json(b).to_dict() == theirs.from_json(a).to_dict()
    assert ours.from_json(a) == ours.from_json(b)
    with pytest.raises(ValueError, match="unknown"):
        ours.from_dict({"no_such_key": 1})
    with pytest.raises(ValueError, match="unknown"):
        ours().replace(no_such_key=1)


def _load_script(name):
    scripts = os.path.join(ROOT, "scripts")
    sys.path.insert(0, scripts)
    try:
        spec = importlib.util.spec_from_file_location(
            f"{name}_script", os.path.join(scripts, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(scripts)


def _calls(module, argv, monkeypatch):
    seen = []
    monkeypatch.setattr(module, "train",
                        lambda *a, **kw: seen.append((a, kw)))
    module.main(argv)
    return seen


@pytest.mark.parametrize("mode", ["config-json", "flags"])
def test_train_cli_calls_train_as_the_jax_script(mode, tmp_path,
                                                 monkeypatch):
    from exaspim_tpu_torch.train import train_bm4dnet

    cfg = jax_config.TrainConfig(
        train_cache=["/c/t"], val_cache=["/c/v"], output_dir="/o",
        epochs=3, batch_size=8, lr=5e-4, fg_weight=2.0, val_every=7,
        seed=11, width_multiplier=0.5, bf16=False, resume="/r.ckpt",
        checkpoint_weights={"fg_mae": 1.0, "cratio": 3.0})
    if mode == "config-json":
        argv = ["--config-json", cfg.to_json(str(tmp_path / "c.json")),
                "--epochs", "99"]
    else:
        argv = ["--train-cache", "/c/t", "/c/t2", "--val-cache", "/c/v",
                "--out", "/o", "--epochs", "3", "--batch-size", "8",
                "--loss-eps", "0.01", "--augment", "--full-state-every",
                "4", "--device-cache", "on", "--max-val-examples", "5",
                "--no-bf16"]
    (want,) = _calls(_load_script("train_bm4dnet"), argv, monkeypatch)
    port_only = ["--exact-cratio-examples", "0", "--device", "cpu"]
    (got,) = _calls(train_bm4dnet, argv + port_only, monkeypatch)
    assert got[0] == want[0]
    extra = {k: got[1].pop(k) for k in ("exact_cratio_examples", "device")}
    assert extra == {"exact_cratio_examples": 0, "device": "cpu"}
    assert got[1] == want[1]


def _checkpoints(tmp_path, n, **over):
    rng = np.random.default_rng(0)
    cfg = {"model": "UNet", "width_multiplier": 0.25}
    tcfg = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
    paths = []
    for i in range(n):
        params = {"Conv_0": {"kernel": rng.normal(size=(1, 1, 1, 8, 1))
                             .astype(np.float32),
                             "bias": rng.normal(size=(1,)).astype(np.float32)},
                  "count": np.asarray(i + 3, np.int32)}
        paths.append(jax_save(
            str(tmp_path / f"in{i}.ckpt"), params,
            over.get("cfg", cfg) if i == n - 1 else cfg, tcfg, step=10 * i,
            score=0.5 * i if i else None))
    return paths


def test_ckpt_average_matches_the_script(tmp_path):
    from exaspim_tpu_torch import ckpt_average

    ins = _checkpoints(tmp_path, 3)
    _load_script("ckpt_average").main([str(tmp_path / "jax.ckpt")] + ins)
    ckpt_average.main([str(tmp_path / "port.ckpt")] + ins)
    want, got = jax_load(str(tmp_path / "jax.ckpt")), jax_load(
        str(tmp_path / "port.ckpt"))
    assert {k: v for k, v in got.items() if k != "params"} == {
        k: v for k, v in want.items() if k != "params"}
    assert got["step"] == 20 and got["extra"]["averaged_from"] == [
        "in0.ckpt", "in1.ckpt", "in2.ckpt"]
    lw = jax.tree_util.tree_flatten_with_path(want["params"])[0]
    lg = jax.tree_util.tree_flatten_with_path(got["params"])[0]
    assert [k for k, _ in lg] == [k for k, _ in lw]
    for (k, a), (_, b) in zip(lg, lw):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["params"]["count"], 3)


def test_ckpt_average_rejects_a_config_mismatch(tmp_path):
    from exaspim_tpu_torch import ckpt_average

    ins = _checkpoints(tmp_path, 2, cfg={"model": "UNet",
                                         "width_multiplier": 0.5})
    for run in (_load_script("ckpt_average").main, ckpt_average.main):
        with pytest.raises(ValueError, match="disagrees"):
            run([str(tmp_path / "out.ckpt")] + ins)


def test_no_jax_scan_covers_this_slice():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from test_torch_port_inference import _port_files
    finally:
        sys.path.pop(0)
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("config.py", "ckpt_average.py", "demo_end_to_end.py",
                "ops/metrics.py", "train/checkpoint.py", "train/state.py",
                "__init__.py", "ops/__init__.py", "train/__init__.py"):
        assert os.path.join("exaspim_tpu_torch", rel) in names, rel


def test_new_entry_points_default_to_the_card(tmp_path):
    import inspect

    from exaspim_tpu_torch import demo_end_to_end
    from exaspim_tpu_torch.train import Trainer, train_bm4dnet

    for fn in (demo_end_to_end.score_checkpoint, train_bm4dnet.train,
               Trainer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    seen = {}

    def stop(out, **kw):
        seen.update(kw)
        raise SystemExit

    import exaspim_tpu_torch.data.precompute as pre

    with pytest.MonkeyPatch.context() as m:
        m.setattr(demo_end_to_end.torch.cuda, "is_available", lambda: True)
        m.setattr(pre, "precompute", stop)
        with pytest.raises(SystemExit):
            demo_end_to_end.main(["--out", str(tmp_path / "demo")])
    assert seen["device"] == "cuda"
    with pytest.MonkeyPatch.context() as m:
        m.setattr(demo_end_to_end.torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--device cpu"):
            demo_end_to_end.main(["--out", str(tmp_path / "unused")])
