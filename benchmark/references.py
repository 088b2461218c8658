"""The registry of the models' plain references: the reference of a
configuration's ``model_config["model"]`` is the module under
``reference/`` whose ``MODELS`` tuple holds the name, with
``forward(params, x, model_cfg, quant)`` (``x`` ``(B, 1, D, H, W)``
float32 in the transform domain; ``params`` flat names ``Conv_0/kernel``
to tensors; ``quant`` None, or a control's or witness's precision from
``reference/unet.py``). A new architecture adds one file under
``reference/`` and edits none. (The registry sits beside ``reference/``,
whose modules import nothing but the plain libraries.)
"""

from __future__ import annotations

import importlib
import importlib.util
import os

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference")


def _module(ref_dir, stem):
    """The package's own module where the file is one of the package's
    (so the precisions in ``unet.py`` are one class everywhere), else the
    file of the benchmark copy in use."""
    if os.path.exists(os.path.join(HERE, f"{stem}.py")):
        return importlib.import_module(f"benchmark.reference.{stem}")
    spec = importlib.util.spec_from_file_location(
        f"bench_reference_{stem}", os.path.join(ref_dir, f"{stem}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_model(model_cfg, bench_dir):
    """The reference module of ``model_cfg``'s model, from the benchmark
    directory ``bench_dir``; an unknown model raises ``LookupError``."""
    name = model_cfg["model"]
    ref_dir = os.path.join(bench_dir, "reference")
    for f in sorted(os.listdir(ref_dir)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, f)) as fh:
            if "MODELS" not in fh.read():
                continue
        mod = _module(ref_dir, f[:-3])
        if name in getattr(mod, "MODELS", ()):
            return mod
    raise LookupError(
        f"the benchmark has no plain reference of the model {name!r}: add "
        f"reference/<file>.py with MODELS = ({name!r},) and forward(params, "
        "x, model_cfg, quant)")
