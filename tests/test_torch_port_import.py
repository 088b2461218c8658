"""``import_torch_checkpoint`` and the new families' msgpack files against
exaspim_tpu.train.checkpoint.

The tests write reference-format checkpoints themselves with
``torch.save``, in the key layout that
``exaspim_tpu/train/checkpoint.py:162-214`` reads (``inc``,
``down{i}.maxpool_conv.1``, ``up{i}.conv``, ``up{i}.up``, ``outc.conv``;
N2V2's blur buffer under ``down1.maxpool_conv.0``), from seeded weights
with nonzero biases and asymmetric kernels:

* UNet trilinear and transposed-conv, N2V2UNet; the dict format (with
  ``model_config``) and the legacy bare state dict: the port's imported
  parameters are bit-equal to the JAX import's (both are transposes of
  f32), the inferred configurations equal, and the imported models'
  outputs agree within 1e-4 (f32, 24³);
* every error path raises in both: an unknown ``model_config`` key, a
  width that disagrees with the weights, a missing key;
* msgpack both ways: the port's ``out_path`` file restores through the JAX
  ``restore_pipeline`` and the JAX file through the port's, with outputs
  within 1e-4 and parameters bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.train.checkpoint import import_torch_checkpoint as jax_import
from exaspim_tpu.train.checkpoint import restore_pipeline as jax_restore
from exaspim_tpu_torch.models import N2V2UNet, UNet
from exaspim_tpu_torch.train.checkpoint import (
    import_torch_checkpoint,
    params_from_flax,
    params_to_flax,
    restore_pipeline,
)

OUT_ATOL = 1e-4
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


def _reference_sd(tree, trilinear, n2v2):
    """A Flax param tree → the reference's torch state dict (the inverse
    of the JAX import's ``_port_torch_state_dict``)."""
    sd = {}

    def dc(prefix, node):
        for i, (ci, gi) in enumerate(((0, 1), (3, 4))):
            conv, gn = node[f"Conv_{i}"], node[f"GroupNorm_{i}"]
            sd[f"{prefix}.{ci}.weight"] = conv["kernel"].transpose(
                4, 3, 0, 1, 2)
            sd[f"{prefix}.{ci}.bias"] = conv["bias"]
            sd[f"{prefix}.{gi}.weight"] = gn["scale"]
            sd[f"{prefix}.{gi}.bias"] = gn["bias"]

    dc("inc.double_conv", tree["DoubleConv_0"])
    for i in range(1, 5):
        dc(f"down{i}.maxpool_conv.1.double_conv", tree[f"DoubleConv_{i}"])
        up = tree[f"Up_{i - 1}"]
        dc(f"up{i}.conv.double_conv", up["DoubleConv_0"])
        if not trilinear:
            k = up["ConvTranspose_0"]["kernel"]
            sd[f"up{i}.up.weight"] = k[::-1, ::-1, ::-1].transpose(
                3, 4, 0, 1, 2)
            sd[f"up{i}.up.bias"] = up["ConvTranspose_0"]["bias"]
    sd["outc.conv.weight"] = tree["Conv_0"]["kernel"].transpose(4, 3, 0, 1, 2)
    sd["outc.conv.bias"] = tree["Conv_0"]["bias"]
    if n2v2:  # MaxBlurPool's persistent blur kernel, a buffer
        for i in range(1, 5):
            sd[f"down{i}.maxpool_conv.0.blur.kernel"] = np.full(
                (1, 1, 3, 3, 3), 1.0 / 27, np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _write(path, family, legacy, seed=0, **cfg_over):
    cls = N2V2UNet if family == "N2V2UNet" else UNet
    trilinear = cfg_over.pop("trilinear", True)
    model = cls(width_multiplier=0.25, trilinear=trilinear, conv_bias=True,
                head_init="normal").init_weights(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=gen)
    tree = params_to_flax(model.state_dict())
    sd = _reference_sd(tree, trilinear, family == "N2V2UNet")
    if legacy:
        obj = sd
    else:
        obj = {"model": sd, "transform": TCFG, "model_config": {
            "model": family, "width_multiplier": 0.25,
            "trilinear": trilinear, **cfg_over}}
    torch.save(obj, path)
    return path


def _apply_jax(model, params, x):
    return np.asarray(jax.jit(model.apply)({"params": params},
                                           jnp.asarray(x)))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family,trilinear,legacy", [
    ("UNet", True, False), ("UNet", False, True),
    ("N2V2UNet", True, True), ("N2V2UNet", False, False),
])
def test_import_matches_jax(tmp_path, family, trilinear, legacy):
    path = _write(str(tmp_path / "ref.pth"), family, legacy,
                  trilinear=trilinear)
    jm, jparams, jt = jax_import(path)
    model, t = import_torch_checkpoint(path, device="cpu")
    assert model.config == jm.config
    assert model.config["model"] == family
    assert model.config["trilinear"] is trilinear
    assert model.config["align_corners"] and model.config["conv_bias"]
    assert t.cfg == jt.cfg
    want = params_from_flax(jax.tree.map(np.asarray, jparams))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    x = np.random.default_rng(1).normal(0.5, 0.2, (1, 24, 24, 24, 1)).astype(
        np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, _apply_jax(jm, jparams, x),
                               atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("case,exc,match", [
    ("unknown key", ValueError, "unrecognized"),
    ("width", ValueError, "disagrees"),
    ("missing key", KeyError, "up2.conv.double_conv.3.bias"),
])
def test_import_errors_match_jax(tmp_path, case, exc, match):
    path = str(tmp_path / "bad.pth")
    if case == "unknown key":
        _write(path, "UNet", False, dropout=0.1)
    elif case == "width":
        _write(path, "UNet", False)
        ckpt = torch.load(path, weights_only=True)
        ckpt["model_config"]["width_multiplier"] = 0.5
        torch.save(ckpt, path)
    else:
        _write(path, "UNet", True)
        sd = torch.load(path, weights_only=True)
        del sd["up2.conv.double_conv.3.bias"]
        torch.save(sd, path)
    with pytest.raises(exc):
        jax_import(path)
    with pytest.raises(exc, match=match):
        import_torch_checkpoint(path, device="cpu")


@pytest.mark.parametrize("family,trilinear", [
    ("UNet", False), ("N2V2UNet", True)])
def test_msgpack_round_trips_between_packages(tmp_path, family, trilinear):
    path = _write(str(tmp_path / "ref.pth"), family, False,
                  trilinear=trilinear)
    ours, theirs = str(tmp_path / "port.msgpack"), str(
        tmp_path / "jax.msgpack")
    model, _ = import_torch_checkpoint(path, ours, device="cpu")
    jax_import(path, theirs)
    x = np.random.default_rng(2).normal(0.5, 0.2, (1, 24, 24, 24, 1)).astype(
        np.float32)
    # The port's file through the JAX package, and the other way round.
    jm, jparams, jt = jax_restore(ours, dtype=jnp.float32)
    back, t = restore_pipeline(theirs, dtype=torch.float32, device="cpu")
    assert jm.config == back.config == model.config
    assert jt.cfg == t.cfg == TCFG
    a, b = _leaves(jparams), _leaves(params_to_flax(back.state_dict()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with torch.no_grad():
        out = back(torch.from_numpy(x)).numpy()
        direct = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, direct)
    np.testing.assert_allclose(out, _apply_jax(jm, jparams, x),
                               atol=OUT_ATOL, rtol=0)


def test_import_entry_point(tmp_path, capsys):
    from exaspim_tpu_torch import import_torch_checkpoint as entry

    path = _write(str(tmp_path / "ref.pth"), "UNet", True, trilinear=False)
    dst = str(tmp_path / "out.msgpack")
    assert entry.main([path, dst, "--device", "cpu"]) == 0
    assert os.path.exists(dst)
    assert "'trilinear': False" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="reference package"):
        entry.main([path, dst, "--device", "cpu", "--verify"])
