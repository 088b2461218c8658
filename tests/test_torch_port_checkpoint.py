"""The port's msgpack reader and weight mapping against the Flax loader.

The shipped checkpoint must decode to the same tree, every array
bit-equal, as ``exaspim_tpu.train.checkpoint.load_checkpoint``; and
``params_from_flax`` must carry every leaf into the port's modules.
"""

import os

import jax
import numpy as np
import pytest
import torch

from exaspim_tpu.train.checkpoint import load_checkpoint as jax_load
from exaspim_tpu_torch._msgpack import unpackb
from exaspim_tpu_torch.models import build_model
from exaspim_tpu_torch.train.checkpoint import (
    load_checkpoint,
    params_from_flax,
)

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "bm4dnet.msgpack")


@pytest.fixture(scope="module")
def both():
    return jax_load(CKPT), load_checkpoint(CKPT)


def _leaves(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_checkpoint_tree_bit_equal(both):
    ref, got = both
    assert {k: v for k, v in got.items() if k != "params"} == {
        k: v for k, v in ref.items() if k != "params"}
    lr, lg = _leaves(ref["params"]), _leaves(got["params"])
    assert lr.keys() == lg.keys()
    for k in lr:
        assert lg[k].dtype == lr[k].dtype and lg[k].shape == lr[k].shape, k
        np.testing.assert_array_equal(lg[k], lr[k], err_msg=k)


def test_msgpack_scalars():
    # fixmap{"a": [nil, true, false, -1, 300, 1.5, "xy", bin"\x01"]}
    blob = (b"\x81\xa1a\x98\xc0\xc3\xc2\xff\xcd\x01\x2c"
            b"\xcb\x3f\xf8\x00\x00\x00\x00\x00\x00\xa2xy\xc4\x01\x01")
    assert unpackb(blob) == {"a": [None, True, False, -1, 300, 1.5, "xy",
                                   b"\x01"]}
    with pytest.raises(ValueError):
        unpackb(blob + b"\x00")


def test_params_from_flax_roundtrips_every_leaf(both):
    _, got = both
    model = build_model(got["model_config"], dtype=torch.float32,
                        device="cpu")
    sd = params_from_flax(got["params"])
    model.load_state_dict(sd)  # strict: every key, every shape
    msd = model.state_dict()
    for k, leaf in _leaves(got["params"]).items():
        name = k.strip("[]'").replace("']['", ".")
        np.testing.assert_array_equal(
            msd[name].numpy().reshape(leaf.shape), leaf, err_msg=name)


def test_packb_writes_what_flax_reads():
    from flax.serialization import msgpack_restore

    from exaspim_tpu_torch._msgpack import packb

    obj = {"a": [None, True, False, -1, 300, -200, 70000, 2 ** 40, 1.5,
                 "xy", "z" * 300, b"\x01"],
           "arr": np.arange(12, dtype=np.float32).reshape(3, 4),
           "empty": np.zeros((0, 2), np.float32),
           "many": {str(i): i for i in range(20)}}
    blob = packb(obj)
    for back in (msgpack_restore(blob), unpackb(blob)):
        assert back["a"] == obj["a"] and back["many"] == obj["many"]
        np.testing.assert_array_equal(back["arr"], obj["arr"])
        assert back["empty"].shape == (0, 2)


def test_params_to_flax_inverts_params_from_flax(both):
    from exaspim_tpu_torch.train.checkpoint import params_to_flax

    _, got = both
    back = params_to_flax(params_from_flax(got["params"]))
    lr, lg = _leaves(got["params"]), _leaves(back)
    assert lr.keys() == lg.keys()
    for k in lr:
        assert lg[k].dtype == np.float32 and lg[k].shape == lr[k].shape, k
        np.testing.assert_array_equal(lg[k], lr[k], err_msg=k)


def test_saved_checkpoint_loads_in_jax(tmp_path):
    import jax.numpy as jnp

    from exaspim_tpu.models import build_model as jax_build
    from exaspim_tpu.train.checkpoint import checkpoint_filename as jfn
    from exaspim_tpu.train.checkpoint import find_best_checkpoint as jbest
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train.checkpoint import (
        checkpoint_filename,
        find_best_checkpoint,
        save_checkpoint,
    )

    model = UNet(width_multiplier=0.25, head_init="normal").init_weights(3)
    tcfg = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
    assert checkpoint_filename(12, -1.5, "20260101") == jfn(12, -1.5,
                                                            "20260101")
    for step, score in ((4, 2.25), (8, -0.5)):
        path = save_checkpoint(
            str(tmp_path / checkpoint_filename(step, score)),
            model.state_dict(), model.config, tcfg, step=step, score=score,
            extra={"metrics": {"val_loss": 0.1}})
    assert find_best_checkpoint(str(tmp_path)) == jbest(str(tmp_path)) == path
    ckpt = jax_load(path)
    assert ckpt["format"] == "exaspim_tpu.ckpt.v1" and ckpt["step"] == 8
    assert ckpt["model_config"] == model.config and ckpt["transform"] == tcfg
    x = np.random.default_rng(0).normal(0.4, 0.1, (1, 16, 16, 16, 1)).astype(
        np.float32)
    want = jax_build(ckpt["model_config"]).apply({"params": ckpt["params"]},
                                                 jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
