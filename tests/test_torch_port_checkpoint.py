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
