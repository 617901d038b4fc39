"""The port's ``models/caffe_io.py`` against the JAX package's.

The protobuf wire functions are copies, held source-equal here. A
``.caffemodel`` written by the JAX package loads into the port's SegNet
state, both writers give the same bytes for one tree, and a standard
network loaded from one file in both packages gives the same posterior
at 32x64. ``merge_params`` (ported without ``jax.tree.map``) keeps the
JAX package's shape check, and a Git-LFS pointer stub made here raises
the JAX package's ``ValueError``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sivo_tpu.models import caffe_io as j_io
from sivo_tpu.models import segnet as j_seg
from sivo_tpu_torch.models import caffe_io as t_io
from sivo_tpu_torch.models import segnet as t_seg

torch.set_num_threads(2)
H, W = 32, 64
WIRE_COPIES = ("_read_varint", "_fields", "_parse_blob", "parse_caffemodel",
               "conv_to_flax", "bn_to_flax", "load_segnet_params", "_varint",
               "_ld", "_encode_blob", "_encode_layer", "save_segnet_params")
LFS_STUB = (b"version https://git-lfs.github.com/spec/v1\n"
            b"oid sha256:4d7a214614ab2935c943f9e0ff69d22eadbb8f32b1258daaa5e2"
            b"ca24d17e2393\nsize 118221540\n")


@pytest.mark.parametrize("name", WIRE_COPIES)
def test_wire_function_source_equal(name):
    assert (inspect.getsource(getattr(t_io, name))
            == inspect.getsource(getattr(j_io, name)))


@pytest.fixture(scope="module")
def standard_tree():
    """The Flax standard variant's tree at 32x64 with BN statistics away
    from their defaults, as numpy arrays."""
    model = j_seg.SegNet(variant="standard")
    tree = jax.tree.map(np.asarray,
                        j_seg.init_params(model, jax.random.key(2), H, W))
    rng = np.random.default_rng(0)
    for name, leaf in tree["params"].items():
        if name.endswith("_bn"):
            c = leaf["scale"].shape[0]
            leaf["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            leaf["shift"] = rng.normal(0, 0.1, c).astype(np.float32)
            leaf["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            leaf["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        else:
            leaf["bias"] = rng.normal(0, 0.01, leaf["bias"].shape).astype(
                np.float32)
    return tree


def test_jax_written_file_loads_in_the_port(standard_tree, tmp_path):
    path = str(tmp_path / "jax.caffemodel")
    j_io.save_segnet_params(path, standard_tree)
    init = t_seg.init_params(1, variant="standard")
    state = t_io.state_dict_from_caffemodel(path, "standard", init)
    want = t_seg.params_from_flax(standard_tree)
    assert state.keys() == want.keys() == init.keys()
    for k, v in want.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_both_writers_give_equal_bytes(standard_tree, tmp_path):
    port_tree = t_seg.flax_from_params(t_seg.init_params(0, variant="basic"))
    for label, tree in (("flax", standard_tree), ("port", port_tree)):
        j_path, t_path = tmp_path / f"j_{label}", tmp_path / f"t_{label}"
        j_io.save_segnet_params(str(j_path), tree)
        t_io.save_segnet_params(str(t_path), tree)
        assert j_path.read_bytes() == t_path.read_bytes()


def test_port_weights_round_trip_through_a_file(tmp_path):
    state = t_seg.init_params(3, variant="standard")
    state["bns.conv2_1_bn.var"] = state["bns.conv2_1_bn.var"] * 1.5
    path = str(tmp_path / "port.caffemodel")
    t_io.save_segnet_params(path, t_seg.flax_from_params(state))
    back = t_io.state_dict_from_caffemodel(
        path, "standard", t_seg.init_params(4, variant="standard"))
    for k, v in state.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_one_file_gives_the_same_posterior(standard_tree, tmp_path):
    path = str(tmp_path / "standard.caffemodel")
    j_io.save_segnet_params(path, standard_tree)
    j_model = j_seg.SegNet(variant="standard")
    j_params = j_io.merge_params(
        j_seg.init_params(j_model, jax.random.key(0), H, W),
        j_io.load_segnet_params(path, "standard"))
    t_model = t_seg.SegNet(variant="standard", dtype=torch.float32)
    t_model.load_state_dict(t_io.state_dict_from_caffemodel(
        path, "standard", t_seg.init_params(0, variant="standard")))
    img = np.random.default_rng(6).uniform(0, 255, (H, W, 3)).astype(
        np.float32)
    probs_j = j_model.apply(j_params, jnp.asarray(img), train=False)
    cls_j, conf_j, ent_j = (np.asarray(x) for x in j_seg.posterior(probs_j))
    with torch.no_grad():
        cls_t, conf_t, ent_t = t_seg.posterior(
            t_model(torch.from_numpy(img)))
    np.testing.assert_array_equal(cls_t.numpy(), cls_j)
    np.testing.assert_allclose(conf_t.numpy(), conf_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ent_t.numpy(), ent_j, rtol=0, atol=1e-4)


def test_shape_mismatch_raises_the_jax_error(tmp_path):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(32, 3, 5, 5)).astype(np.float32)  # wrong shape
    path = str(tmp_path / "bad.caffemodel")
    t_io.save_segnet_params(path, {"params": {"conv1_1": t_io.conv_to_flax(
        w, None)}})
    j_init = j_seg.init_params(j_seg.SegNet(variant="standard"),
                               jax.random.key(0), H, W)
    with pytest.raises(ValueError) as j_err:
        j_io.merge_params(j_init, j_io.load_segnet_params(path, "standard"))
    with pytest.raises(ValueError, match="caffemodel shape") as t_err:
        t_io.state_dict_from_caffemodel(
            path, "standard", t_seg.init_params(0, variant="standard"))
    assert str(t_err.value) == str(j_err.value)


def test_lfs_stub_raises(tmp_path):
    path = tmp_path / "stub.caffemodel"
    path.write_bytes(LFS_STUB)
    with pytest.raises(ValueError, match="Git-LFS") as t_err:
        t_io.state_dict_from_caffemodel(str(path), "basic",
                                        t_seg.init_params(0))
    with pytest.raises(ValueError) as j_err:
        j_io.parse_caffemodel(LFS_STUB)
    assert str(t_err.value) == str(j_err.value)


def test_merge_keeps_missing_layers_and_the_init_tree():
    init = t_seg.flax_from_params(t_seg.init_params(0))
    before = {n: {k: v.copy() for k, v in s.items()}
              for n, s in init["params"].items()}
    new_w = np.full_like(init["params"]["conv2"]["kernel"], 0.25)
    merged = t_io.merge_params(init, {"params": {
        "conv2": {"kernel": new_w}, "not_a_layer": {"kernel": new_w}}})
    np.testing.assert_array_equal(merged["params"]["conv2"]["kernel"], new_w)
    assert "not_a_layer" not in merged["params"]
    for name, sub in before.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(init["params"][name][k], v)
            if (name, k) != ("conv2", "kernel"):
                np.testing.assert_array_equal(merged["params"][name][k], v)
