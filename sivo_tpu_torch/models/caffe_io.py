"""Caffe ``.caffemodel`` reading and writing for the port's SegNet (port
of ``sivo_tpu/models/caffe_io.py``).

The protobuf wire code (``_read_varint`` .. ``save_segnet_params``) is a
copy of the JAX package's, function for function
(``tests/test_torch_caffe_io.py`` holds the sources equal): a
``.caffemodel`` is parsed into the Flax-layout numpy tree (HWIO kernels,
``<conv>_bn`` Caffe BN leaves) and written back from one.
``merge_params`` overlays a loaded tree on an initial one by hand (the
JAX package's uses ``jax.tree.map``), and ``state_dict_from_caffemodel``
carries a file into this package's ``SegNet`` state dict, so one
``.caffemodel`` gives the same network in both packages.

Wire-format fields used (caffe.proto):
  NetParameter:   name=1 (string), layers=2 (V1LayerParameter),
                  layer=100 (LayerParameter)
  LayerParameter: name=1 (string), type=2 (string), blobs=7 (BlobProto)
  V1LayerParameter: name=4 (string), type=5 (enum), blobs=6 (BlobProto)
  BlobProto:      num=1 ch=2 h=3 w=4 (int), data=5 (packed float),
                  shape=7 (BlobShape{dim=1 repeated int64}),
                  double_data=8 (packed double)
"""

from __future__ import annotations

import struct
from typing import Any, Iterator

import numpy as np
import torch

from sivo_tpu_torch.models import segnet as segnet_mod


# ---------------------------------------------------------------------------
# minimal protobuf wire decoding
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wtype, val
        elif wtype == 1:  # 64-bit
            yield field, wtype, buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wtype, buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            yield field, wtype, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")


def _parse_blob(buf: bytes) -> np.ndarray:
    shape: list[int] = []
    legacy = {}
    data: np.ndarray | None = None
    for field, wtype, val in _fields(buf):
        if field == 7 and wtype == 2:  # BlobShape
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    if w2 == 0:
                        shape.append(int(v2))
                    elif w2 == 2:  # packed
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            shape.append(d)
        elif field in (1, 2, 3, 4) and wtype == 0:
            legacy[field] = int(val)
        elif field == 5:  # float data
            if wtype == 2:  # packed
                data = np.frombuffer(val, dtype="<f4").copy()
            elif wtype == 5:
                d = struct.unpack("<f", val)[0]
                data = (
                    np.append(data, d) if data is not None
                    else np.array([d], np.float32)
                )
        elif field == 8 and wtype == 2:  # double data
            data = np.frombuffer(val, dtype="<f8").astype(np.float32)
    if data is None:
        data = np.zeros(0, np.float32)
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == data.size:
        data = data.reshape(shape)
    return data


def parse_caffemodel(raw: bytes) -> dict[str, list[np.ndarray]]:
    """NetParameter bytes -> {layer_name: [blobs...]}."""
    if raw.startswith(b"version https://git-lfs"):
        raise ValueError(
            "this .caffemodel is a Git-LFS pointer stub, not real weights "
            "(the reference checkout ships stubs; see BASELINE.md)"
        )
    layers: dict[str, list[np.ndarray]] = {}
    for field, wtype, val in _fields(raw):
        if field == 100 and wtype == 2:  # LayerParameter
            name = ""
            blobs = []
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    name = v2.decode("utf-8", "replace")
                elif f2 == 7 and w2 == 2:
                    blobs.append(_parse_blob(v2))
            if blobs:
                layers[name] = blobs
        elif field == 2 and wtype == 2:  # V1LayerParameter
            name = ""
            blobs = []
            for f2, w2, v2 in _fields(val):
                if f2 == 4 and w2 == 2:
                    name = v2.decode("utf-8", "replace")
                elif f2 == 6 and w2 == 2:
                    blobs.append(_parse_blob(v2))
            if blobs:
                layers[name] = blobs
    return layers


# ---------------------------------------------------------------------------
# mapping onto the Flax SegNet parameter tree
# ---------------------------------------------------------------------------


def conv_to_flax(w: np.ndarray, b: np.ndarray | None) -> dict[str, Any]:
    """Caffe conv blob (O, I, KH, KW) -> flax {'kernel': (KH, KW, I, O),
    'bias': (O,)}."""
    kernel = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
    out = {"kernel": kernel}
    out["bias"] = (
        b.reshape(-1).astype(np.float32)
        if b is not None
        else np.zeros(kernel.shape[-1], np.float32)
    )
    return out


def bn_to_flax(blobs: list[np.ndarray]) -> dict[str, Any]:
    """Caffe SegNet 'BN' layer blobs -> CaffeBN params.

    The SegNet fork stores scale and shift (2 blobs). Merged-BN weights
    (README.md:90) keep stats folded, so mean=0/var=1; 4-blob variants
    (scale, shift, mean, var) load fully.
    """
    c = blobs[0].reshape(-1).shape[0]
    out = {
        "scale": blobs[0].reshape(-1).astype(np.float32),
        "shift": (
            blobs[1].reshape(-1).astype(np.float32)
            if len(blobs) > 1
            else np.zeros(c, np.float32)
        ),
        "mean": np.zeros(c, np.float32),
        "var": np.ones(c, np.float32),
    }
    if len(blobs) >= 4:
        out["mean"] = blobs[2].reshape(-1).astype(np.float32)
        out["var"] = blobs[3].reshape(-1).astype(np.float32)
    return out


def load_segnet_params(
    path: str, variant: str = "basic"
) -> dict[str, Any]:
    """Read a .caffemodel and produce the params pytree for
    ``sivo_tpu.models.segnet.SegNet(variant=...)``. Layer names map
    1:1 (conv layers keep their prototxt names; BN layers land in
    '<conv>_bn' CaffeBN modules)."""
    with open(path, "rb") as f:
        layers = parse_caffemodel(f.read())
    params: dict[str, Any] = {}
    for name, blobs in layers.items():
        if name.endswith("_bn"):
            params[name] = bn_to_flax(blobs)
        elif blobs and blobs[0].ndim == 4:
            params[name] = conv_to_flax(
                blobs[0], blobs[1] if len(blobs) > 1 else None
            )
    return {"params": params}


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding (writer — the inverse of the loader)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _encode_blob(arr: np.ndarray) -> bytes:
    """BlobProto: shape (field 7, BlobShape with packed dims) + packed
    float data (field 5)."""
    arr = np.asarray(arr, np.float32)
    dims = b"".join(_varint(int(d)) for d in arr.shape)
    shape_msg = _ld(1, dims) if arr.ndim else b""
    return _ld(7, shape_msg) + _ld(5, arr.reshape(-1).tobytes())


def _encode_layer(
    name: str, type_: str, blobs: list[np.ndarray]
) -> bytes:
    msg = _ld(1, name.encode()) + _ld(2, type_.encode())
    for b in blobs:
        msg += _ld(7, _encode_blob(b))
    return msg


def save_segnet_params(path: str, params: dict[str, Any]) -> None:
    """Write a SegNet params pytree as a .caffemodel (NetParameter with
    LayerParameter entries, the inverse of ``load_segnet_params``).

    The reference only LOADS caffemodels (bayesian_segnet.cpp:59-61);
    this writer exists so a net trained in this framework round-trips
    through the reference's weight format (conv kernels transposed back
    to Caffe's (O, I, KH, KW); CaffeBN written in the 4-blob
    scale/shift/mean/var form so running stats survive)."""
    tree = params.get("params", params)
    out = b""
    for name, sub in tree.items():
        if "kernel" in sub:
            w = np.transpose(np.asarray(sub["kernel"]), (3, 2, 0, 1))
            blobs = [w]
            if "bias" in sub:
                blobs.append(np.asarray(sub["bias"]).reshape(-1))
            out += _ld(100, _encode_layer(name, "Convolution", blobs))
        elif "scale" in sub:
            blobs = [
                np.asarray(sub[k]).reshape(-1)
                for k in ("scale", "shift", "mean", "var")
            ]
            out += _ld(100, _encode_layer(name, "BN", blobs))
    with open(path, "wb") as f:
        f.write(out)


def merge_params(
    init_params: dict[str, Any], loaded: dict[str, Any]
) -> dict[str, Any]:
    """Overlay loaded weights onto an init tree (shape-checked); layers
    missing from the caffemodel keep their initialization. The init
    tree is copied, not changed."""
    out = {"params": {name: {k: np.array(v) for k, v in sub.items()}
                      for name, sub in init_params["params"].items()}}
    tgt = out["params"]
    src = loaded["params"]
    for name, sub in src.items():
        if name not in tgt:
            continue
        for k, v in sub.items():
            if k in tgt[name]:
                cur = np.asarray(tgt[name][k])
                if cur.shape != v.shape:
                    raise ValueError(
                        f"{name}/{k}: caffemodel shape {v.shape} != "
                        f"model shape {cur.shape}"
                    )
                tgt[name][k] = v
    return out


def state_dict_from_caffemodel(
    path: str, variant: str, init_state: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """A ``.caffemodel`` as a ``segnet.SegNet(variant)`` state dict:
    load, overlay on ``init_state`` (layers the file lacks keep it), and
    convert. Raises ``ValueError`` on a Git-LFS stub or a shape that
    does not fit the variant."""
    init = segnet_mod.flax_from_params(init_state)
    merged = merge_params(init, load_segnet_params(path, variant))
    return segnet_mod.params_from_flax(merged)
