"""Hugging Face model directories without the ``transformers`` or
``safetensors`` packages: ``config.json``, the ``model.safetensors`` layout
(read and written here byte for byte) and ``pytorch_model.bin``.

A ``.safetensors`` file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
(offsets into the data that follows the header; an optional
``__metadata__`` entry) padded with spaces to a multiple of 8 bytes, then
the raw little-endian tensors.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Union

import torch

PathLike = Union[str, Path]

SAFETENSORS = "model.safetensors"
TORCH_BIN = "pytorch_model.bin"
# the dtypes a text tower's file carries: its float weights, and the integer
# ``position_ids`` buffers older exports saved beside them
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64, "I32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_config(model_dir: PathLike) -> dict:
    """``config.json`` of a model directory; raises naming the file."""
    path = Path(model_dir) / "config.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: not a Hugging Face model directory")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_safetensors(path: PathLike) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    data = bytearray(Path(path).read_bytes())
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, entry in header.items():
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}, not one of "
                             f"{sorted(_DTYPES)}")
        begin, end = entry["data_offsets"]
        shape = [int(s) for s in entry["shape"]]
        count = 1
        for s in shape:
            count *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > len(data):
            raise ValueError(f"{path}: {name} holds bytes {begin}..{end}, which do not fit "
                             f"shape {shape} of {entry['dtype']}")
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=base + begin) if count \
            else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(path: PathLike, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` in the ``.safetensors`` layout (sorted by name,
    packed back to back)."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be written")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in chunks:
            f.write(raw)


def read_state_dict(model_dir: PathLike) -> Dict[str, torch.Tensor]:
    """The weights of a model directory: ``model.safetensors``, else
    ``pytorch_model.bin`` (``torch.load`` with ``weights_only=True``)."""
    model_dir = Path(model_dir)
    if (model_dir / SAFETENSORS).is_file():
        return read_safetensors(model_dir / SAFETENSORS)
    if (model_dir / TORCH_BIN).is_file():
        return torch.load(model_dir / TORCH_BIN, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{model_dir}: neither {SAFETENSORS} nor {TORCH_BIN} found")
