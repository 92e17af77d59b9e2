"""Read and write the safetensors format without the ``safetensors`` package.

A file is an 8-byte little-endian header length ``n``, then ``n`` bytes of
JSON mapping each tensor's name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets into the data that follows; an optional
``"__metadata__"`` entry maps strings to strings), then one raw buffer of
the tensors' bytes, little-endian and C-ordered. The writer pads the header
with spaces to a multiple of 8 bytes, as the reference writer does.

Tensors come back as torch tensors. The reader maps the file
(``np.memmap``) and copies each tensor out of the mapping once
(``torch.frombuffer`` on its bytes), so a multi-GB checkpoint is never read
whole into one Python ``bytes``. BF16 travels as its 16-bit pattern.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _read_header(path: str):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read_metadata(path: str) -> Dict[str, str]:
    """The file's ``__metadata__`` (empty when absent)."""
    return dict(_read_header(path)[0].get("__metadata__", {}))


def load_file(path: str, device: str = "cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of the file, in header order, on ``device``."""
    header, start = _read_header(path)
    size = os.path.getsize(path)
    mapped = np.memmap(path, dtype=np.uint8, mode="r") if size > start else np.empty(0, np.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']!r}")
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= size - start:
            raise ValueError(f"{path}: tensor {name!r} has data offsets {begin, end} past the file's end")
        itemsize = torch.empty((), dtype=dtype).element_size()
        if (end - begin) != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} does not fill {end - begin} bytes")
        raw = mapped[start + begin : start + end]
        if end == begin:
            tensor = torch.empty(shape, dtype=dtype)
        else:
            tensor = torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)
        out[name] = tensor.to(device)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str, metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays; non-contiguous ones
    are copied) to ``path``, through a temporary file in its directory."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    prepared = []
    offset = 0
    for name, value in tensors.items():
        t = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value.detach()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype}")
        t = t.cpu().contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        prepared.append(t)
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in prepared:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)
