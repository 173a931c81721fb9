"""Read and write the safetensors file format without the `safetensors`
package: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`, offsets relative to the end of the header), then the raw
little-endian buffers."""

from __future__ import annotations

import json
import struct

import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """name -> CPU tensor (a copy) for every tensor of the file."""
    with open(path, "rb") as f:
        blob = f.read()
    (n,) = struct.unpack("<Q", blob[:8])
    header = json.loads(blob[8: 8 + n])
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        if end == begin:
            t = torch.empty(0, dtype=dtype)
        else:
            t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (any device; stored contiguous, little-endian) in
    name order, each buffer 8-byte aligned as the reference writer does."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in chunks:
            f.write(raw)
