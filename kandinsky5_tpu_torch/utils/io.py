"""Checkpoint files and the video and image writers of the port.

Counterpart of ``kandinsky5_tpu/utils/io.py``: safetensors checkpoints as
one file, a directory of shards or an HF shard index; mp4 at 24 fps through
the native writer and ffmpeg, a raw ``.y4m`` beside the requested path where
no encoder exists, and stills through Pillow.

The safetensors format is read and written here, with no package of its
own: an 8-byte little-endian header length N, N bytes of JSON (each
tensor's ``dtype``, ``shape`` and ``data_offsets`` [begin, end) into the
data that follows, and an optional ``__metadata__`` map of strings), padded
with spaces to a multiple of 8, then the tensors' raw little-endian bytes.
A file is mapped (a private copy-on-write mapping) and every tensor is a
view of the mapping, so a 15 GB checkpoint is not read into a second copy.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from kandinsky5_tpu_torch.utils.native_video import write_video_native

# safetensors dtype names and torch dtypes, in the order the format's own
# writer lays tensors out (largest element first, so every tensor of a file
# it wrote is aligned to its element); the F8 types where torch has them
_DTYPE_ORDER = (("U64", "uint64"), ("I64", "int64"), ("F64", "float64"),
                ("F32", "float32"), ("U32", "uint32"), ("I32", "int32"),
                ("BF16", "bfloat16"), ("F16", "float16"), ("U16", "uint16"),
                ("I16", "int16"), ("F8_E4M3", "float8_e4m3fn"),
                ("F8_E5M2", "float8_e5m2"), ("I8", "int8"), ("U8", "uint8"),
                ("BOOL", "bool"))
DTYPES: Dict[str, torch.dtype] = {
    name: getattr(torch, attr) for name, attr in _DTYPE_ORDER
    if hasattr(torch, attr)}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_RANK = {name: i for i, (name, _) in enumerate(_DTYPE_ORDER)}
# the format's own limit on the header
MAX_HEADER = 100_000_000


def _header(f, size: int, path) -> tuple:
    """(header length, tensor entries, metadata) of an open file of
    ``size`` bytes, every entry checked: known dtype, shape of non-negative
    ints, offsets that tile the data exactly (no overlap, no gap, nothing
    past the end of the file)."""
    def bad(why):
        return ValueError(f"{path}: not a valid safetensors file: {why}")

    if size < 8:
        raise bad("shorter than its 8-byte header length")
    (n,) = struct.unpack("<Q", f.read(8))
    if n > MAX_HEADER:
        raise bad(f"header of {n} bytes")
    if 8 + n > size:
        raise bad(f"header of {n} bytes runs past the file's {size}")
    raw = f.read(n)
    if not raw.startswith(b"{"):
        raise bad("the header is not a JSON object")
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise bad(f"the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise bad("the header is not a JSON object")
    meta = header.pop("__metadata__", None)
    if meta is not None and not (isinstance(meta, dict) and all(
            isinstance(k, str) and isinstance(v, str) for k, v in meta.items())):
        raise bad("__metadata__ is not a map of strings")
    entries = []
    for name, e in header.items():
        if not isinstance(e, dict) or set(e) != {"dtype", "shape", "data_offsets"}:
            raise bad(f"{name!r} is not a tensor entry")
        dtype, shape, offs = e["dtype"], e["shape"], e["data_offsets"]
        if dtype not in DTYPES:
            raise bad(f"{name!r} has dtype {dtype!r}, which this reader "
                      f"does not take ({', '.join(DTYPES)})")
        if not (isinstance(shape, list) and all(
                type(d) is int and d >= 0 for d in shape)):
            raise bad(f"{name!r} has shape {shape!r}")
        if not (isinstance(offs, list) and len(offs) == 2 and all(
                type(o) is int for o in offs) and 0 <= offs[0] <= offs[1]):
            raise bad(f"{name!r} has data_offsets {offs!r}")
        numel = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if offs[1] - offs[0] != numel * DTYPES[dtype].itemsize:
            raise bad(f"{name!r}: {offs[1] - offs[0]} bytes for {shape} "
                      f"{dtype}")
        entries.append((offs[0], offs[1], name, dtype, shape))
    entries.sort()
    end = 0
    for begin, stop, name, _, _ in entries:
        if begin != end:
            raise bad(f"{name!r} starts at {begin}, the data before ends at "
                      f"{end} ({'overlap' if begin < end else 'gap'})")
        end = stop
    if 8 + n + end != size:
        raise bad(f"the tensors end at byte {8 + n + end} of a "
                  f"{size}-byte file")
    return n, entries, meta


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors in their stored
    dtype that view a private mapping of the file (no copy is made; writing
    to one copies only the pages written). Raises ValueError on a header
    whose offsets overlap, leave a gap or run past the file."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        n, entries, _ = _header(f, size, path)
        data = 8 + n
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > data else None
    out: Dict[str, torch.Tensor] = {}
    for begin, stop, name, dtype, shape in entries:
        dt = DTYPES[dtype]
        if stop == begin:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        t = torch.frombuffer(buf, dtype=torch.uint8, count=stop - begin,
                             offset=data + begin)
        if (data + begin) % dt.itemsize:  # a writer that did not align it
            t = t.clone()
        out[name] = t.view(dt).reshape(shape)
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as
    one safetensors file, laid out as the format's own writer lays it out:
    larger elements first, then by name, so that the bytes are the same
    (with at most one metadata key: the format's writer orders a map of
    several as it pleases)."""
    items = []
    for name, t in tensors.items():
        if not isinstance(name, str) or name == "__metadata__":
            raise ValueError(f"safetensors: {name!r} cannot name a tensor")
        if t.dtype not in _NAMES:
            raise ValueError(f"safetensors: {name!r} has dtype {t.dtype}, "
                             "which the format does not hold")
        items.append((_RANK[_NAMES[t.dtype]], name, t))
    items.sort(key=lambda it: it[:2])
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    end = 0
    for _, name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [end, end + nbytes]}
        end += nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, _, t in items:
            if t.numel():
                t = t.detach().to("cpu").contiguous().reshape(-1)
                f.write(t.view(torch.uint8).numpy().data)


def load_sharded_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors checkpoint as CPU tensors in their stored dtype: one
    file, a directory with an HF shard index
    (``model.safetensors.index.json``: the shards it names), or a directory
    of ``*.safetensors`` files. No fp32 copy is made: a bf16 7B checkpoint
    stays 15 GB, and it stays a mapping of the files."""
    if os.path.isfile(path):
        files = [path]
    else:
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                names = sorted(set(json.load(f)["weight_map"].values()))
            files = [os.path.join(path, n) for n in names]
        else:
            files = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.endswith(".safetensors"))
    out: Dict[str, torch.Tensor] = {}
    for file in files:
        out.update(load_safetensors(file))
    return out


def write_video(path: str, frames: np.ndarray, fps: int = 24,
                crf: int = 5) -> str:
    """frames (T, H, W, 3) uint8 -> mp4 at ``path``, or, with no encoder,
    the raw stream at ``path`` with a ``.y4m`` suffix. Returns the path
    written."""
    if write_video_native(path, frames, fps=fps, crf=crf):
        return path
    y4m = path.rsplit(".", 1)[0] + ".y4m"
    if not write_video_native(y4m, frames, fps=fps):
        raise RuntimeError("no usable video writer (g++ or ffmpeg missing)")
    return y4m


def write_image(path: str, frame: np.ndarray) -> str:
    """frame (H, W, 3) uint8 -> an image file at ``path`` (format from its
    suffix)."""
    from PIL import Image

    Image.fromarray(np.asarray(frame, dtype=np.uint8)).save(path)
    return path
