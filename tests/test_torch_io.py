"""The port's safetensors reader and writer (``utils/io.py``) against the
``safetensors`` package in both directions: every dtype the format and
torch share, scalar and empty shapes, metadata, an HF shard index and a
directory of shards, byte-identical files; malformed headers (offsets that
overlap, leave a gap or run past the file, and others) raise in the port's
reader as in the package's."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from kandinsky5_tpu_torch.utils.io import (
    DTYPES,
    _header,
    load_safetensors,
    load_sharded_safetensors,
    save_safetensors,
)


def _metadata(path):
    """The ``__metadata__`` map of a safetensors file, as the port's
    reader parses it (None when absent)."""
    with open(path, "rb") as f:
        return _header(f, os.fstat(f.fileno()).st_size, path)[2]


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape)) if shape else 1
    raw = torch.randint(0, 256, (n * dtype.itemsize,), dtype=torch.uint8,
                        generator=g)
    if dtype == torch.bool:
        return (raw % 2).bool().reshape(shape)
    return raw.view(dtype).reshape(shape)


def _same(a, b):
    """Bit-equal: same dtype, shape and bytes (NaN payloads included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


SHAPES = [(3, 5), (), (0,), (2, 0, 4), (7,)]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_round_trip_against_safetensors(tmp_path, name):
    """Each dtype at every shape: the package reads what the port writes
    and the port reads what the package writes, bit for bit, and the two
    files are the same bytes."""
    from safetensors.torch import load_file, save_file

    dtype = DTYPES[name]
    tensors = {f"t{i}": _tensor(dtype, s, i) for i, s in enumerate(SHAPES)}
    tensors["other"] = _tensor(torch.float32, (4,), 9)  # another dtype beside
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    save_safetensors(tensors, ours)
    save_file(tensors, theirs)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for got in (load_file(ours), load_safetensors(theirs)):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert _same(got[k], v), k


def test_all_dtypes_in_one_file_and_metadata(tmp_path):
    """Every dtype in one file with metadata, both directions; the loaded
    tensors are views of a private mapping (writing one leaves the file
    alone)."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    tensors = {f"x_{n}": _tensor(dt, (3, 7), i)
               for i, (n, dt) in enumerate(sorted(DTYPES.items()))}
    meta = {"format": "pt"}
    ours, theirs = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    save_safetensors(tensors, ours, metadata=meta)
    save_file(tensors, theirs, metadata=meta)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    with safe_open(ours, "pt") as f:
        assert f.metadata() == meta
    assert _metadata(theirs) == meta
    save_file(tensors, theirs, metadata={"a": "1", "b": "two"})
    assert _metadata(theirs) == {"a": "1", "b": "two"}
    got = load_safetensors(ours)
    for k, v in tensors.items():
        assert _same(got[k], v)
    before = open(ours, "rb").read()
    got["x_F32"].fill_(0)
    assert open(ours, "rb").read() == before


def test_sharded_layouts(tmp_path):
    """``load_sharded_safetensors``' three layouts, written by the port: one
    file, an HF index naming its shards, a directory of shards."""
    tensors = {f"layer.{i}.weight": _tensor(torch.bfloat16, (4, 3), i)
               for i in range(5)}
    names = sorted(tensors)
    index_dir, plain_dir = tmp_path / "index", tmp_path / "plain"
    index_dir.mkdir()
    plain_dir.mkdir()
    weight_map = {}
    for j, part in enumerate((names[:2], names[2:])):
        fname = f"model-{j + 1:05d}-of-00002.safetensors"
        save_safetensors({k: tensors[k] for k in part}, str(index_dir / fname))
        save_safetensors({k: tensors[k] for k in part}, str(plain_dir / fname))
        weight_map.update({k: fname for k in part})
    save_safetensors({"stray": torch.zeros(1)}, str(index_dir / "unlisted.safetensors"))
    with open(index_dir / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    single = str(tmp_path / "one.safetensors")
    save_safetensors(tensors, single)
    for path in (single, str(index_dir), str(plain_dir)):
        got = load_sharded_safetensors(path)
        assert set(got) == set(tensors), path
        assert all(_same(got[k], tensors[k]) for k in tensors)


def _with_header(path, header: dict, data: bytes, pad=True):
    raw = json.dumps(header).encode()
    if pad:
        raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)
    return path


def _entry(dtype, shape, begin, end):
    return {"dtype": dtype, "shape": shape, "data_offsets": [begin, end]}


MALFORMED = {
    "overlap": ({"a": _entry("F32", [2], 0, 8), "b": _entry("F32", [2], 4, 12)}, 12),
    "gap": ({"a": _entry("F32", [2], 0, 8), "b": _entry("F32", [2], 12, 20)}, 20),
    "past the end": ({"a": _entry("F32", [4], 0, 16)}, 8),
    "short data": ({"a": _entry("F32", [2], 0, 8)}, 12),
    "size mismatch": ({"a": _entry("F32", [3], 0, 8)}, 8),
    "unknown dtype": ({"a": _entry("Q8", [2], 0, 2)}, 2),
    "negative shape": ({"a": _entry("U8", [-2], 0, 2)}, 2),
    "reversed offsets": ({"a": _entry("U8", [0], 4, 2), "b": _entry("U8", [4], 0, 4)}, 4),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_headers_raise(tmp_path, case):
    """Offsets that overlap, leave a gap or run past the file, and other
    broken entries, raise ValueError in the port's reader, and the package
    refuses them too."""
    from safetensors.torch import load_file

    header, n = MALFORMED[case]
    path = _with_header(str(tmp_path / "bad.safetensors"), header, bytes(n))
    with pytest.raises(ValueError):
        load_safetensors(path)
    with pytest.raises(Exception):
        load_file(path)


def test_truncated_and_non_json_headers_raise(tmp_path):
    short = tmp_path / "short.safetensors"
    short.write_bytes(b"\x01\x00")
    long = tmp_path / "long.safetensors"
    long.write_bytes(struct.pack("<Q", 1000) + b"{}")
    junk = tmp_path / "junk.safetensors"
    junk.write_bytes(struct.pack("<Q", 8) + b"notjson!")
    for path in (short, long, junk):
        with pytest.raises(ValueError):
            load_safetensors(str(path))


def test_flipped_offset_in_a_written_file_raises(tmp_path):
    """The load phase's control: one offset digit of a file the port wrote,
    changed in place (the header keeps its length), makes it unreadable."""
    path = str(tmp_path / "w.safetensors")
    save_safetensors({"a": torch.ones(3), "b": torch.zeros(5)}, path)
    assert _same(load_safetensors(path)["a"], torch.ones(3))
    with open(path, "r+b") as f:
        raw = bytearray(f.read())
        at = raw.index(b'"data_offsets":[0,12]') + len(b'"data_offsets":[0,1')
        raw[at:at + 1] = b"3"
        f.seek(0)
        f.write(raw)
    with pytest.raises(ValueError, match="not a valid safetensors file"):
        load_safetensors(path)


def test_save_refuses_what_the_format_cannot_hold(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        save_safetensors({"c": torch.zeros(2, dtype=torch.complex64)},
                         str(tmp_path / "c.safetensors"))
    with pytest.raises(ValueError):
        save_safetensors({"__metadata__": torch.zeros(1)},
                         str(tmp_path / "m.safetensors"))


def test_non_contiguous_and_strided_tensors_are_written_as_values(tmp_path):
    from safetensors.torch import load_file

    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    tensors = {"t": t.t(), "s": t[:, ::2]}
    path = str(tmp_path / "nc.safetensors")
    save_safetensors(tensors, path)
    got = load_file(path)
    assert torch.equal(got["t"], t.t()) and torch.equal(got["s"], t[:, ::2])
    assert os.path.getsize(path) > 0
