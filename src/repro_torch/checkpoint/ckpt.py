"""Checkpoints of trees of tensors: a manifest and compressed chunk
files (the port of the reference's `checkpoint/ckpt.py`).

The chunk files are the reference's, byte for byte, for the same tree
and codec: each leaf's raw bytes (C order; bf16 as its 2-byte words,
dtype "bfloat16", as ml_dtypes writes them) cut into 64 MB logical
chunks, each stored as a little-endian u32 length and the compressed
blob, with a crc32 per chunk in the manifest. Leaf names are the
reference's (`_path_str`: the path's keys joined by "/", dict keys
sorted, dataclass fields as ".name"), and so are the file names.

The manifest differs in form only: `manifest.json` with the
reference's fields (`leaves`: name, file, shape, dtype, chunks of off,
nbytes, crc; `codec`), since msgpack is not a dependency of the port.
The codec is zstd (level 3) where `zstandard` imports, else zlib
(level 6), as the reference's `DEFAULT_CODEC` chooses; the manifest
records it.

Integrity as in the reference: every chunk file is fsync'd, then the
manifest, and a COMMIT marker is written last, so a torn write is never
mistaken for a checkpoint.

A checkpoint holds whole leaves, whatever mesh wrote it (the manager
gathers a meshed state's shards onto the mesh's first rank, which
writes), so `restore_pytree(..., mesh=, specs=)` cuts each rank's block
out of the whole leaf for whatever mesh the job has: the port's
counterpart of the reference's `restore_pytree(..., shardings=)`. Chunks are compressed on a thread pool
(zlib and zstd release the GIL); the bytes are those of a serial save.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import struct
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import leaves_with_path, path_name, tree_unflatten

try:
    import zstandard as zstd
except ImportError:          # zlib fallback keeps checkpoints working
    zstd = None

_CHUNK = 64 * 1024 * 1024   # 64 MB logical chunks

DEFAULT_CODEC = "zstd" if zstd is not None else "zlib"

#: threads compressing (saving) or decompressing (restoring) chunks
WORKERS = min(8, os.cpu_count() or 1)


def _compressor(codec: str):
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError("codec 'zstd' requested but the zstandard "
                               "package is not installed")
        return lambda raw: zstd.ZstdCompressor(level=3).compress(raw)
    if codec == "zlib":
        return lambda raw: zlib.compress(raw, 6)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompressor(codec: str):
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the zstandard "
                "package is not installed; re-save with codec='zlib' "
                "or install zstandard to restore it")
        return lambda blob: zstd.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _host_array(leaf) -> np.ndarray:
    """A leaf's values as a C-ordered numpy array on the host; a bf16
    tensor as its raw 2-byte words (int16, read back by dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.ascontiguousarray(np.asarray(leaf))


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save_pytree(tree: Any, directory: str,
                codec: Optional[str] = None) -> int:
    """Write every leaf of `tree` (tensors on any device, or numpy
    arrays) under `directory`, then the manifest, then COMMIT. Returns
    the bytes written to chunk files.

    Every chunk of every leaf goes to the thread pool as soon as its
    leaf is on the host; the files are written in leaf order as their
    chunks come back, with at most 4 x WORKERS chunks waiting."""
    codec = codec or DEFAULT_CODEC
    compress = _compressor(codec)
    os.makedirs(directory, exist_ok=True)
    manifest = {"leaves": [], "codec": codec}
    written = 0

    def write(name, fname, shape, dtype, blobs) -> int:
        chunks, n = [], 0
        with open(os.path.join(directory, fname), "wb") as f:
            for i, fut in enumerate(blobs):
                blob = fut.result()
                chunks.append({"off": i * _CHUNK, "nbytes": len(blob),
                               "crc": zlib.crc32(blob)})
                f.write(struct.pack("<I", len(blob)))
                f.write(blob)
                n += 4 + len(blob)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"name": name, "file": fname,
                                   "shape": shape, "dtype": dtype,
                                   "chunks": chunks})
        return n

    with concurrent.futures.ThreadPoolExecutor(WORKERS) as pool:
        queue = collections.deque()
        waiting = 0
        for path, leaf in leaves_with_path(tree):
            name = path_name(path)
            arr = _host_array(leaf)
            raw = memoryview(arr.reshape(-1).view(np.uint8))
            blobs = [pool.submit(compress, raw[off:off + _CHUNK])
                     for off in range(0, max(len(raw), 1), _CHUNK)]
            queue.append((name, name.replace("/", ".") + "." + codec,
                          list(arr.shape), _dtype_name(leaf, arr), blobs))
            waiting += len(blobs)
            while waiting > 4 * WORKERS:
                waiting -= len(queue[0][-1])
                written += write(*queue.popleft())
        while queue:
            written += write(*queue.popleft())
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # commit marker LAST: restore only trusts committed checkpoints
    with open(os.path.join(directory, "COMMIT"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    return written


def is_committed(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, "COMMIT"))


def _read_leaf(directory, meta, decompress, pool) -> torch.Tensor:
    """One leaf's tensor on the host, each chunk's crc checked."""
    blobs = []
    with open(os.path.join(directory, meta["file"]), "rb") as f:
        for ch in meta["chunks"]:
            (n,) = struct.unpack("<I", f.read(4))
            blob = f.read(n)
            if zlib.crc32(blob) != ch["crc"]:
                raise ValueError(f"corrupt chunk in {meta['name']}")
            blobs.append(blob)
    raw = b"".join(pool.map(decompress, blobs))
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(meta["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=meta["dtype"]).reshape(meta["shape"])
    return torch.from_numpy(arr.copy())


def restore_pytree(target: Any, directory: str, device=None, mesh=None,
                   specs: Optional[Dict[str, Any]] = None) -> Any:
    """Restore into the structure of `target` (tensors, real or on the
    "meta" device), each leaf cast to its target's dtype, on `device`
    (default: the CUDA card). With `mesh`: each leaf is this rank's
    block of the whole leaf under its spec (`specs`: {leaf name:
    partition spec}, e.g. `bridge.train_state_specs`; a leaf not named
    is whole), cut by `launch.shardings.shard`, and `target` holds the
    blocks' shapes. Raises if the checkpoint is not committed, a leaf
    is missing or has another shape, or a chunk's crc disagrees."""
    device = resolve_device(device)
    coord = None
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_coordinate
        coord = mesh_coordinate(mesh)
    if not is_committed(directory):
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
    decompress = _decompressor(manifest.get("codec", "zstd"))
    out = []
    with concurrent.futures.ThreadPoolExecutor(WORKERS) as pool:
        for path, leaf in leaves_with_path(target):
            name = path_name(path)
            if name not in by_name:
                raise KeyError(f"leaf {name} is not in the checkpoint")
            t = _read_leaf(directory, by_name[name], decompress, pool)
            if mesh is not None:
                from repro_torch.launch.shardings import shard
                t = shard(t, (specs or {}).get(name, ()), mesh, coord)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {name}: checkpoint shape "
                                 f"{tuple(t.shape)}, target "
                                 f"{tuple(leaf.shape)}")
            out.append(t.to(leaf.dtype).to(device))
    return tree_unflatten(target, out)
