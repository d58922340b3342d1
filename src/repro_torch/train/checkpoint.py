"""Fault-tolerant checkpointing, in the JAX package's on-disk format.

Layout: one directory per step containing a msgpack manifest (leaf keys,
shapes, dtypes, crc32 per leaf) and one zstd-compressed raw file per leaf.
Writes are atomic (tmp dir + rename) so a killed writer never corrupts the
`latest` pointer; saves can run asynchronously on a background thread
(training continues; the previous save is joined first).

Leaves are named by their paths in JAX's order (``tree.py``), so a
checkpoint written by either package restores in the other.  bfloat16
leaves keep their raw bytes under the dtype string ``"bfloat16"``.  The
manifest uses only maps, arrays, strings, integers and nil; the port
encodes and decodes that subset itself, byte for byte as ``msgpack.packb``
does, and needs no msgpack package.

``restore`` places every leaf on the manager's device (cuda unless told
otherwise) or the one it is given, or, given ``shardings``, on a mesh:
each leaf is distributed as its ``NamedSharding`` says (elastic re-mesh is
just a different shardings tree).
"""

from __future__ import annotations

import shutil
import struct
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.batch_executor import resolve_device
from . import tree as tree_util

try:  # optional: fall back to uncompressed leaves when unavailable
    import zstandard
except ImportError:  # pragma: no cover
    zstandard = None

Params = Any

_SEP = "\x1f"


# ---------------------------------------------------------------------------
# the manifest's msgpack subset
# ---------------------------------------------------------------------------


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for None, bool, int, str, list/tuple and dict."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xD9, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDA, n)
        else:
            out += struct.pack(">BI", 0xDB, n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 0xDC, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 0xDE, out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_len(n: int, fix: int, code16: int, out: bytearray) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out += struct.pack(">BH", code16, n)
    else:
        out += struct.pack(">BI", code16 + 1, n)


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, limit in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                                 (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if n < limit:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)
    else:
        for code, fmt, limit in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                                 (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if n >= -limit:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(n)


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data)`` for what :func:`packb` writes."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the manifest")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _unpack(data: bytes, i: int) -> Tuple[Any, int]:
    code = data[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if code == 0xC0:
        return None, i
    if code in (0xC2, 0xC3):
        return code == 0xC3, i
    if code in _FIXED:
        fmt = _FIXED[code]
        return struct.unpack_from(fmt, data, i)[0], i + struct.calcsize(fmt)
    if 0xA0 <= code < 0xC0 or code in (0xD9, 0xDA, 0xDB):
        if code < 0xC0:
            n = code & 0x1F
        else:
            fmt = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[code]
            n = struct.unpack_from(fmt, data, i)[0]
            i += struct.calcsize(fmt)
        return data[i:i + n].decode("utf-8"), i + n
    if 0x90 <= code < 0xA0 or code in (0xDC, 0xDD):
        n, i = _length(data, i, code, 0x90, 0xDC)
        items = []
        for _ in range(n):
            item, i = _unpack(data, i)
            items.append(item)
        return items, i
    if 0x80 <= code < 0x90 or code in (0xDE, 0xDF):
        n, i = _length(data, i, code, 0x80, 0xDE)
        out = {}
        for _ in range(n):
            key, i = _unpack(data, i)
            out[key], i = _unpack(data, i)
        return out, i
    raise ValueError(f"msgpack type 0x{code:02x} is outside the manifest's subset")


def _length(data: bytes, i: int, code: int, fix: int, code16: int) -> Tuple[int, int]:
    if code < fix + 16:
        return code - fix, i
    fmt = ">H" if code == code16 else ">I"
    return struct.unpack_from(fmt, data, i)[0], i + struct.calcsize(fmt)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


def _flatten(tree: Params) -> List[Tuple[str, Any]]:
    return [(_SEP.join(str(p) for p in path), leaf)
            for path, leaf in tree_util.flatten_with_path(tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")  # numpy's names: float32, bfloat16, int32


def _host(leaf: Any) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, raw bytes) of a leaf, copied to the host now (a
    DTensor is gathered whole first, on every rank of its mesh)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True).contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return _dtype_name(t.dtype), list(t.shape), raw.numpy().tobytes()


def _from_bytes(raw: bytes, dtype: str, shape: List[int]) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if not raw:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(bytearray(raw), dtype=dt).reshape(shape)


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        async_save: bool = True,
        device=None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        # where restore places leaves: cuda unless told otherwise
        self.device = resolve_device(device)
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Params, *, block: bool = False) -> None:
        """Snapshot host-side, then write (optionally on a thread)."""
        self.wait()  # at most one in-flight save
        host = [(k, *_host(v)) for k, v in _flatten(tree)]  # device -> host copy

        def write():
            self._write(step, host)
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: List[Tuple[str, str, List[int], bytes]]) -> None:
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        cctx = zstandard.ZstdCompressor(level=3) if zstandard is not None else None
        manifest = {"step": step, "leaves": []}
        for i, (key, dtype, shape, raw) in enumerate(host):
            payload = cctx.compress(raw) if cctx is not None else raw
            fname = f"leaf_{i:05d}.bin.zst" if cctx is not None else f"leaf_{i:05d}.bin"
            (tmp / fname).write_bytes(payload)
            manifest["leaves"].append(
                {
                    "key": key,
                    "file": fname,
                    "dtype": dtype,
                    "shape": shape,
                    "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                }
            )
        (tmp / "manifest.msgpack").write_bytes(packb(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        (self.dir / "latest.tmp").write_text(final.name)
        (self.dir / "latest.tmp").rename(self.dir / "latest")

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        pointer = self.dir / "latest"
        if not pointer.exists():
            return None
        name = pointer.read_text().strip()
        if not (self.dir / name).exists():
            return None
        return int(name.split("_")[1])

    def restore(
        self,
        like: Params,
        *,
        step: Optional[int] = None,
        device=None,
        strict_integrity: bool = True,
        shardings: Optional[Params] = None,
    ) -> Tuple[int, Params]:
        """Restore into the structure of ``like`` (shape/dtype template),
        every leaf on ``device`` (the manager's unless given).

        ``shardings`` (a tree of ``sharding.rules.NamedSharding`` matching
        ``like``) places each leaf on the restore mesh instead, as a
        DTensor; every rank of the mesh reads the whole leaf.
        """
        device = self.device if device is None else resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        manifest = unpackb((path / "manifest.msgpack").read_bytes())
        by_key: Dict[str, dict] = {m["key"]: m for m in manifest["leaves"]}
        dctx = zstandard.ZstdDecompressor() if zstandard is not None else None

        shard_flat = None
        if shardings is not None:
            shard_flat = tree_util.leaves(shardings)
        leaves = []
        for i, (key, _) in enumerate(_flatten(like)):
            meta = by_key[key]
            payload = (path / meta["file"]).read_bytes()
            if meta["file"].endswith(".zst"):
                if dctx is None:
                    raise IOError(
                        "checkpoint uses zstd compression but zstandard is "
                        "not installed"
                    )
                raw = dctx.decompress(
                    payload,
                    max_output_size=int(np.prod(meta["shape"] or [1])) * 16 + 64,
                )
            else:
                raw = payload
            if strict_integrity and (zlib.crc32(raw) & 0xFFFFFFFF) != meta["crc32"]:
                raise IOError(f"checkpoint corruption in leaf {key} (crc mismatch)")
            leaf = _from_bytes(raw, meta["dtype"], meta["shape"])
            if shard_flat is not None:
                leaves.append(shard_flat[i].place(leaf))
            else:
                leaves.append(leaf.to(device))
        return step, tree_util.unflatten(like, leaves)
