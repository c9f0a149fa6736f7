"""Checkpointing: tree save/restore + grace-period estimation
(counterpart of ``repro.checkpoint.ckpt``).

The substrate behind checkpoint-based preemption (the paper's grace
period, §2): suspending a training job flushes its train state to
storage, and the grace period it asks for is ``state_bytes / storage
bandwidth`` with serialization slack.

The file is the JAX package's ``.npz`` layout, byte for byte what
``np.savez`` writes for the same arrays: one stored (uncompressed)
member per leaf, named by its ``§``-joined key path, bfloat16 stored as
its uint16 pattern and named in the ``__meta__`` entry. The port's key
paths are its own (a module's leaves by their dotted parameter names);
:func:`load_tree` reads any such file, the JAX package's included, into
nested dicts.

The flush and the restore run as pipelines through the host, a chunk of
``_CHUNK`` bytes at a time. Saving, a side stream copies a device leaf's
next chunks into a ring of ``_RING`` pinned buffers while ``zipfile``
takes the CRC of this chunk and ``_IO_THREADS`` worker threads write
the ones before it, each at its own offset. Loading, the stored members
are read from their offsets in the archive by the same number of
threads into the pinned ring (or straight into a CPU template's
memory); one more thread takes each member's CRC in order and has a
side stream copy each chunk to the device; a member whose CRC differs
raises.
"""
from __future__ import annotations

import io
import json
import math
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as _tree

Tree = Any
_SEP = "§"
_META = "__meta__"
# bytes a pipeline stage holds, the pinned buffers in flight, and the
# threads that write or read the file
_CHUNK = 64 << 20
_RING = 8
_IO_THREADS = 4


def _flat(tree: Tree) -> Dict[str, torch.Tensor]:
    return {_SEP.join(path): leaf for path, leaf in _tree.flatten(tree)}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """A leaf's type in the file (bfloat16 as its uint16 pattern)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _from_numpy(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _npy_header(dtype: np.dtype, shape) -> bytes:
    """The ``.npy`` header ``np.save`` writes for a C-ordered array."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": np.lib.format.dtype_to_descr(dtype),
        "fortran_order": False, "shape": tuple(int(n) for n in shape)})
    return buf.getvalue()


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A contiguous leaf's memory as a flat uint8 tensor (a view)."""
    return t.detach().reshape(-1).view(torch.uint8)


class _Ring:
    """``_RING`` pinned host buffers of ``_CHUNK`` bytes and a side stream
    for the copies between them and ``device``. A slot is reused only
    after whoever uses its host side (a write; a read, its CRC and the
    issue of its upload: ``busy``) is done and its copy has finished
    (``event``)."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        self.bufs = [torch.empty(_CHUNK, dtype=torch.uint8, pin_memory=True)
                     for _ in range(_RING)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * _RING
        self.busy: List[Optional[Any]] = [None] * _RING

    def free(self, slot: int) -> torch.Tensor:
        if self.busy[slot] is not None:
            self.busy[slot].result()
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        self.events[slot] = self.busy[slot] = None
        return self.bufs[slot]

    def copy(self, slot: int, dst: torch.Tensor, src: torch.Tensor) -> None:
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[slot] = ev


def _host_chunks(leaves: List[torch.Tensor], ring: Optional[_Ring]):
    """(leaf index, slot or None, host bytes) for every ``_CHUNK`` of
    every leaf, in order: a CPU leaf's as views of its memory, a device
    leaf's staged through ``ring``, its copy issued two chunks ahead of
    its turn, so a slot is refilled ``_RING - 2`` chunks after it was
    handed out, its write most likely done. The caller sets
    ``ring.busy[slot]`` to what reads the returned bytes before it asks
    for the next chunk."""
    pieces = [(i, b, o, min(_CHUNK, b.numel() - o))
              for i, b in enumerate(_bytes_of(t) for t in leaves)
              for o in range(0, b.numel(), _CHUNK)]
    issued = 0

    def issue(j):
        i, b, o, n = pieces[j]
        if b.device.type == "cuda":
            slot = j % _RING
            ring.copy(slot, ring.free(slot)[:n], b[o:o + n])

    for j, (i, b, o, n) in enumerate(pieces):
        while issued < min(j + 3, len(pieces)):
            issue(issued)
            issued += 1
        if b.device.type != "cuda":
            yield i, None, memoryview(b[o:o + n].numpy())
            continue
        slot = j % _RING
        ring.events[slot].synchronize()
        yield i, slot, memoryview(ring.bufs[slot][:n].numpy())


def _pwrite(fd: int, b, pos: int) -> None:
    mv = memoryview(b).cast("B")
    while mv:
        n = os.pwrite(fd, mv, pos)
        mv, pos = mv[n:], pos + n


def _pread(fd: int, mv: memoryview, pos: int) -> None:
    mv = mv.cast("B")
    while mv:
        n = os.preadv(fd, [mv], pos)
        if n == 0:
            raise zipfile.BadZipFile("the archive ends inside a member")
        mv, pos = mv[n:], pos + n


class _QueuedFile:
    """A binary file (a descriptor opened for writing) whose writes run
    on ``_IO_THREADS`` worker threads, each at the offset it was given
    at, so the writer of the next chunk (``zipfile``, taking its CRC)
    overlaps the writes of the ones before. ``tell`` counts the queued
    bytes; ``seek`` and ``flush`` wait for every queued write, so a
    region written again (``zipfile``'s local header, once the member's
    size and CRC are known) is written after the first. ``last`` is the
    newest write."""

    def __init__(self, fd: int):
        self._fd = fd
        self._pos = 0
        self._pool = ThreadPoolExecutor(max_workers=_IO_THREADS)
        self._queue: list = []
        self.last = None

    def write(self, b) -> int:
        self.last = self._pool.submit(_pwrite, self._fd, b, self._pos)
        self._queue.append(self.last)
        n = memoryview(b).nbytes
        self._pos += n
        return n

    def _drain(self) -> None:
        queue, self._queue = self._queue, []
        for fut in queue:
            fut.result()

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int, whence: int = 0) -> int:
        self._drain()
        self._pos = os.lseek(self._fd, pos, whence)
        return self._pos

    def flush(self) -> None:
        self._drain()

    def close(self) -> None:
        try:
            self._drain()
        finally:
            self._pool.shutdown()


def _device_of(leaves) -> Optional[torch.device]:
    return next((t.device for t in leaves if t.device.type == "cuda"), None)


@torch.no_grad()
def save_pytree(tree: Tree, path: str) -> int:
    """Write a tree to ``path`` (.npz, byte for byte as ``np.savez``
    writes it). The host holds ``_RING`` chunks of the state at a time,
    not a leaf. Returns the bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flat(tree)
    meta = {k: "bfloat16" for k, t in arrays.items()
            if t.dtype == torch.bfloat16}
    leaves = [t if t.is_contiguous() else t.contiguous()
              for t in arrays.values()]
    dev = _device_of(leaves)
    ring = _Ring(dev) if dev is not None else None
    chunks = _host_chunks(leaves, ring)
    nxt = next(chunks, None)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        out = _QueuedFile(fd)
        try:
            with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                with zf.open(_META + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(
                        f, np.asarray(json.dumps(meta)), allow_pickle=False)
                for i, (k, t) in enumerate(zip(arrays, leaves)):
                    with zf.open(k + ".npy", "w", force_zip64=True) as f:
                        f.write(_npy_header(_np_dtype(t.dtype), t.shape))
                        while nxt is not None and nxt[0] == i:
                            f.write(nxt[2])
                            if nxt[1] is not None:
                                ring.busy[nxt[1]] = out.last
                            nxt = next(chunks, None)
        finally:
            out.close()
            if ring is not None:
                ring.stream.synchronize()
    finally:
        os.close(fd)
    return os.path.getsize(path)


def load_tree(path: str) -> dict:
    """Every leaf of a checkpoint as a CPU tensor (bfloat16 restored), in
    nested dicts split at ``§``: the JAX package's files included, whose
    trees ``models.convert.train_state_from_numpy`` carries over."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META]))
        return _tree.unflatten({
            tuple(k.split(_SEP)): _from_numpy(data[k], meta.get(k) ==
                                              "bfloat16")
            for k in data.files if k != _META})


def _stored_array(f, info: zipfile.ZipInfo):
    """(dtype, shape, offset of the array's bytes, the ``.npy`` header)
    of a stored, C-ordered member, or None for any other (read through
    ``zipfile`` instead)."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    f.seek(info.header_offset)
    local = f.read(30)
    if local[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"{info.filename}: bad local header")
    start = info.header_offset + 30 + sum(struct.unpack("<HH", local[26:]))
    f.seek(start)
    version = np.lib.format.read_magic(f)
    read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}.get(version)
    if read_header is None:
        return None
    shape, fortran, dtype = read_header(f)
    if fortran or dtype.hasobject:
        return None
    data = f.tell()
    if data - start + math.prod(shape) * dtype.itemsize != info.file_size:
        raise zipfile.BadZipFile(f"{info.filename}: {info.file_size} bytes "
                                 f"do not hold a {dtype} {shape} array")
    f.seek(start)
    return dtype, tuple(shape), data, f.read(data - start)


@torch.no_grad()
def load_pytree(template: Tree, path: str) -> Tree:
    """Restore a tree saved by :func:`save_pytree` into ``template`` in
    place, leaf by leaf (each keeps its type and device), and return it.
    Raises on a missing leaf, on a leaf whose shape or type is not the
    template's, and on a member whose CRC is not the archive's (the
    template then holds what was read). (The JAX version returns a new
    tree.)"""
    flat = _flat(template)
    dev = _device_of(flat.values())
    ring = _Ring(dev) if dev is not None else None
    io_pool = ThreadPoolExecutor(max_workers=_IO_THREADS)
    crc_pool = ThreadPoolExecutor(max_workers=1)
    checks, done = [], []
    try:
        with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
            infos = {i.filename[:-4]: i for i in zf.infolist()
                     if i.filename.endswith(".npy")}
            with zf.open(infos[_META]) as mf:
                meta = json.loads(str(np.lib.format.read_array(
                    mf, allow_pickle=False)))
            missing = sorted(set(flat) - set(infos))
            if missing:
                raise KeyError(f"checkpoint missing keys: {missing[:5]} ...")
            slot = 0
            for k, t in flat.items():
                bf16 = meta.get(k) == "bfloat16"
                stored = _stored_array(f, infos[k])
                if stored is None:      # compressed, Fortran-ordered, ...
                    with zf.open(infos[k]) as mf:
                        a = np.lib.format.read_array(mf, allow_pickle=False)
                    src = _from_numpy(a, bf16)
                    dtype, shape = src.dtype, tuple(src.shape)
                else:
                    npd, shape, data, header = stored
                    if bf16 and npd != np.uint16:
                        raise ValueError(f"{k}: a bfloat16 leaf stored as "
                                         f"{npd}")
                    dtype = torch.bfloat16 if bf16 else \
                        torch.from_numpy(np.empty(0, npd)).dtype
                if shape != tuple(t.shape) or dtype != t.dtype:
                    raise ValueError(f"{k}: checkpoint holds {dtype} "
                                     f"{shape}, the template {t.dtype} "
                                     f"{tuple(t.shape)}")
                if stored is None:
                    t.copy_(src)
                    continue
                dst = t if t.is_contiguous() else torch.empty_like(t)
                out = _bytes_of(dst)
                crc = [zlib.crc32(header)]
                member = []
                for o in range(0, out.numel(), _CHUNK):
                    n = min(_CHUNK, out.numel() - o)
                    cuda = out.device.type == "cuda"
                    host = ring.free(slot)[:n] if cuda else out[o:o + n]
                    view = memoryview(host.numpy())
                    read = io_pool.submit(_pread, f.fileno(), view, data + o)

                    def then(read=read, view=view, crc=crc, slot=slot,
                             dst=out[o:o + n] if cuda else None, host=host):
                        # in order, on the one CRC thread
                        read.result()
                        crc[0] = zlib.crc32(view, crc[0])
                        if dst is not None:
                            ring.copy(slot, dst, host)

                    member.append(crc_pool.submit(then))
                    if cuda:
                        ring.busy[slot] = member[-1]
                        slot = (slot + 1) % _RING
                checks.append((k, crc, infos[k].CRC))
                done += member
                if dst is not t:
                    for fut in member:
                        fut.result()
                    if ring is not None:
                        ring.stream.synchronize()
                    t.copy_(dst)
            for fut in done:
                fut.result()
    finally:
        crc_pool.shutdown(wait=True)
        io_pool.shutdown(wait=True)
        if ring is not None:
            ring.stream.synchronize()
            torch.cuda.current_stream(dev).wait_stream(ring.stream)
    for k, crc, want in checks:
        if crc[0] != want:
            raise zipfile.BadZipFile(f"Bad CRC-32 for {k}")
    return template


def state_bytes(tree: Tree) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in _tree.leaves(tree)))


def estimate_grace_period(tree: Tree, storage_bw_bytes_per_s: float = 2e9,
                          slack: float = 1.5) -> int:
    """Suggested grace period [minutes] for a job with this train state:
    slack * bytes / bandwidth, at least one scheduler tick when nonzero."""
    b = state_bytes(tree)
    seconds = slack * b / storage_bw_bytes_per_s
    return max(math.ceil(seconds / 60.0), 1) if b else 0
