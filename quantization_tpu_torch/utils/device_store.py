"""Device-resident stores for streaming ingestion.

Twin of ``quantization_tpu/utils/device_store.py`` (``DeviceAppender`` and
``DeviceScatter``, each with its ``sharding`` role). The encode loop streams
host batches up and keeps codes on the device; the output is preallocated
once and every batch is written into its rows in place, so peak device
memory is the padded corpus, not 2x (list + concat). PyTorch runs eagerly
and allocates when asked, so no periodic host sync is needed to bound
outstanding work.

With a mesh the output is a :class:`ShardedArray`: equal shards of the
append axis, each allocated on its shard's device, and each appended
batch is split at shard boundaries and copied part by part into them, so no
tensor of the whole corpus is ever built (the sharded engines,
``parallel/sharded.py``). ``DeviceScatter`` writes rows at arbitrary
positions instead of at a cursor: the sharded IVF build
(``parallel/sharded_ivf.py``) commits each batch straight to its rows'
bucket slots.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


class ShardedArray:
    """A corpus array split along ``dim`` into equal shards over a mesh axis:
    ``shards[s]`` holds global rows ``[s * n_local, (s + 1) * n_local)`` of
    ``dim`` on shard s's device."""

    def __init__(self, shards: Sequence[torch.Tensor], dim: int):
        self.shards: List[torch.Tensor] = list(shards)
        self.dim = dim

    @classmethod
    def zeros(cls, shape, dtype: torch.dtype, devices, dim: int = 0) -> "ShardedArray":
        """Zero-filled shards of a global ``shape`` whose ``dim`` is a
        multiple of ``len(devices)``, shard s on ``devices[s]``."""
        local = list(shape)
        local[dim] //= len(devices)
        return cls([torch.zeros(local, dtype=dtype, device=d) for d in devices], dim)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_local(self) -> int:
        return self.shards[0].shape[self.dim]

    @property
    def shape(self) -> tuple:
        shape = list(self.shards[0].shape)
        shape[self.dim] *= self.n_shards
        return tuple(shape)

    def numpy(self) -> np.ndarray:
        """The whole array on the host (for tests and small corpora)."""
        return np.concatenate([t.cpu().numpy() for t in self.shards], axis=self.dim)


class DeviceAppender:
    """Append chunks along ``axis`` of a preallocated zero-filled buffer.

    Without ``mesh`` the buffer is one tensor on ``device``. With ``mesh``
    it is a :class:`ShardedArray` over the mesh axis ``mesh_axis``:
    ``shape[axis]`` must be a multiple of that axis's size, and ``finish``
    returns the shards."""

    def __init__(self, shape, dtype: torch.dtype, device=None, *, mesh=None,
                 mesh_axis: str = "shard", axis: int = 0):
        self._axis = axis
        self._cap = shape[axis]
        self._pos = 0
        if mesh is None:
            self._buf = torch.zeros(shape, dtype=dtype, device=device)
            self._sharded = None
        else:
            devices = mesh.shard_devices(mesh_axis)
            if self._cap % len(devices):
                raise ValueError(
                    f"DeviceAppender: axis {axis} of {self._cap} does not split into "
                    f"{len(devices)} shards")
            self._buf = None
            self._sharded = ShardedArray.zeros(shape, dtype, devices, axis)

    @property
    def pos(self) -> int:
        return self._pos

    def append(self, chunk: torch.Tensor) -> None:
        b = chunk.shape[self._axis]
        if self._pos + b > self._cap:
            raise ValueError(
                f"DeviceAppender overflow: {self._pos}+{b} > {self._cap}"
            )
        if self._sharded is None:
            self._buf.narrow(self._axis, self._pos, b).copy_(chunk)
        else:
            self._append_sharded(chunk, b)
        self._pos += b

    def _append_sharded(self, chunk: torch.Tensor, b: int) -> None:
        """Each part of ``chunk`` that falls in a shard goes into that
        shard's buffer on its device."""
        n_local = self._sharded.n_local
        lo, hi = self._pos, self._pos + b
        for s in range(lo // n_local, (hi - 1) // n_local + 1):
            a0, a1 = max(lo, s * n_local), min(hi, (s + 1) * n_local)
            part = chunk.narrow(self._axis, a0 - lo, a1 - a0)
            self._sharded.shards[s].narrow(self._axis, a0 - s * n_local, a1 - a0).copy_(
                part, non_blocking=True)

    def finish(self):
        """The full buffer, a tensor or a ShardedArray (rows past ``pos``
        keep the zero fill)."""
        buf = self._buf if self._sharded is None else self._sharded
        self._buf = self._sharded = None  # guard reuse
        self._cap = -1
        return buf


class DeviceScatter:
    """Scatter-commit sibling of ``DeviceAppender``: rows land at arbitrary
    positions ``idx`` along ``axis`` (0 or 1) of a preallocated zero-filled
    :class:`ShardedArray` over the mesh axis ``mesh_axis`` (a one-shard
    mesh for one device), not at a running cursor.

    Position p belongs to shard p // n_local, so a batch's rows split by
    their owning shard and each part is written on that shard's device
    (``index_copy_`` / ``index_add_``), and no tensor of the whole buffer
    is built. ``add`` accumulates instead of setting; on the card its float
    sums come in atomic order, so the IVF build sums its bucket means by
    one-hot products instead (``ops/ivf.add_onehot_sums``). ``fill_from``
    copies committed rows into duplicate positions, across shards where a
    source and its destination lie on different ones."""

    def __init__(self, shape, dtype: torch.dtype, *, mesh, mesh_axis: str = "shard",
                 axis: int = 0):
        if axis not in (0, 1):
            raise ValueError("DeviceScatter supports axis 0 or 1")
        self._axis = axis
        devices = mesh.shard_devices(mesh_axis)
        if shape[axis] % len(devices):
            raise ValueError(
                f"DeviceScatter: axis {axis} of {shape[axis]} does not split into "
                f"{len(devices)} shards")
        self._sharded = ShardedArray.zeros(shape, dtype, devices, axis)

    def _parts(self, idx):
        """(shard, positions in ``idx``, local positions) for each shard that
        ``idx`` (a host array of global positions) touches."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        nl = self._sharded.n_local
        owner = idx // nl
        order = np.argsort(owner, kind="stable")
        so = owner[order]
        bounds = np.flatnonzero(np.diff(so)) + 1
        for part in np.split(order, bounds):
            if part.size:
                s = int(owner[part[0]])
                yield s, part, idx[part] - s * nl

    def _commit(self, rows: torch.Tensor, idx, add: bool) -> None:
        for s, pos, local in self._parts(idx):
            dst = self._sharded.shards[s]
            part = rows.index_select(self._axis, torch.from_numpy(pos).to(rows.device))
            part = part.to(device=dst.device, dtype=dst.dtype, non_blocking=True)
            li = torch.from_numpy(local).to(dst.device)
            if add:
                dst.index_add_(self._axis, li, part)
            else:
                dst.index_copy_(self._axis, li, part)

    def scatter(self, rows: torch.Tensor, idx) -> None:
        """buf[idx] = rows along the scatter axis."""
        self._commit(rows, idx, add=False)

    def add(self, rows: torch.Tensor, idx) -> None:
        """buf[idx] += rows along the scatter axis (repeated positions sum)."""
        self._commit(rows, idx, add=True)

    def fill_from(self, dst, src) -> None:
        """buf[dst] = buf[src] along the scatter axis. Every source is read
        before any destination is written; the pairs are grouped by (source
        shard, destination shard), one gather and one copy a group."""
        dst = np.asarray(dst, np.int64).reshape(-1)
        src = np.asarray(src, np.int64).reshape(-1)
        shards, ax = self._sharded.shards, self._axis
        moves = []
        for sd, pos, dloc in self._parts(dst):
            for ss, spos, sloc in self._parts(src[pos]):
                a = shards[ss]
                vals = a.index_select(ax, torch.from_numpy(sloc).to(a.device))
                d = shards[sd]
                moves.append((d, torch.from_numpy(dloc[spos]).to(d.device),
                              vals.to(d.device, non_blocking=True)))
        for d, li, vals in moves:
            d.index_copy_(ax, li, vals)

    def finish(self) -> ShardedArray:
        """The buffer's shards."""
        buf = self._sharded
        self._sharded = None  # guard reuse
        return buf
