"""Fault-tolerant checkpoints (port of ``repro.ckpt.checkpoint``).

* Atomic commit: written to ``step_XXXXXXXX.tmp/``, then ``os.replace``d to
  ``step_XXXXXXXX/``; a crash mid-save never corrupts the newest
  checkpoint, and :func:`latest_step` never sees an incomplete one.
* The manifest records the step, the caller's extras and every leaf's
  dtype; the data pipeline is a pure function of the step, so resuming
  needs no data-loader state.
* Bitwise: each leaf is stored as its raw bits (numpy has no bfloat16, so
  a bf16 leaf is stored as its 16-bit pattern), one file per tree
  (``params.bin``, ``opt.bin``: the leaves back to back, each at a 64-byte
  aligned offset), and restored in the dtype the manifest names, then cast
  to the template's. Raw files in place of the reference's ``.npz``: a zip
  checksums every byte, which made saving and restoring 8 GB take ~2.5x
  as long.
* Async save: the device-to-host copy on the caller's thread, the
  serialisation in a thread, so the train loop is not blocked by the disk.

* Sharded (``DTensor`` leaves on a ``DeviceMesh``): a save gathers every
  leaf (a collective: every rank of the mesh calls it), the mesh's first
  rank writes and the others wait for the commit; the files are those of a
  solo save of the same values, byte for byte. A restore given
  ``shardings`` reads each rank's own block of every leaf from the raw
  file (the fixed offsets make it a strided read) and builds its DTensor,
  so a checkpoint saved on one mesh (or solo) restores onto any other (the
  reference's elastic restart).

Keys are the port's tree paths (``tree.path_key``:
``blocks/0/p0/ffn/w_in``, ``mu/embed``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.dist.partitioning import local_slices
from repro_torch.tree import flatten_tree, map_tree_with_path, path_key

Host = Dict[str, Tuple[np.ndarray, str]]
ALIGN = 64                      # bytes; each leaf's offset in its file


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(tree) -> Host:
    """{key: (raw numpy array, dtype name)}: the device-to-host copy (a
    copy on the CPU too, so a later in-place update of the params does not
    reach an async save)."""
    out: Host = {}
    for key, leaf in flatten_tree(tree).items():
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out[key] = (raw.to("cpu", copy=True).numpy(), _dtype_name(t.dtype))
    return out


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf of torch dtype ``name`` is stored as."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    dt = np.dtype(name)
    if _dtype_name(torch.from_numpy(np.zeros(0, dt)).dtype) != name:
        raise ValueError(f"unknown leaf dtype {name!r}")
    return dt


def _write(path: str, step: int, params: Host, opt: Optional[Host],
           extra: Optional[Dict]) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = {}
    for name, host in (("params", params), ("opt", opt)):
        if host is None:
            continue
        table, offset = {}, 0
        with open(os.path.join(tmp, f"{name}.bin"), "wb") as f:
            for key, (arr, dtype) in host.items():
                pad = -offset % ALIGN
                f.write(b"\0" * pad)
                offset += pad
                flat = np.ascontiguousarray(arr).reshape(-1)
                table[key] = {"dtype": dtype, "shape": list(arr.shape),
                              "offset": offset, "nbytes": flat.nbytes}
                f.write(flat.data)
                offset += flat.nbytes
        leaves[name] = table
    manifest = {"step": step, **(extra or {}), "leaves": leaves}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # the atomic commit
    return final


def _mesh_of(tree):
    """The mesh of the tree's DTensor leaves, or None."""
    for leaf in flatten_tree(tree).values():
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _writes(mesh) -> bool:
    """Whether this rank writes: solo, or the mesh's first rank."""
    return mesh is None or not any(mesh.get_coordinate())


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for every other (a barrier over each
    dim's group in turn: transitively all of them)."""
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


class SaveHandle:
    """What :func:`save_async` returns, joined as a thread: ``join()``
    waits for the write (on a mesh every rank calls it, and all wait for
    the commit)."""

    def __init__(self, thread: Optional[threading.Thread], mesh):
        self.thread, self.mesh = thread, mesh

    def join(self, timeout: Optional[float] = None) -> None:
        if self.thread is not None:
            self.thread.join(timeout)
        if self.mesh is not None:
            _barrier(self.mesh)

    def is_alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


def save(path: str, step: int, params, opt_state=None,
         extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint of ``params`` (and ``opt_state``); returns the
    committed directory (after the commit, on every rank of a mesh)."""
    mesh = _mesh_of(params)
    host_params = _to_host(params)
    host_opt = None if opt_state is None else _to_host(opt_state)
    final = os.path.join(path, f"step_{step:08d}")
    if _writes(mesh):
        final = _write(path, step, host_params, host_opt, extra)
    if mesh is not None:
        _barrier(mesh)
    return final


def save_async(path: str, step: int, params, opt_state=None,
               extra: Optional[Dict] = None) -> SaveHandle:
    """Non-blocking :func:`save`: the device-to-host copy happens here (the
    only wait on the device; on a mesh the gather, which every rank
    calls), the serialisation in a thread (on a mesh, the first rank's);
    ``join`` the handle before reading the checkpoint."""
    mesh = _mesh_of(params)
    host_params = _to_host(params)
    host_opt = None if opt_state is None else _to_host(opt_state)
    t = None
    if _writes(mesh):
        t = threading.Thread(target=_write, args=(path, step, host_params,
                                                  host_opt, extra),
                             daemon=True)
        t.start()
    return SaveHandle(t, mesh)


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under ``path`` (``.tmp`` saves are
    invisible), or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, step: int, params_template, opt_template=None, *,
            device="cuda", shardings=None, opt_shardings=None):
    """-> (params, opt_state or None, manifest): the checkpoint of ``step``
    loaded into the templates' structure and dtypes (meta tensors from
    ``models.model.abstract_params`` and ``optim.adamw.init`` serve) on
    ``device``.

    ``shardings`` / ``opt_shardings`` (trees of ``dist.partitioning.
    NamedSharding`` shaped as the templates: ``param_shardings``,
    ``adamw.opt_shardings``): each leaf becomes a DTensor of its sharding,
    this rank reading only its own block from the file."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(name, template, sh):
        table = manifest["leaves"][name]
        file = os.path.join(d, f"{name}.bin")
        size = os.path.getsize(file)

        def leaf(path, t, sharding=None):
            e = table[path_key(path)]
            dt = _np_dtype(e["dtype"])
            n = dt.itemsize * int(np.prod(e["shape"], dtype=np.int64))
            if n != e["nbytes"] or e["offset"] + n > size:
                raise ValueError(f"{path_key(path)}: {e['dtype']} "
                                 f"{e['shape']} is {n} bytes, the manifest "
                                 f"says {e['nbytes']} at {e['offset']} of "
                                 f"{size} in {name}.bin")
            shape = tuple(e["shape"])
            arr = np.memmap(file, dtype=dt, mode="r", offset=e["offset"],
                            shape=shape) if n else np.zeros(shape, dt)
            if sharding is not None:
                arr = arr[local_slices(sharding.mesh, sharding.placements,
                                       shape)]
            x = torch.from_numpy(np.array(arr))          # the read
            if e["dtype"] == "bfloat16":
                x = x.view(torch.bfloat16)
            x = x.to(device=device, dtype=t.dtype)
            if sharding is None:
                return x
            return DTensor.from_local(x, sharding.mesh, sharding.placements,
                                      run_check=False)
        if sh is None:
            return map_tree_with_path(leaf, template)
        return map_tree_with_path(leaf, template, sh)

    params = load("params", params_template, shardings)
    opt = None if opt_template is None else load("opt", opt_template,
                                                 opt_shardings)
    return params, opt, manifest
