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

Keys are the port's tree paths (``models.model.path_key``:
``blocks/0/p0/ffn/w_in``, ``mu/embed``). Restoring under other shardings
(the reference's elastic restart) waits for the mesh port (ROADMAP A8b).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import flatten_tree, map_tree_with_path, \
    path_key

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


def save(path: str, step: int, params, opt_state=None,
         extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint of ``params`` (and ``opt_state``); returns the
    committed directory."""
    return _write(path, step, _to_host(params),
                  None if opt_state is None else _to_host(opt_state), extra)


def save_async(path: str, step: int, params, opt_state=None,
               extra: Optional[Dict] = None) -> threading.Thread:
    """Non-blocking :func:`save`: the device-to-host copy happens here (the
    only wait on the device), the serialisation in the returned thread;
    ``join`` it before reading the checkpoint."""
    host_params = _to_host(params)
    host_opt = None if opt_state is None else _to_host(opt_state)
    t = threading.Thread(target=_write, args=(path, step, host_params,
                                              host_opt, extra), daemon=True)
    t.start()
    return t


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under ``path`` (``.tmp`` saves are
    invisible), or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, step: int, params_template, opt_template=None, *,
            device="cuda"):
    """-> (params, opt_state or None, manifest): the checkpoint of ``step``
    loaded into the templates' structure and dtypes (meta tensors from
    ``models.model.abstract_params`` and ``optim.adamw.init`` serve) on
    ``device``."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(name, template):
        table = manifest["leaves"][name]
        raw = np.fromfile(os.path.join(d, f"{name}.bin"), dtype=np.uint8)

        def leaf(path, t):
            e = table[path_key(path)]
            dt = _np_dtype(e["dtype"])
            n = dt.itemsize * int(np.prod(e["shape"], dtype=np.int64))
            if n != e["nbytes"] or e["offset"] + n > raw.size:
                raise ValueError(f"{path_key(path)}: {e['dtype']} "
                                 f"{e['shape']} is {n} bytes, the manifest "
                                 f"says {e['nbytes']} at {e['offset']} of "
                                 f"{raw.size} in {name}.bin")
            arr = raw[e["offset"]:e["offset"] + n].view(dt) \
                .reshape(e["shape"])
            x = torch.from_numpy(arr)
            if e["dtype"] == "bfloat16":
                x = x.view(torch.bfloat16)
            return x.to(device=device, dtype=t.dtype)
        return map_tree_with_path(leaf, template)

    params = load("params", params_template)
    opt = None if opt_template is None else load("opt", opt_template)
    return params, opt, manifest
