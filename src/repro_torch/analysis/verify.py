"""Artifact verifier for the port's packed sparse-runtime artifacts (port of
``repro.analysis.verify``).

Every checker here is host arithmetic over index arrays plus, for the
value checks, reductions on the tensors' own device: no kernel launch, no
schedule build, nothing written to the artifact. So it runs at pack time,
at admission (before the first launch of any kernel) and in CI. Checks
*re-derive* each invariant independently (the work-list live map is
recomputed from the chunk index table here, not read back through
:func:`~repro_torch.kernels.worklist_core.build_worklist`), so a bug in the
production schedule code cannot vouch for itself.

On the card the invariants decide more than a result: the walker (K1)
reads a work list's ``DeviceSchedule`` and the packed chunk ids as raw
offsets, and so do K3 and K4 the packed ``indices``. A chunk id out of range
or a device schedule that no longer matches its host copy faults the CUDA
context or gives silently wrong sums; these checks refuse such an artifact
first. What they prove:

* **Work-list well-formedness** — indices in range, flat schedule
  pair-major with ascending slot order, ``scheduled == live +
  flush_only`` with zero dead live entries, first/last flags framing each
  pair, ragged/flat agreement, (given the source chunk table) exact
  agreement with the recomputed §3.2 live map, and every device copy of
  the schedule (``WorkList._device``, ``WorkList._live``) equal to it.
* **Pack-chain legality** — fold permutations are true permutations and
  legal across the recorded ReLU/pool geometry, occupancy matches the
  stored values, the chunk layout divides the packed shapes, prune
  keep-maps match the dead chunks, work-list caches are fresh.
* **Kernel-config contracts** — tuned tile configs divide evenly and use
  strategies legal for the layout. On the card (tensors on a CUDA device,
  or ``device="cuda"``), the launches the config gives fit the H100's
  shared memory, use tilings the launches take and dtypes the kernels are
  built for; off the card the verdict is the reference's, rule for rule
  (its VMEM estimate and dtype set included), and the CPU path takes any
  tiling.

Index arrays come to the host (int32, small); value tensors never do: the
value checks return a count or a flag, and ``check_values=False`` reads no
value tensor at all.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.diagnostics import (Diagnostic, Severity, diag,
                                              register)
from repro_torch.kernels.grid import (ROW_BLOCK, check_row_block,
                                      grid_smem_bytes, tile_smem_bytes,
                                      walk_tiles)

# ---------------------------------------------------------------------------
# rule registry (the CLI --rules table renders from this)
# ---------------------------------------------------------------------------
E, W = Severity.ERROR, Severity.WARNING

register("WL-SHAPE", E, "work-list flat/ragged arrays agree in shape",
         "pack+admission+ci")
register("WL-RANGE", E, "schedule indices within the (nb, mb, max_nz) grid",
         "pack+admission+ci")
register("WL-PAIR-MAJOR", E, "flat schedule pair-major, slots ascending",
         "pack+admission+ci")
register("WL-COUNTS", E, "scheduled == live + flush-only, per-pair counts "
         "match the ragged lists", "pack+admission+ci")
register("WL-DEAD-STEP", E, "zero dead live entries; flush-only steps only "
         "for dead pairs", "pack+admission+ci")
register("WL-FIRST-LAST", E, "first/last flags frame each pair exactly",
         "pack+admission+ci")
register("WL-LIVE-MAP", E, "schedule equals the independently recomputed "
         "§3.2 live map (chunk table ∩ occupancy)", "pack+admission+ci")
register("WL-STALE-CACHE", E, "cached work lists consistent with the "
         "current packed chunk table, and every device copy of a schedule "
         "(the walker's DeviceSchedule, the plain version's live steps) "
         "equal to the host schedule it came from", "pack+admission+ci")
register("WL-CROSS-DEDUP", E, "cross-request combined schedule fetches "
         "each (stream, n_block, chunk) at most once per batch and covers "
         "exactly the union of per-image live pairs",
         "pack+admission+ci")

register("BS-SHAPE", E, "chunk layout divides the packed [K, N] shape",
         "pack+admission+ci")
register("BS-RANGE", E, "chunk ids in [-1, K // bk)", "pack+admission+ci")
register("BS-ORDER", E, "per-block chunk lists ascending, unique, "
         "live-first", "pack+admission+ci")
register("BS-PAD-VALS", E, "value tiles at -1 padding slots are zero",
         "pack+admission+ci")
register("BS-MASK-VALS", E, "bitmask popcounts match stored densities "
         "(every live tile holds a non-zero)", "pack+admission+ci")
register("BS-HOST-SYNC", E, "host chunk-index copy matches device indices",
         "pack+admission+ci")

register("PC-PERM", E, "balance fold is a true permutation of Cout",
         "pack+admission+ci")
register("PC-LAYOUT", E, "matrixization layout legal for the filter "
         "geometry", "pack+admission+ci")
register("PC-SHAPE", E, "packed shape matches the chunk-padded matrixized "
         "filters", "pack+admission+ci")
register("PC-REPACK", E, "packed occupancy/values match the dense filters "
         "(bitmask ↔ values consistency)", "pack+admission+ci")
register("PC-PRUNE-INFO", E, "chunk keep-map matches the dead chunks of "
         "the dense filters", "pack+admission+ci")
register("PC-DTYPE", E, "dtypes the kernels take (off the card the "
         "reference's fp32/bf16/fp16; on the card fp32, the conv kernels' "
         "type)", "pack+admission+ci")
register("PC-TUNED", E, "tuned tile config divides evenly, strategy legal "
         "for the layout, repack applied; on the card, a row block and "
         "n-block the launches take", "pack+admission+ci")
register("PC-VMEM", E, "tuned config inside the on-chip budget: on the "
         "card the shared memory its launches ask for within the H100's "
         "per-block limit; off the card the reference's VMEM estimate",
         "pack+admission+ci")
register("PC-SHARD", E, "cluster shard map a contiguous partition of the "
         "row blocks, mirrored on the packing, never worse-balanced than "
         "the contiguous split", "pack+admission+ci")
register("WL-SHARD-BAL", W, "per-device scheduled-step counts within the "
         "committed cluster-balance tolerance", "pack+admission+ci")

register("CH-GEOM", E, "fold legality across ReLU/pool: cout_i == "
         "cin_{i+1} (per-channel ops preserve the channel axis)",
         "pack+admission+ci")
register("CH-LAST-PERM", E, "last layer unpermuted (network outputs leave "
         "in canonical channel order)", "pack+admission+ci")
register("CH-WIRING", E, "a graph's layer reads and adds maps of earlier "
         "layers (or the image) only", "pack+admission+ci")
register("CH-ADD", E, "the two maps an add joins agree in shape and in "
         "channel permutation", "pack+admission+ci")

register("FF-ALIGN", E, "gated in/gate chunk lists share one slot axis",
         "pack+admission+ci")
register("FF-SHAPE", E, "FFN projection shapes chain (w_in N == w_out K); "
         "on the card, chunks the FFN kernels take", "pack+admission+ci")

#: Shared memory one CTA may opt into on an H100 (227 KiB,
#: ``cudaDevAttrMaxSharedMemoryPerBlockOptin``): the card's PC-VMEM budget.
SMEM_BUDGET_BYTES = 232448

#: The reference's VMEM budget per TPU core, which its PC-VMEM estimate is
#: held to; the port applies it off the card only, so that an artifact
#: checked there gets the reference's verdict.
VMEM_BUDGET_BYTES = 16 * 2 ** 20

#: Value types the conv kernels take on the card: K2 (``csrc/conv_grid.cu``)
#: is built for fp32 only, and K1 runs a conv layer on its fp32 maps.
CARD_CONV_DTYPES = (torch.float32,)


def _host(x) -> np.ndarray:
    """Host numpy of an index array: a device tensor is copied (int32,
    small); nothing is cached on the artifact."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    """A value array as a tensor where it lies (numpy on the CPU)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _on_card(device, *tensors) -> bool:
    """Whether the card rules apply: ``device`` names a CUDA device, or
    (``device`` None) one of ``tensors`` lies on one."""
    if device is not None:
        return torch.device(device).type == "cuda"
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


def _tile_flags(vals, valid: np.ndarray) -> Tuple[bool, int]:
    """``(a padding tile holds a non-zero, live tiles that are all zero)``
    of ``vals [nb, max_nz, bk, bn]`` under the host ``valid`` slot map: one
    reduction on ``vals``' device, two numbers back."""
    v = _tensor(vals)
    nb, nz = v.shape[:2]
    tile_nz = torch.count_nonzero(v.reshape(nb, nz, -1), dim=-1) > 0
    live = torch.as_tensor(valid, device=v.device)
    pad, empty = torch.stack([(tile_nz & ~live).any().long(),
                              (~tile_nz & live).sum()]).tolist()
    return bool(pad), int(empty)


def _card_chunk_problem(bk: int, bn: int) -> Optional[str]:
    """What the FFN grid kernels refuse of a chunk (``kernels/grid.py``'s
    ``lm_grid_problem``, its shape half)."""
    if bk % 8 or bn % 8 or bk > 248 or bn > 128:
        return (f"bk={bk}, bn={bn}: the FFN kernels take bk and bn "
                f"multiples of 8, bk <= 248 and bn <= 128")
    return None


# ---------------------------------------------------------------------------
# WorkList
# ---------------------------------------------------------------------------
def _recompute_live(indices: np.ndarray, mb: int,
                    occ_blk: Optional[np.ndarray]) -> np.ndarray:
    """Independent recompute of the §3.2 live map: live[n, m, j] = slot j
    of n-block stored ∧ activation block (m, chunk) occupied."""
    nb, max_nz = indices.shape
    valid = indices >= 0
    if occ_blk is None:
        return np.broadcast_to(valid[:, None, :], (nb, mb, max_nz)).copy()
    occ_blk = np.asarray(occ_blk, bool)
    safe = np.where(valid, indices, 0)
    return valid[:, None, :] & occ_blk[:, safe].transpose(1, 0, 2)


def _same_ints(t, host: np.ndarray, dtype: torch.dtype) -> bool:
    """Whether device copy ``t`` is exactly ``host`` in ``dtype`` (compared
    on ``t``'s device: the host array goes up, a flag comes back)."""
    host = np.asarray(host)
    return isinstance(t, torch.Tensor) and t.dtype == dtype and \
        tuple(t.shape) == host.shape and \
        torch.equal(t, torch.as_tensor(host, dtype=dtype, device=t.device))


def _verify_device_copies(wl, path: str) -> List[Diagnostic]:
    """WL-STALE-CACHE for the copies a work list keeps of itself on devices:
    each ``DeviceSchedule`` (what the walker reads: ``pair_ptr`` the
    exclusive cumulative sum of ``max(steps_per_pair, 1)``, and ``k``,
    ``j``, ``k2`` the host arrays, all int32) and each stream's live steps
    of the plain version (int64 ``n, m, k, j`` where the stream is live)."""
    out: List[Diagnostic] = []
    hint = ("drop the work list's device copies (or the work list) after "
            "changing its host schedule; the kernel reads the device copy")
    device = getattr(wl, "_device", {})
    if device:
        ptr = np.concatenate([[0], np.cumsum(np.maximum(
            np.asarray(wl.steps_per_pair).reshape(-1), 1))])
        for key, ds in sorted(device.items()):
            want = [("pair_ptr", ds.pair_ptr, ptr), ("k", ds.k, wl.k),
                    ("j", ds.j, wl.j)]
            bad = []
            if (ds.k2 is None) != (wl.k2 is None):
                bad.append("k2")
            elif wl.k2 is not None:
                want.append(("k2", ds.k2, wl.k2))
            bad += [name for name, got, host in want
                    if not _same_ints(got, host, torch.int32)]
            if bad:
                out.append(diag(
                    "WL-STALE-CACHE", f"{path}/device[{key}]",
                    f"device schedule {', '.join(bad)} != the host "
                    f"schedule it was copied from", hint=hint))
    for (key, stream), live in sorted(getattr(wl, "_live", {}).items()):
        ks = wl.k if stream == 0 else wl.k2
        ok = ks is not None and len(live) == 4
        if ok:
            sel = np.asarray(ks) >= 0
            host = (wl.n, wl.m, ks, wl.j)
            ok = all(_same_ints(t, np.asarray(h)[sel], torch.int64)
                     for t, h in zip(live, host))
        if not ok:
            out.append(diag(
                "WL-STALE-CACHE", f"{path}/live[{key}, {stream}]",
                f"stream {stream}'s live steps on {key} != the host "
                f"schedule's", hint=hint))
    return out


def verify_worklist(wl, *, indices: Optional[np.ndarray] = None,
                    gate_indices: Optional[np.ndarray] = None,
                    occ_blk: Optional[np.ndarray] = None,
                    path: str = "worklist") -> List[Diagnostic]:
    """Prove one :class:`~repro_torch.kernels.worklist_core.WorkList`
    well-formed, its device copies included.

    With ``indices`` (the [nb, max_nz] chunk table the schedule was built
    from — and ``gate_indices``/``occ_blk`` when they applied) the check
    is *exact*: the flat schedule must equal the independently recomputed
    live map.  Without them only the internal structure is checked.
    """
    out: List[Diagnostic] = []
    n, m = _host(wl.n), _host(wl.m)
    k, j = _host(wl.k), _host(wl.j)
    first, last = _host(wl.first), _host(wl.last)
    k2 = _host(wl.k2) if wl.k2 is not None else None
    spp = _host(wl.steps_per_pair)
    ragged = _host(wl.ragged_idx)
    nb, mb, max_nz = wl.nb, wl.mb, wl.max_nz
    T = n.shape[0]

    lens = {a.shape[0] for a in (n, m, k, j, first, last)}
    if k2 is not None:
        lens.add(k2.shape[0])
    if len(lens) != 1:
        out.append(diag("WL-SHAPE", path,
                        f"flat schedule arrays disagree in length: {lens}",
                        hint="rebuild via build_worklist"))
        return out            # nothing below is meaningful
    if spp.shape != (nb, mb) or ragged.shape[:2] != (nb, mb):
        out.append(diag("WL-SHAPE", path,
                        f"steps_per_pair {spp.shape} / ragged "
                        f"{ragged.shape} vs grid ({nb}, {mb})",
                        hint="rebuild via build_worklist"))
        return out

    bad = (n < 0) | (n >= nb) | (m < 0) | (m >= mb) | (j < -1) \
        | (j >= max_nz) | (k < -1)
    if k2 is not None:
        bad |= k2 < -1
    if bad.any():
        t = int(np.nonzero(bad)[0][0])
        out.append(diag(
            "WL-RANGE", path,
            f"step {t} outside the grid: n={n[t]} m={m[t]} j={j[t]} "
            f"k={k[t]} vs (nb={nb}, mb={mb}, max_nz={max_nz})",
            hint="schedule indices must index the packed chunk table and "
                 "the (n, m) pair grid"))

    pair = n.astype(np.int64) * mb + m
    if (np.diff(pair) < 0).any():
        t = int(np.nonzero(np.diff(pair) < 0)[0][0])
        out.append(diag(
            "WL-PAIR-MAJOR", path,
            f"flat schedule not pair-major at step {t + 1}: pair "
            f"{pair[t]} -> {pair[t + 1]}",
            hint="serialize pairs n-outer, m-inner (build_worklist order)"))
    same = np.diff(pair) == 0
    if ((np.diff(j) <= 0) & same & (j[1:] >= 0) & (j[:-1] >= 0)).any():
        out.append(diag(
            "WL-PAIR-MAJOR", path,
            "live slots within a pair are not strictly ascending in j",
            hint="the fp32 accumulation order contract requires ascending "
                 "slot order per pair"))

    live_flat = k >= 0
    if k2 is not None:
        live_flat = live_flat | (k2 >= 0)
    counts = np.bincount(pair, minlength=nb * mb)
    expect = np.maximum(spp.reshape(-1), 1)
    if counts.shape[0] > nb * mb or not (counts == expect).all():
        p = int(np.nonzero(counts[:nb * mb] != expect)[0][0]) \
            if counts.shape[0] <= nb * mb else nb * mb
        out.append(diag(
            "WL-COUNTS", path,
            f"pair {p} schedules {counts[p] if p < len(counts) else '?'} "
            f"steps, steps_per_pair says {expect[p] if p < nb * mb else '?'}",
            hint="every pair contributes max(live, 1) flat steps"))
    ragged_counts = (ragged >= 0).sum(-1).reshape(-1)
    if not (ragged_counts == spp.reshape(-1)).all():
        out.append(diag(
            "WL-COUNTS", path,
            "ragged_idx live-slot counts disagree with steps_per_pair",
            hint="ragged lists must hold exactly steps_per_pair live slots "
                 "then -1 padding"))
    n_live = int(live_flat.sum())
    n_flush = T - n_live
    n_dead_pairs = int((spp == 0).sum())
    if n_flush != n_dead_pairs:
        out.append(diag(
            "WL-COUNTS", path,
            f"scheduled != live + flush_only: {T} steps, {n_live} live, "
            f"{n_flush} flush-only vs {n_dead_pairs} dead pairs",
            hint="each dead pair degenerates to exactly one flush-only "
                 "step; live pairs schedule only live slots"))

    # dead live entries / flush-only placement
    dead_live = (j >= 0) & ~live_flat
    if indices is not None and k2 is None and occ_blk is None:
        # static single-stream schedule: a scheduled slot must be live
        if dead_live.any():
            t = int(np.nonzero(dead_live)[0][0])
            out.append(diag(
                "WL-DEAD-STEP", path,
                f"step {t} schedules slot j={j[t]} with no live chunk "
                f"(k={k[t]})",
                hint="dead slots must never be scheduled (§3.2: compact, "
                     "don't predicate)"))
    flushers = (j < 0)
    if (flushers & live_flat).any():
        t = int(np.nonzero(flushers & live_flat)[0][0])
        out.append(diag(
            "WL-DEAD-STEP", path,
            f"step {t} has j=-1 but a live chunk id k={k[t]}",
            hint="flush-only steps carry k == j == -1"))
    if flushers.any() and (spp.reshape(-1)[pair[flushers]] > 0).any():
        out.append(diag(
            "WL-DEAD-STEP", path,
            "flush-only step scheduled for a pair that has live work",
            hint="only dead (n, m) pairs degenerate to flush-only steps"))

    starts = np.ones(T, bool)
    starts[1:] = pair[1:] != pair[:-1]
    ends = np.ones(T, bool)
    ends[:-1] = pair[1:] != pair[:-1]
    if not ((first == 1) == starts).all() or not ((last == 1) == ends).all():
        out.append(diag(
            "WL-FIRST-LAST", path,
            "first/last flags do not frame each pair's steps",
            hint="first marks a pair's step 0 (accumulator init), last its "
                 "final step (flush) — the kernel zeroes/drains on these"))

    if indices is not None:
        indices = np.asarray(indices)
        live1 = _recompute_live(indices, mb, occ_blk)
        live = live1
        live2 = None
        if gate_indices is not None:
            gate_indices = np.asarray(gate_indices)
            live2 = _recompute_live(gate_indices, mb, occ_blk)
            live = live1 | live2
        sched = np.zeros_like(live)
        sel = j >= 0
        ok = sel & (n >= 0) & (n < nb) & (m < mb) & (j < live.shape[2])
        sched[n[ok], m[ok], j[ok]] = True
        if not (sched == live).all():
            miss = int((live & ~sched).sum())
            extra = int((sched & ~live).sum())
            out.append(diag(
                "WL-LIVE-MAP", path,
                f"schedule != recomputed live map: {miss} live slot(s) "
                f"missing, {extra} dead slot(s) scheduled",
                hint="rebuild the work list from the current chunk table "
                     "and occupancy (build_worklist)"))
        else:
            # per-step chunk ids must match the table the kernel indexes
            def check_stream(ks, idx, lv, tag):
                sl = sel & (ks >= 0)
                if (idx[n[sl], j[sl]] != ks[sl]).any():
                    out.append(diag(
                        "WL-LIVE-MAP", path,
                        f"{tag} chunk ids disagree with the chunk table",
                        hint="wl.k must equal indices[n, j] per scheduled "
                             "step"))
                lv_flat = lv[n[sel], m[sel], j[sel]]
                if ((ks[sel] >= 0) != lv_flat).any():
                    out.append(diag(
                        "WL-LIVE-MAP", path,
                        f"{tag} live flags disagree with the live map",
                        hint="a stream MACs at a slot iff its chunk is "
                             "stored and the activation block is occupied"))
            check_stream(k, indices, live1, "stream-1")
            if gate_indices is not None and k2 is not None:
                check_stream(k2, gate_indices, live2, "stream-2 (gate)")

    shard_of = getattr(wl, "shard_of", None)
    if shard_of is not None:
        from repro_torch.kernels.worklist_core import (SHARD_BALANCE_TOL,
                                                       per_shard_steps,
                                                       shard_imbalance)
        so = _host(shard_of)
        if so.shape != (nb,) or (so.size and so.min() < 0):
            out.append(diag(
                "WL-SHARD-BAL", path,
                f"shard_of shape {so.shape} does not map the {nb} row "
                f"blocks to devices",
                hint="rebuild via build_worklist(shard_of=packed.shard_of)"))
        elif int(so.max(initial=0)) > 0:
            per = per_shard_steps(wl)
            imb = shard_imbalance(per)
            if imb > SHARD_BALANCE_TOL + 1e-9:
                out.append(diag(
                    "WL-SHARD-BAL", path,
                    f"per-device scheduled steps {per.tolist()} imbalanced "
                    f"{imb:.3f} > tolerance {SHARD_BALANCE_TOL} (max/mean "
                    f"- 1)",
                    hint="re-run the pack-time cluster balance "
                         "(mesh_shard_assignment) — or accept the warning "
                         "when too few row blocks per device make the "
                         "bound unreachable"))

    for mpi, cs in sorted(getattr(wl, "_combined", {}).items()):
        out.extend(verify_combined_schedule(
            wl, cs, mb_per_img=mpi, path=f"{path}/combined[{mpi}]"))
    out.extend(_verify_device_copies(wl, path))
    return out


def verify_combined_schedule(wl, cs, *, mb_per_img: Optional[int] = None,
                             path: str = "combined") -> List[Diagnostic]:
    """Prove one cross-request :class:`~repro_torch.kernels.worklist_core.
    CombinedSchedule` against its flat schedule (WL-CROSS-DEDUP).

    The per-image live chunk sets are recomputed here from the work
    list's own flat arrays — never through ``WorkList.combined()`` — so
    the production dedup cannot vouch for itself. Invariants: no
    ``(stream, n_block, chunk)`` fetched twice within one combined batch
    schedule; the fetch set covers *exactly* the union of per-image live
    pairs; each fetch is made at the first step requesting its chunk;
    the request / per-image-baseline counters match the recount.
    """
    out: List[Diagnostic] = []
    mpi = cs.mb_per_img if mb_per_img is None else mb_per_img
    if mpi <= 0 or wl.mb % mpi or cs.images * mpi != wl.mb:
        out.append(diag(
            "WL-CROSS-DEDUP", path,
            f"image granularity broken: mb_per_img={mpi}, "
            f"images={cs.images} vs mb={wl.mb}",
            hint="mb must equal images * mb_per_img (whole images share "
                 "the batch)"))
        return out
    streams = [(0, _host(wl.k))]
    if wl.k2 is not None:
        streams.append((1, _host(wl.k2)))
    n, m = _host(wl.n), _host(wl.m)
    f_stream, f_n, f_k = (_host(cs.fetch_stream), _host(cs.fetch_n),
                          _host(cs.fetch_k))
    f_at = _host(cs.fetch_at)
    if not (f_stream.shape == f_n.shape == f_k.shape == f_at.shape):
        out.append(diag(
            "WL-CROSS-DEDUP", path,
            f"fetch arrays disagree in shape: {f_stream.shape} / "
            f"{f_n.shape} / {f_k.shape} / {f_at.shape}",
            hint="rebuild via WorkList.combined()"))
        return out
    fetch_keys = list(zip(f_stream.tolist(), f_n.tolist(), f_k.tolist()))
    if len(set(fetch_keys)) != len(fetch_keys):
        seen, dup = set(), None
        for fk in fetch_keys:
            if fk in seen:
                dup = fk
                break
            seen.add(fk)
        out.append(diag(
            "WL-CROSS-DEDUP", path,
            f"chunk (stream={dup[0]}, n={dup[1]}, k={dup[2]}) fetched "
            f"more than once within one combined schedule",
            hint="the cross-request plan must make one fetch per "
                 "distinct (n_block, chunk) per batch"))
    expected = set()
    per_image = 0
    requests = 0
    first_at = {}
    for sid, ks in streams:
        live = np.nonzero(ks >= 0)[0]
        requests += int(live.size)
        pairs = set()
        img_pairs = set()
        for t in live.tolist():
            key = (sid, int(n[t]), int(ks[t]))
            pairs.add(key)
            img_pairs.add((int(m[t]) // mpi,) + key)
            if key not in first_at:
                first_at[key] = t
        expected |= pairs
        per_image += len(img_pairs)
    missing = expected - set(fetch_keys)
    extra = set(fetch_keys) - expected
    if missing or extra:
        out.append(diag(
            "WL-CROSS-DEDUP", path,
            f"fetch plan != union of per-image live pairs: "
            f"{len(missing)} live chunk(s) never fetched, {len(extra)} "
            f"fetch(es) of dead chunks",
            hint="the deduped plan must cover exactly the distinct live "
                 "(stream, n_block, chunk) set of the flat schedule"))
    else:
        bad_at = [(fk, int(at)) for fk, at in zip(fetch_keys,
                                                  f_at.tolist())
                  if first_at.get(fk) != at]
        if bad_at:
            fk, at = bad_at[0]
            out.append(diag(
                "WL-CROSS-DEDUP", path,
                f"fetch for (stream={fk[0]}, n={fk[1]}, k={fk[2]}) made "
                f"at step {at}, first request is step {first_at[fk]}",
                hint="a fetch is made when the batch's first request "
                     "for the chunk arrives (§3.2 combining)"))
    if cs.requests != requests or cs.per_image_fetches != per_image:
        out.append(diag(
            "WL-CROSS-DEDUP", path,
            f"counters drifted: requests {cs.requests} vs {requests} "
            f"recounted, per_image_fetches {cs.per_image_fetches} vs "
            f"{per_image}",
            hint="the combine factor is measured from these — recount "
                 "from the flat schedule"))
    return out


# ---------------------------------------------------------------------------
# BlockSparseMatrix
# ---------------------------------------------------------------------------
def verify_block_sparse(mat, path: str = "packed", *,
                        check_values: bool = True) -> List[Diagnostic]:
    """Prove one :class:`~repro_torch.core.bitmask.BlockSparseMatrix`
    layout-legal and internally consistent (indices ↔ values ↔ host copy ↔
    wl_cache and its device copies). The indices the kernels read (the
    device ones) come to the host; ``check_values`` adds one reduction over
    the value tiles on their device."""
    out: List[Diagnostic] = []
    K, N = mat.shape
    bk, bn = mat.bk, mat.bn
    idx = _host(mat.indices)
    nb, max_nz = idx.shape

    if K % bk or N % bn or nb != N // bn:
        out.append(diag(
            "BS-SHAPE", path,
            f"chunk layout does not divide the shape: K={K} bk={bk}, "
            f"N={N} bn={bn}, n_blocks={nb}",
            hint="pad K/N to whole chunks before block_sparsify"))
        return out
    kb = K // bk
    vshape = tuple(mat.vals.shape)
    if vshape != (nb, max_nz, bk, bn):
        out.append(diag(
            "BS-SHAPE", path,
            f"vals shape {vshape} != (nb, max_nz, bk, bn) = "
            f"({nb}, {max_nz}, {bk}, {bn})",
            hint="repack via block_sparsify"))
        return out

    if ((idx < -1) | (idx >= kb)).any():
        bad = idx[(idx < -1) | (idx >= kb)][0]
        out.append(diag(
            "BS-RANGE", path,
            f"chunk id {int(bad)} outside [-1, {kb})",
            hint="chunk ids index K // bk chunks; -1 is padding"))
    valid = idx >= 0
    # live-first, ascending, unique per block
    live_first = (np.cumsum(~valid, 1) > 0) & valid
    if live_first.any():
        out.append(diag(
            "BS-ORDER", path,
            "live chunk id after a -1 padding slot",
            hint="pack live chunks first, then -1 padding "
                 "(block_sparsify order)"))
    d = np.diff(idx, axis=1)
    if ((d <= 0) & valid[:, 1:] & valid[:, :-1]).any():
        out.append(diag(
            "BS-ORDER", path,
            "per-block chunk list not strictly ascending",
            hint="ascending chunk order is the fp32 accumulation-order "
                 "contract all executors share"))

    if check_values:
        pad, n_empty = _tile_flags(mat.vals, valid)
        if pad:
            out.append(diag(
                "BS-PAD-VALS", path,
                "non-zero values stored at a -1 padding slot",
                hint="padding tiles must be zero — the gated union "
                     "schedule may MAC them"))
        if n_empty:
            out.append(diag(
                "BS-MASK-VALS", path,
                f"{n_empty} stored chunk tile(s) are all-zero",
                hint="bitmask popcount says live but values say dead — "
                     "repack so density() matches the stored values"))

    if mat.indices_np is not None:
        host = np.asarray(mat.indices_np)
        if host.shape != idx.shape or (host != idx).any():
            out.append(diag(
                "BS-HOST-SYNC", path,
                "indices_np (host schedule source) != device indices",
                hint="repack, or refresh via host_indices() after "
                     "mutating the device indices"))

    out.extend(_verify_wl_cache(mat.wl_cache, idx, path))
    return out


def _verify_wl_cache(cache: Dict, idx: np.ndarray, path: str
                     ) -> List[Diagnostic]:
    """Freshness of cached static work lists vs the current chunk table —
    the defect class where a re-pack (autotune bn change) leaves schedules
    built against the *old* packing in the cache — and of their device
    copies, which the walker reads."""
    out: List[Diagnostic] = []
    nb, max_nz = idx.shape
    for key, wl in sorted(cache.items(), key=lambda kv: str(kv[0])):
        p = f"{path}/wl_cache[{key}]"
        if (wl.nb, wl.max_nz) != (nb, max_nz) or wl.mb != key:
            out.append(diag(
                "WL-STALE-CACHE", p,
                f"cached schedule grid ({wl.nb}, {wl.mb}, {wl.max_nz}) != "
                f"current packing ({nb}, {key}, {max_nz})",
                hint="clear wl_cache after re-packing (autotune_conv does "
                     "this when bn changes)"))
            continue
        sub = verify_worklist(wl, indices=idx, path=p)
        errs = [d for d in sub if d.severity >= Severity.ERROR]
        if errs:
            out.append(diag(
                "WL-STALE-CACHE", p,
                f"cached schedule inconsistent with the current chunk "
                f"table ({len(errs)} violation(s), first: "
                f"[{errs[0].rule}] {errs[0].message})",
                hint="clear wl_cache after re-packing"))
    return out


# ---------------------------------------------------------------------------
# PackedConv + chains
# ---------------------------------------------------------------------------
def _perm_check(perm: np.ndarray, size: int, path: str,
                what: str) -> List[Diagnostic]:
    perm = np.asarray(perm)
    if perm.shape != (size,) or not (np.sort(perm) == np.arange(size)).all():
        return [diag(
            "PC-PERM", path,
            f"{what} is not a permutation of range({size}) "
            f"(shape {perm.shape})",
            hint="fold_permutation needs a true permutation — anything "
                 "else drops/duplicates channels in the next layer")]
    return []


def verify_packed_conv(pc, path: str = "conv", *,
                       check_values: bool = True, deep: bool = False,
                       device=None) -> List[Diagnostic]:
    """Prove one :class:`~repro_torch.sparsity.conv.PackedConv` pack-chain
    legal: permutation fold, layout, packed ↔ dense consistency, keep-map,
    tuned kernel-config contract.

    ``check_values`` adds the single-pass reduction over the *packed*
    values (padding zeros, live-tile popcounts) — cheap, on by default.
    ``deep=True`` additionally re-matrixizes the dense filters and proves
    the packed form is exactly their live tiles (``PC-REPACK``,
    ``PC-PRUNE-INFO``; the expected tiles go to the values' device and are
    compared there) — an O(dense-weights) reconstruction reserved for the
    CI zoo sweep, so the pack-time/admission gates stay cheap. The card
    rules apply where the packed tensors lie on a CUDA device or
    ``device`` names one."""
    # local import: sparsity.conv imports this module for strict mode
    from repro_torch.sparsity.conv import matrixize_filters

    out: List[Diagnostic] = []
    w = np.asarray(pc.w_dense)
    packed = pc.packed
    bk, bn = packed.bk, packed.bn
    card = _on_card(device, packed.vals, packed.indices)

    out.extend(_perm_check(pc.perm, pc.cout, f"{path}/perm",
                           "balance permutation"))

    if pc.layout not in ("channel", "tap"):
        out.append(diag("PC-LAYOUT", path,
                        f"unknown layout {pc.layout!r}",
                        hint="layouts: 'channel' | 'tap'"))
        return out
    if pc.layout == "tap" and pc.cin % bk != 0:
        out.append(diag(
            "PC-LAYOUT", path,
            f"tap layout with cin={pc.cin} % bk={bk} != 0 — a K-chunk "
            f"would straddle filter taps",
            hint="tap chunks must lie inside one tap (choose_chunk_layout "
                 "falls back to channel layout otherwise)"))
        return out

    kh, kw, cin, cout = w.shape
    exp_shape = (kh * kw * cin + (-kh * kw * cin) % bk,
                 cout + (-cout) % bn)
    if tuple(packed.shape) != exp_shape:
        out.append(diag(
            "PC-SHAPE", path,
            f"packed shape {packed.shape} != chunk-padded matrixized "
            f"filters {exp_shape}",
            hint="repack after any change to the dense filters"))
        return out
    out.extend(verify_block_sparse(packed, f"{path}/packed",
                                   check_values=check_values))
    # the layer's own schedule cache, the one the conv path fills and K1
    # reads (the reference checks only the packed matrix's)
    out.extend(_verify_wl_cache(pc.wl_cache, _host(packed.indices), path))

    w_mat = None
    if deep and not any(d.severity >= Severity.ERROR for d in out):
        w_mat = matrixize_filters(w, layout=pc.layout, bk=bk, bn=bn)
        K, N = w_mat.shape
        kb, nbl = K // bk, N // bn
        tiles = w_mat.reshape(kb, bk, nbl, bn)            # [kb, bk, nb, bn]
        occupied = (tiles != 0).any(axis=(1, 3)).T        # [nb, kb]
        idx = packed.indices_np if packed.indices_np is not None \
            else _host(packed.indices)
        # expected chunk map: live tiles compacted to the front, ascending
        pos = np.cumsum(occupied, axis=1) - 1             # slot per live tile
        exp_idx = np.full_like(idx, -1)
        nn, kk = np.nonzero(occupied)
        in_cap = pos[nn, kk] < idx.shape[1]
        exp_idx[nn[in_cap], pos[nn, kk][in_cap]] = kk[in_cap]
        mismatch = not in_cap.all() or (exp_idx != idx).any()
        if not mismatch and nn.size:
            # slot map proven equal — compare the live tiles where they lie
            vals = _tensor(packed.vals)
            got = vals[torch.as_tensor(nn, device=vals.device),
                       torch.as_tensor(pos[nn, kk], device=vals.device)]
            want = torch.as_tensor(tiles[kk, :, nn, :], device=vals.device)
            dt = torch.promote_types(got.dtype, want.dtype)
            mismatch = not torch.equal(got.to(dt), want.to(dt))
        if mismatch:
            out.append(diag(
                "PC-REPACK", path,
                "packed chunk map/values disagree with w_dense",
                hint="the packed form must be exactly the live tiles of "
                     "the matrixized dense filters — repack after pruning "
                     "or folding"))

    info = pc.prune_info
    if info is not None and pc.layout == "tap" and deep:
        w_info = w_mat if w_mat is not None and \
            (info.bk, info.bn) == (bk, bn) \
            else matrixize_filters(w, layout="tap", bk=info.bk, bn=info.bn)
        K, N = w_info.shape
        if info.keep.shape == (K // info.bk, N // info.bn):
            t = w_info.reshape(K // info.bk, info.bk, N // info.bn, info.bn)
            occ = (t != 0).any(axis=(1, 3))               # [kb, nb]
            if (occ & ~info.keep).any():
                out.append(diag(
                    "PC-PRUNE-INFO", path,
                    f"{int((occ & ~info.keep).sum())} non-zero tile(s) "
                    f"outside the chunk keep-map",
                    hint="the keep-map is the pruning contract — survivors "
                         "outside it defeat the dead-chunk schedule"))
            q = info.keep.sum(axis=0)
            if (np.asarray(info.quota) != q).any():
                out.append(diag(
                    "PC-PRUNE-INFO", path,
                    "per-bank quotas disagree with the keep-map",
                    hint="keep.sum(axis=0) must equal quota (bank-balance "
                         "bookkeeping)"))
        else:
            out.append(diag(
                "PC-PRUNE-INFO", path,
                f"keep-map shape {info.keep.shape} does not tile the "
                f"matrixized filters at (bk={info.bk}, bn={info.bn})",
                hint="prune_info must be re-cut when the layout changes"))

    if not np.issubdtype(w.dtype, np.floating) or w.dtype == np.float64:
        out.append(diag(
            "PC-DTYPE", f"{path}/w_dense",
            f"dtype {w.dtype} is not a legal dtype for the oracle path",
            hint="use float32 (or bf16/fp16) dense filters"))
    vd = packed.vals.dtype
    if not isinstance(vd, torch.dtype):
        vd = _tensor(packed.vals).dtype
    legal = CARD_CONV_DTYPES if card else \
        (torch.float32, torch.float16, torch.bfloat16)
    if vd not in legal:
        out.append(diag(
            "PC-DTYPE", f"{path}/packed",
            f"packed value dtype {vd} outside {legal}"
            + (" (the card's conv kernels)" if card else ""),
            hint="the conv kernels take fp32 tiles on the card (K2 is "
                 "built for fp32 only and K1 runs a layer on its fp32 "
                 "maps)" if card else
                 "the kernels accumulate in fp32 from narrow inputs; "
                 "integer or double tiles break the accumulation "
                 "contract"))

    out.extend(_verify_tuned(pc, path, card))
    out.extend(_verify_shard(pc, path))
    return out


def _verify_shard(pc, path: str) -> List[Diagnostic]:
    """Cluster-shard contract for a mesh-packed layer (PC-SHARD).

    The pack-time greedy balance (``mesh_shard_assignment``) commits to
    three invariants the sharded walker depends on: the assignment is a
    *contiguous* partition of the row blocks over the devices (the shard
    permutation was folded into the next layer, so device groups must be
    one block-contiguous slice each); the packing mirrors it
    (``packed.shard_of`` is what ``build_worklist`` threads into the
    schedules); and the balance is never worse than the plain contiguous
    equal split. Tolerance breaches are the *work list's* warning
    (WL-SHARD-BAL), not an error here: with too few row blocks per device
    no assignment can meet the bound.
    """
    shard = getattr(pc, "shard", None)
    packed = pc.packed
    p = f"{path}/shard"
    out: List[Diagnostic] = []
    if shard is None:
        if getattr(packed, "shard_of", None) is not None:
            out.append(diag(
                "PC-SHARD", p,
                "packed.shard_of set but the layer carries no ShardInfo",
                hint="pack with build_sparse_chain(mesh_devices=...) so "
                     "the assignment and its audit trail agree"))
        return out
    assign = np.asarray(shard.assign)
    nb = packed.n_blocks
    d = int(shard.num_devices)
    if assign.shape != (nb,) or d < 1:
        out.append(diag(
            "PC-SHARD", p,
            f"assign shape {assign.shape} / num_devices {d} does not "
            f"partition the {nb} row blocks",
            hint="one device id per packed row block"))
        return out
    counts = np.bincount(assign[(assign >= 0) & (assign < d)], minlength=d)
    if (assign < 0).any() or (assign >= d).any() or (counts == 0).any():
        out.append(diag(
            "PC-SHARD", p,
            f"assignment is not a partition over {d} devices "
            f"(per-device block counts {counts.tolist()})",
            hint="every device id in [0, D) must own at least one row "
                 "block"))
        return out
    if (np.diff(assign) < 0).any():
        out.append(diag(
            "PC-SHARD", p,
            "assignment is not block-contiguous",
            hint="the shard permutation folds into the next layer's cin "
                 "axis only when each device owns one contiguous slice of "
                 "row blocks"))
    so = getattr(packed, "shard_of", None)
    if so is None or not np.array_equal(np.asarray(so), assign):
        out.append(diag(
            "PC-SHARD", p,
            "packed.shard_of does not mirror the ShardInfo assignment",
            hint="build_worklist threads packed.shard_of into every "
                 "schedule — a mismatch splits the audit trail from the "
                 "walker"))
    steps = np.asarray(shard.block_steps)
    if steps.shape != (nb,) or (steps < 1).any():
        out.append(diag(
            "PC-SHARD", p,
            f"block_steps shape {steps.shape} illegal (need ({nb},), "
            f"all >= 1)",
            hint="each row block schedules max(live chunks, 1) steps"))
        return out
    if shard.mode not in ("greedy", "contiguous"):
        out.append(diag(
            "PC-SHARD", p, f"unknown shard mode {shard.mode!r}",
            hint="modes: 'greedy' | 'contiguous'"))
        return out
    if shard.mode != "greedy":
        # non-movable layers (last layer, ragged cout) take the plain
        # contiguous split — no balance contract to hold them to
        return out
    # the balance contract: never worse than a greedy LPT recompute (the
    # one baseline the verifier can reconstruct exactly: greedy LPT is
    # insensitive to the block order the folded permutation erased)
    cap = -(-nb // d)
    load = np.zeros(d)
    count = np.zeros(d, np.int64)
    for b in np.argsort(-steps, kind="stable"):
        open_d = np.nonzero(count < cap)[0]
        tgt = open_d[np.argmin(load[open_d])]
        load[tgt] += steps[b]
        count[tgt] += 1
    per = np.bincount(assign, weights=steps, minlength=d)

    def imb(c):
        mean = c.mean()
        return float(c.max() / mean - 1.0) if mean > 0 else 0.0

    if imb(per) > imb(load) + 1e-9:
        out.append(diag(
            "PC-SHARD", p,
            f"cluster balance contract broken: imbalance {imb(per):.3f} "
            f"worse than a greedy LPT recompute's {imb(load):.3f}",
            hint="mesh_shard_assignment must return at least the greedy "
                 "balance — re-run the pack-time cluster assignment"))
    return out


def card_launch_smem(pc, bm_rows: int, bn: int, elem_bytes: int = 4) -> int:
    """The most dynamic shared memory a launch for conv layer ``pc`` at row
    block ``bm_rows`` and n-block ``bn`` may ask for on the card, from the
    host models the wrappers launch with: the walker's tile mode (its
    widest ring, ``WALK_STAGES`` stages of tensor copies, and its 4-row
    threads' warp bands; the tap-slab operand asks for the same, or one
    stage), and where the FFN grid takes the chunk, the grid at either
    column group (K1's 8-row mode, and K2, which ``oracle_check`` runs)."""
    max_nz = pc.packed.max_nz
    tiles = walk_tiles(bm_rows, -(-pc.packed.shape[1] // bn), bm=bm_rows,
                       bn=bn, depth=0.0)
    need = tile_smem_bytes(tiles, elem_bytes, max_nz)
    if _card_chunk_problem(pc.packed.bk, bn) is None:
        need = max([need] + [grid_smem_bytes(elem_bytes, cg, pc.packed.bk,
                                             max_nz) for cg in (16, 32)])
    return need


def _verify_tuned(pc, path: str, card: bool = False) -> List[Diagnostic]:
    """Kernel-config contract for the autotuner's cached winner. On the
    card also the launch contract of the layer's config (its tuned one, or
    the default row block of 128 at the packing's ``bn``): a row block and
    n-block width the launches take (``check_row_block``, ``walk_tiles``)
    and shared memory within :data:`SMEM_BUDGET_BYTES`."""
    from repro_torch.kernels.worklist_core import DEFAULT_BM
    rec = pc.tuned
    if rec is None and not card:
        return []
    out: List[Diagnostic] = []
    p = f"{path}/tuned"
    bk, bn_pack = pc.packed.bk, pc.packed.bn
    bm_rows, bn = DEFAULT_BM, bn_pack          # the untuned launch
    if rec is not None:
        cfg = rec.config
        bm_rows = cfg.bm_rows
        bn = cfg.bn if cfg.bn is not None else bn_pack
        if cfg.bm_rows < 1 or cfg.sub_m < 1 or cfg.bm_rows % cfg.sub_m:
            out.append(diag(
                "PC-TUNED", p,
                f"bm_rows={cfg.bm_rows} must be a positive multiple of "
                f"sub_m={cfg.sub_m}",
                hint="the occupancy map is kept at sub_m-row granularity "
                     "inside each bm_rows block"))
        if cfg.bn is not None and cfg.bn != bn_pack:
            out.append(diag(
                "PC-TUNED", p,
                f"tuned bn={cfg.bn} but the layer is packed at "
                f"bn={bn_pack}",
                hint="autotune_conv(repack=True) re-packs at the winning bn "
                     "and drops the stale wl_cache — re-run it"))
        legal = ("taps", "lazy", "auto") if pc.layout == "tap" \
            else ("patches", "slices", "auto")
        if cfg.im2col not in legal:
            out.append(diag(
                "PC-TUNED", p,
                f"im2col={cfg.im2col!r} illegal for layout={pc.layout!r}",
                hint=f"legal strategies for this layout: {legal}"))
    if not card:
        # the reference's VMEM estimate: 2-color accumulator +
        # double-buffered x/w/out tiles
        est = 4 * (2 * bm_rows * bn          # §3.3 colored accumulators
                   + 2 * bm_rows * bk        # x tile (pipelined x2)
                   + 2 * bk * bn             # w tile (pipelined x2)
                   + 2 * bm_rows * bn)       # out tile (pipelined x2)
        if est > VMEM_BUDGET_BYTES:
            out.append(diag(
                "PC-VMEM", p,
                f"VMEM estimate {est / 2**20:.1f} MiB exceeds the "
                f"{VMEM_BUDGET_BYTES / 2**20:.0f} MiB budget "
                f"(bm_rows={bm_rows}, bn={bn}, bk={bk})",
                hint="shrink bm_rows/bn — the colored accumulators and "
                     "pipelined tiles must be VMEM-resident"))
        return out
    if rec is None:
        p = f"{path}/launch"
    if bm_rows < 1 or bn < 1 or bn > 128:
        out.append(diag(
            "PC-TUNED", p,
            f"bm_rows={bm_rows}, bn={bn}: the walker takes n-blocks of at "
            f"most 128 columns",
            hint="tune bn <= 128 (walk_tiles refuses wider n-blocks)"))
        return out
    try:
        check_row_block(bm_rows, bm_rows)
    except ValueError:
        out.append(diag(
            "PC-TUNED", p,
            f"bm_rows={bm_rows} neither divides nor is a multiple of "
            f"{ROW_BLOCK}: the dense-grid conv (K2) refuses it",
            hint="tune row blocks that divide or are a multiple of 32"))
    need = card_launch_smem(pc, bm_rows, bn)
    if need > SMEM_BUDGET_BYTES:
        out.append(diag(
            "PC-VMEM", p,
            f"a launch at bm_rows={bm_rows}, bn={bn}, bk={bk}, "
            f"max_nz={pc.packed.max_nz} asks for {need} bytes of shared "
            f"memory, over the card's {SMEM_BUDGET_BYTES} a block",
            hint="the CTA's live list grows with max_nz: repack at a wider "
                 "bk, or prune to fewer stored chunks per n-block"))
    return out


def verify_chain(chain: Sequence, path: str = "chain",
                 **kw) -> List[Diagnostic]:
    """:func:`verify_graph` on a sequential conv chain."""
    return verify_graph(chain, [None] * len(chain), [None] * len(chain),
                        path, **kw)


def verify_graph(convs: Sequence, srcs: Sequence[Optional[int]],
                 adds: Sequence[Optional[int]], path: str = "graph", *,
                 sides: Optional[Sequence[Tuple[Tuple[int, int],
                                                Tuple[int, int]]]] = None,
                 check_values: bool = True, deep: bool = False,
                 device=None) -> List[Diagnostic]:
    """Prove a graph of convs (``srcs[i]``: the layer whose output layer
    ``i`` reads, -1 the image, None the layer before; ``adds[i]``: the
    layer whose output it adds, or None) fold-legal by its edges, plus
    every layer individually: each layer reads and adds earlier maps
    (CH-WIRING), its cin is its source's cout (CH-GEOM), the two maps of an
    add carry the same channels in the same permutation and, with
    ``sides`` (per layer the conv's output sides and its map's sides after
    the pool), the same sides (CH-ADD); the last map leaves unpermuted
    (CH-LAST-PERM)."""
    out: List[Diagnostic] = []
    for i, pc in enumerate(convs):
        out.extend(verify_packed_conv(pc, f"{path}/layer{i}",
                                      check_values=check_values,
                                      deep=deep, device=device))
    for i, (pc, s, a) in enumerate(zip(convs, srcs, adds)):
        p = f"{path}/layer{i}"
        s = i - 1 if s is None else s
        if not -1 <= s < i or (a is not None and not 0 <= a < i):
            out.append(diag(
                "CH-WIRING", p, f"reads layer {s} and adds layer {a}",
                hint="a layer reads the image (-1) or an earlier layer's "
                     "output, and adds an earlier layer's output"))
            continue
        if s >= 0 and convs[s].cout != pc.cin:
            out.append(diag(
                "CH-GEOM", p, f"cin={pc.cin} reads layer{s} cout="
                              f"{convs[s].cout}",
                hint="a layer reads its source map's channels, in that "
                     "map's permutation"))
        if a is None:
            continue
        other = convs[a]
        same_perm = np.array_equal(np.asarray(other.perm),
                                   np.asarray(pc.perm))
        shape = (pc.cout,) + (tuple(sides[i][0]) if sides else ())
        shape_a = (other.cout,) + (tuple(sides[a][1]) if sides else ())
        if shape != shape_a or not same_perm:
            out.append(diag(
                "CH-ADD", p,
                f"adds layer{a}'s map {shape_a} to its own {shape}" +
                ("" if same_perm else " in another channel permutation"),
                hint="an add sums two maps channel by channel: both are "
                     "one shape, and the convs that write them permute "
                     "their channels alike (one permutation per group of "
                     "maps an add joins)"))
    if convs:
        last = np.asarray(convs[-1].perm)
        if last.shape == (convs[-1].cout,) and \
                (last != np.arange(convs[-1].cout)).any():
            out.append(diag(
                "CH-LAST-PERM", f"{path}/layer{len(convs) - 1}",
                "last layer carries a non-identity balance permutation",
                hint="no layer reads the last map: the network's outputs "
                     "would leave permuted"))
    return out


def verify_model(model, path: Optional[str] = None, *,
                 check_values: bool = True, deep: bool = False,
                 device=None) -> List[Diagnostic]:
    """Verify a :class:`~repro_torch.vision.model.VisionModel`'s packed
    convs by their edges (:func:`verify_graph`; where a layer adds, with
    each map's sides at the model's input size)."""
    from repro_torch.vision.model import layer_geometry, pooled_size
    p = path if path is not None else f"zoo/{model.name}"
    convs = [layer.conv for layer in model.layers]
    srcs = [layer.src for layer in model.layers]
    adds = [layer.add for layer in model.layers]
    sides = None
    if any(a is not None for a in adds) and all(
            -1 <= (i - 1 if s is None else s) < i and
            (a is None or 0 <= a < i)
            for i, (s, a) in enumerate(zip(srcs, adds))):
        geo = layer_geometry(model, model.input_size)
        sides = [((g["oh"], g["ow"]),
                  pooled_size(g["oh"], g["ow"], layer.pool_after))
                 for g, layer in zip(geo, model.layers)]
    return verify_graph(convs, srcs, adds, p, sides=sides,
                        check_values=check_values, deep=deep, device=device)


# ---------------------------------------------------------------------------
# FFN artifacts (SparseFFN and the sparsify_model packed leaves)
# ---------------------------------------------------------------------------
def verify_sparse_ffn(ffn, path: str = "ffn", *,
                      check_values: bool = True,
                      device=None) -> List[Diagnostic]:
    """Prove one :class:`~repro_torch.sparsity.sparse_ffn.SparseFFN`
    consistent: per-matrix layout, in/gate slot alignment, projection
    chaining, fold permutation; on the card, chunks the FFN kernels
    take."""
    out: List[Diagnostic] = []
    mats = [("w_in", ffn.w_in), ("w_out", ffn.w_out)]
    if ffn.w_gate is not None:
        mats.append(("w_gate", ffn.w_gate))
    for name, mat in mats:
        out.extend(verify_block_sparse(mat, f"{path}/{name}",
                                       check_values=check_values))
        problem = _card_chunk_problem(mat.bk, mat.bn) \
            if _on_card(device, mat.vals) else None
        if problem:
            out.append(diag("FF-SHAPE", f"{path}/{name}", problem,
                            hint="repack at a chunk the kernels take"))
    if ffn.w_gate is not None and (
            ffn.w_gate.max_nz != ffn.w_in.max_nz
            or ffn.w_gate.n_blocks != ffn.w_in.n_blocks):
        out.append(diag(
            "FF-ALIGN", path,
            f"in ({ffn.w_in.n_blocks}, {ffn.w_in.max_nz}) vs gate "
            f"({ffn.w_gate.n_blocks}, {ffn.w_gate.max_nz}) chunk "
            f"lists not aligned",
            hint="pack in/gate to one shared max_nz so the fused "
                 "kernel's slot axis aligns offline"))
    if ffn.w_in.shape[1] != ffn.w_out.shape[0]:
        out.append(diag(
            "FF-SHAPE", path,
            f"w_in N={ffn.w_in.shape[1]} != w_out K={ffn.w_out.shape[0]}",
            hint="the hidden (F) axis must chain through both packs"))
    F = np.asarray(ffn.perm).shape[0]
    out.extend(_perm_check(ffn.perm, F, f"{path}/perm",
                           "balance permutation"))
    return out


def verify_ffn_leaves(sp: Dict[str, Any], path: str = "ffn_sparse", *,
                      d_model: Optional[int] = None,
                      device=None) -> List[Diagnostic]:
    """Prove one period's ``sparsify_model`` packed-leaf dict admission-safe
    (``{role}_indices [nb, max_nz]``, ``{role}_vals [nb, max_nz, bk, bn]``
    for the roles ``in``, ``gate``, ``out``): index ranges, slot alignment,
    zero padding (one reduction on the values' device). With ``d_model``
    the in/gate chunk ids must also lie inside the input's chunks
    (``ceil(d_model / bk)``); on the card the chunks must be ones the FFN
    kernels take."""
    out: List[Diagnostic] = []
    roles = [r for r in ("in", "gate", "out") if f"{r}_indices" in sp]
    arrs = {r: (_host(sp[f"{r}_indices"]), sp[f"{r}_vals"])
            for r in roles}
    for r in roles:
        idx, vals = arrs[r]
        p = f"{path}/{r}"
        vshape = tuple(vals.shape)
        if idx.ndim != 2 or len(vshape) != 4 or vshape[:2] != idx.shape:
            out.append(diag(
                "BS-SHAPE", p,
                f"leaves disagree: indices {idx.shape}, vals {vshape}",
                hint="a period's leaves are [nb, max_nz] / "
                     "[nb, max_nz, bk, bn]"))
            continue
        bk, bn = vshape[2], vshape[3]
        if (idx < -1).any():
            out.append(diag("BS-RANGE", p, "chunk id below -1",
                            hint="-1 is the only padding value"))
        if d_model is not None and r != "out" and \
                (idx >= -(-d_model // bk)).any():
            out.append(diag(
                "BS-RANGE", p,
                f"chunk id {int(idx.max())} outside the input's "
                f"{-(-d_model // bk)} chunks (d_model {d_model}, bk {bk})",
                hint="in/gate chunk ids index the d_model axis, padded to "
                     "whole chunks"))
        valid = idx >= 0
        if ((np.cumsum(~valid, -1) > 0) & valid).any():
            out.append(diag(
                "BS-ORDER", p, "live chunk id after a -1 padding slot",
                hint="pack live chunks first (block_sparsify order)"))
        d = np.diff(idx, axis=-1)
        if ((d <= 0) & valid[..., 1:] & valid[..., :-1]).any():
            out.append(diag(
                "BS-ORDER", p,
                "per-block chunk list not strictly ascending",
                hint="ascending chunk order is the accumulation-order "
                     "contract"))
        if (~valid).any() and _tile_flags(vals, valid)[0]:
            out.append(diag(
                "BS-PAD-VALS", p,
                "non-zero values at -1 padding slots",
                hint="the gated union schedule may MAC padding tiles — "
                     "they must be zero"))
        problem = _card_chunk_problem(bk, bn) \
            if _on_card(device, vals) else None
        if problem:
            out.append(diag("FF-SHAPE", p, problem,
                            hint="pack with a chunk the kernels take "
                                 "(sparsify_model(chunk=...))"))
    if "gate" in arrs and "in" in arrs:
        if arrs["in"][0].shape != arrs["gate"][0].shape:
            out.append(diag(
                "FF-ALIGN", path,
                f"in {arrs['in'][0].shape} vs gate "
                f"{arrs['gate'][0].shape} chunk lists not aligned",
                hint="sparsify_model packs in/gate to one shared max_nz"))
    if "in" in arrs and "out" in arrs and \
            len(arrs["in"][1].shape) == 4 and len(arrs["out"][1].shape) == 4:
        nb_in = arrs["in"][0].shape[0]
        bn_in = arrs["in"][1].shape[3]
        # w_out's K axis must cover w_in's N axis (F, chunk-padded)
        f_in = nb_in * bn_in
        kb_out_needed = f_in // arrs["out"][1].shape[2]
        if arrs["out"][0].max(initial=-1) + 1 > kb_out_needed:
            out.append(diag(
                "FF-SHAPE", path,
                "out-projection chunk ids exceed the hidden (F) axis "
                f"({int(arrs['out'][0].max())} vs {kb_out_needed} chunks)",
                hint="the hidden axis must chain: w_in N == w_out K"))
    return out


def verify_param_leaves(params: Dict[str, Any], *,
                        d_model: Optional[int] = None,
                        device=None) -> List[Diagnostic]:
    """:func:`verify_ffn_leaves` over every packed FFN of a model's params
    (``params["blocks"][p]["p<i>"]["ffn_sparse"]`` and
    ``["channel_mix_sparse"]``, and an encoder-decoder's
    ``params["enc_blocks"]``), anchored at ``{stack}/{p}/p<i>/{leaf}``:
    the check ``sparsify_model(strict=True)`` and the ``Scheduler``'s
    admission gate run."""
    out: List[Diagnostic] = []
    for stack in ("blocks", "enc_blocks"):
        for p, period in enumerate(params.get(stack, ())):
            for pk, bp in period.items():
                for leaf in ("ffn_sparse", "channel_mix_sparse"):
                    if leaf in bp:
                        out.extend(verify_ffn_leaves(
                            bp[leaf], f"{stack}/{p}/{pk}/{leaf}",
                            d_model=d_model, device=device))
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def verify_artifact(obj, path: str = "artifact", *,
                    check_values: bool = True,
                    device=None) -> List[Diagnostic]:
    """Type-dispatched verification — the single entry point for any
    artifact."""
    from repro_torch.core.bitmask import BlockSparseMatrix
    from repro_torch.kernels.worklist_core import WorkList
    from repro_torch.sparsity.conv import PackedConv
    from repro_torch.sparsity.sparse_ffn import SparseFFN

    if isinstance(obj, WorkList):
        return verify_worklist(obj, path=path)
    if isinstance(obj, BlockSparseMatrix):
        return verify_block_sparse(obj, path, check_values=check_values)
    if isinstance(obj, PackedConv):
        return verify_packed_conv(obj, path, check_values=check_values,
                                  device=device)
    if isinstance(obj, SparseFFN):
        return verify_sparse_ffn(obj, path, check_values=check_values,
                                 device=device)
    if isinstance(obj, dict) and any(k.endswith("_indices") for k in obj):
        return verify_ffn_leaves(obj, path, device=device)
    if isinstance(obj, (list, tuple)) and obj and \
            isinstance(obj[0], PackedConv):
        return verify_chain(obj, path, check_values=check_values,
                            device=device)
    if hasattr(obj, "layers") and hasattr(obj, "input_size"):
        return verify_model(obj, path, check_values=check_values,
                            device=device)
    raise TypeError(f"no verifier for {type(obj).__name__}")
