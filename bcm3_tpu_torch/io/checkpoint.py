"""Sampler-state checkpointing.

Counterpart of bcm3_tpu/io/checkpoint.py. The reference has no mid-run
checkpointing (SampleHandlerNetCDF.cpp:103-106); this module serializes
the full state of a `SamplerPT`: chain positions, log-densities,
acceptance counters, the history ring buffer with its shape, the
proposals (those the next run() starts from and those of the running
segment), the block structure, the spectral-clustering assigner, the
progress counters and the three random streams (the device
`torch.Generator`, the CPU choice generator and the host numpy
generator), so that a run continues exactly where it stopped.

The file is an uncompressed ``.npz`` of arrays plus one JSON ``meta``
entry, read back without pickle. It carries its own format tag and
version: a checkpoint of another version, or one written by the JAX
package (a pickle, whose arrays this package cannot load without JAX),
is refused with a message that names it. The write is atomic (a
temporary file in the same directory, then ``os.replace``).

A sharded run (sampler/pt.py under shard_over_devices) passes its rank's
`ChainBlock`: the per-chain arrays are gathered from every rank, the
primary rank writes the one complete file while the others wait at a
barrier (the JAX package gathers its globally sharded leaves the same
way, bcm3_tpu/io/checkpoint.py:25-37), and on restore each rank keeps its
rows. The file is the unsharded run's, so either kind of run resumes from
either kind's checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bcm3_tpu_torch import convert

FORMAT = "bcm3_tpu_torch.checkpoint"
CHECKPOINT_VERSION = 1

# the fields with a row per chain (the others hold one value, or one per
# ladder position, and are the same on every rank)
STATE_CHAIN_FIELDS = convert.STATE_FIELDS[:-2]
PROPOSAL_CHAIN_FIELDS = ("scales", "acc_ema", "selected")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _proposal_arrays(
    prefix: str, proposals, arrays: Dict[str, np.ndarray], rows
) -> List[dict]:
    meta = []
    for i, p in enumerate(proposals):
        for f in convert.PROPOSAL_FIELDS:
            v = getattr(p, f)
            arrays[f"{prefix}.{i}.{f}"] = _np(rows(v) if f in PROPOSAL_CHAIN_FIELDS else v)
        meta.append({m: getattr(p, m) for m in convert.PROPOSAL_META})
    return meta


def save_checkpoint(
    path: str,
    state,
    proposals: Sequence,
    blocks: Sequence[np.ndarray],
    emitted: int,
    adaptations_done: int,
    adaptation_iteration: int,
    *,
    live_proposals: Sequence,
    generators: Dict[str, torch.Generator],
    assigner=None,
    extra: Optional[Dict[str, Any]] = None,
    block=None,
):
    """Atomically write a checkpoint (tmp file + rename).

    `proposals` are those the next run() starts from, `live_proposals`
    those of the running segment (their per-chain scales, acceptance
    EMAs and last components); `generators` are saved by name with
    get_state(); `extra` must be JSON-serializable. With `block` (a
    sharded run's ChainBlock; every rank calls this) the per-chain rows
    are gathered and only the primary rank writes."""

    def rows(t):
        if block is None:
            return t
        from bcm3_tpu_torch.parallel import collectives

        return collectives.all_gather_rows(t[block.own])

    arrays: Dict[str, np.ndarray] = {}
    for f in STATE_CHAIN_FIELDS:
        arrays[f"state.{f}"] = _np(rows(getattr(state, f)))
    meta = {
        "format": FORMAT,
        "version": CHECKPOINT_VERSION,
        "emitted": int(emitted),
        "adaptations_done": int(adaptations_done),
        "adaptation_iteration": int(adaptation_iteration),
        "hist_adds": int(state.hist_adds),
        "swap_parity": int(state.swap_parity),
        "num_blocks": len(blocks),
        "proposals": _proposal_arrays("proposals", proposals, arrays, rows),
        "live_proposals": _proposal_arrays("live_proposals", live_proposals, arrays, rows),
        "assigner": None,
        "generators": sorted(generators),
        "extra": extra or {},
    }
    for i, b in enumerate(blocks):
        arrays[f"blocks.{i}"] = np.asarray(b)
    if assigner is not None:
        meta["assigner"] = {m: getattr(assigner, m) for m in convert.ASSIGNER_META}
        for f in convert.ASSIGNER_FIELDS:
            arrays[f"assigner.{f}"] = _np(getattr(assigner, f))
    for name, gen in generators.items():
        arrays[f"generator.{name}"] = _np(gen.get_state())
    arrays["meta"] = np.array(json.dumps(meta))
    if block is None:
        _write(path, arrays)
        return
    from bcm3_tpu_torch.parallel import collectives, distributed

    if distributed.is_primary():
        _write(path, arrays)
    collectives.barrier()  # the file is whole before any rank goes on


def _write(path: str, arrays: Dict[str, np.ndarray]):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _refuse_foreign(path: str, head: bytes):
    if head.startswith(b"\x80"):  # a pickle: the JAX package's format
        with open(path, "rb") as f:
            # its first object is the JAX package's PTState, named by module
            if b"bcm3_tpu" in f.read(1 << 20):
                raise ValueError(
                    f"{path} is a checkpoint of the JAX package (bcm3_tpu.io.checkpoint, "
                    "a pickle of JAX arrays); bcm3_tpu_torch cannot resume from it"
                )
    raise ValueError(f"{path} is not a {FORMAT} file")


def load_checkpoint(path: str, device, dtype: torch.dtype, block=None) -> Dict[str, Any]:
    """Read a checkpoint back: the state (the history with the shape it was
    saved with, in "history_shape"), proposals and assigner as tensors on
    `device` (real fields in `dtype`), the blocks, the counters, the
    generator states (uint8 tensors for set_state) and `extra`. With
    `block` the per-chain rows are this rank's (ChainBlock.cover)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if not head.startswith(b"PK"):
        _refuse_foreign(path, head)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} file")
    if meta.get("version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"{path} is a {FORMAT} of version {meta.get('version')}; this package "
            f"reads version {CHECKPOINT_VERSION}"
        )

    def group(prefix):
        return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + ".")}

    state_arrays = dict(group("state"), hist_adds=meta["hist_adds"],
                        swap_parity=meta["swap_parity"])
    history_shape = tuple(state_arrays["history"].shape)

    def rows(arrays):
        if block is None:
            return arrays
        return {k: block.cover(v) if k in STATE_CHAIN_FIELDS + PROPOSAL_CHAIN_FIELDS else v
                for k, v in arrays.items()}

    state = convert.pt_state_from_arrays(rows(state_arrays), device, dtype)

    def proposals(prefix):
        return [
            convert.block_proposal_from_arrays(rows(group(f"{prefix}.{i}")), m, device, dtype)
            for i, m in enumerate(meta[prefix])
        ]

    assigner = None
    if meta["assigner"] is not None:
        assigner = convert.cluster_assigner_from_arrays(group("assigner"), meta["assigner"], device)
    return {
        "state": state,
        "history_shape": history_shape,
        "proposals": proposals("proposals"),
        "live_proposals": proposals("live_proposals"),
        "blocks": [arrays[f"blocks.{i}"] for i in range(meta["num_blocks"])],
        "emitted": meta["emitted"],
        "adaptations_done": meta["adaptations_done"],
        "adaptation_iteration": meta["adaptation_iteration"],
        "assigner": assigner,
        "generators": {n: torch.from_numpy(arrays[f"generator.{n}"]) for n in meta["generators"]},
        "extra": meta["extra"],
    }

