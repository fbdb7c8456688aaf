"""Param checkpoints in the reference's format: flattened key-path ``.npz``
archives (``k:<name>|i:<idx>`` keys, no pickle), numpy only.

The port of ``repro/training/checkpoint.py``: an archive written here
loads in the reference's ``checkpoint.load`` and the reverse.  bfloat16
leaves are stored as the raw 2-byte records the reference's ``np.savez``
writes for ml_dtypes bfloat16 (``|V2``), and read back bit for bit.

A tree sharded over a device mesh is gathered leaf by leaf (a collective
every rank joins); rank 0 writes the archive one process writes, and the
other ranks write nothing.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as coll
from repro_torch.io import flatten, to_tensor, unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save(path: str, tree: Any) -> None:
    flat = flatten(tree)
    if coll.mesh_of_leaves(flat.values()) is not None:
        writer = dist.get_rank() == 0
        arrays = {}
        for k, v in flat.items():
            whole = v.full_tensor() if coll.is_sharded(v) else v
            if writer:
                arrays[k] = _to_numpy(whole)
            del whole
        if not writer:
            return
    else:
        arrays = {k: _to_numpy(v) for k, v in flat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load(path: str, template: Any) -> Any:
    """Restore into the structure, dtypes and devices of ``template``
    (shapes must match)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    want = flatten(template)
    out = {}
    with np.load(path, allow_pickle=False) as data:
        for key, leaf in want.items():
            t = to_tensor(data[key], leaf.device)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            out[key] = t.to(leaf.dtype)
    return unflatten(out)
