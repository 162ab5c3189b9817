"""Step-atomic checkpointing with elastic restore (port of
``repro.checkpoint.manager``).

Layout (one directory per step, atomically renamed into place), the
reference's own, so either package restores what the other saved:

    <root>/step_000120/
        manifest.json      # leaf paths, files, dtypes, shapes, step, wall
                           # time, and the tree's structure ("treedef")
        leaf_00000.npy ... # one file per leaf (bf16 stored as u16)

A state is a tree of nested dicts of tensors.  Its leaves are taken in
sorted-key order, which is the order in which JAX flattens a dict, and each
is named by its keys joined with "/" (``params/decoder/layers/attn/wq``,
``opt/step``), as the reference names them.  ``restore`` matches leaves by
position, as the reference does, and also checks every manifest path and
shape against ``like``'s, raising on a mismatch.

Guarantees:
  * atomicity: a crash mid-save never corrupts the latest checkpoint
    (tmp dir + os.replace);
  * restart: restore() returns a state tree identical to what was saved;
  * host memory: ``save`` copies one leaf at a time from its device to the
    host, and ``restore`` loads one leaf at a time onto its placement, so
    the host never holds the whole state;
  * elasticity: restore(sharding=...) places each leaf on a given device,
    or distributes it over a ``DeviceMesh`` (full-array files are
    mesh-agnostic);
  * retention: keep_last_k garbage-collects old steps, never the newest.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# torch dtype <-> the manifest's dtype string (numpy's names; bf16 is
# stored as its 16 bits, u16)
_DTYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
           torch.float32: "float32", torch.float64: "float64",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def _flatten(tree: Any, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs of nested dicts in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    else:
        yield path, tree


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _treedef(tree: Any) -> str:
    """The nested keys of ``tree`` written as JAX's ``repr`` of a dict
    treedef writes them (``*`` for a leaf)."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{str(k)!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = leaf.detach()
    if t.dtype not in _DTYPES:
        raise TypeError(f"checkpoint: unsupported dtype {t.dtype}")
    dtype = _DTYPES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.cpu().numpy()
    if dtype == "bfloat16":
        arr = arr.view(np.uint16)
    return arr, dtype


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _place(t: torch.Tensor, placement, like_device) -> torch.Tensor:
    """``t`` (on the host) on its placement: a device, a ``(DeviceMesh,
    placements)`` pair, or None for ``like``'s device (the CPU where
    ``like`` is an abstract tensor on ``meta``)."""
    if placement is None:
        dev = like_device if like_device.type != "meta" else "cpu"
        return t.to(dev)
    if isinstance(placement, tuple):
        from torch.distributed.tensor import distribute_tensor
        mesh, placements = placement
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 list(placements))
    return t.to(placement)


class CheckpointManager:
    def __init__(self, root: str, keep_last_k: int = 3):
        self.root = root
        self.keep = keep_last_k
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any) -> str:
        tmp = os.path.join(self.root, f".tmp_step_{step:06d}_{os.getpid()}")
        final = os.path.join(self.root, f"step_{step:06d}")
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {
            "step": step, "time": time.time(), "leaves": []}
        for i, (path, leaf) in enumerate(_flatten(state)):
            arr, dtype = _to_host(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
            manifest["leaves"].append(
                {"path": "/".join(path), "file": fname, "dtype": dtype,
                 "shape": list(arr.shape)})
            del arr
        manifest["treedef"] = _treedef(state)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()
        return final

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.root, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, like: Any, step: Optional[int] = None,
                sharding: Any = None) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors, real
        or on ``meta``).

        ``sharding``: optional tree (matching ``like``) of placements, each
        a ``torch.device`` or a ``(DeviceMesh, placements)`` pair for
        ``torch.distributed.tensor.distribute_tensor``; without one a leaf
        lands on the device of ``like``'s leaf.  Dtypes are the saved
        ones."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:06d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = list(_flatten(like))
        if len(manifest["leaves"]) != len(flat_like):
            raise ValueError("checkpoint/like structure mismatch: "
                             f"{len(manifest['leaves'])} vs {len(flat_like)}")
        placements = ([p for _, p in _flatten(sharding)]
                      if sharding is not None else [None] * len(flat_like))
        if len(placements) != len(flat_like):
            raise ValueError("sharding/like structure mismatch: "
                             f"{len(placements)} vs {len(flat_like)}")
        out = []
        for rec, (path, leaf_like), sh in zip(manifest["leaves"], flat_like,
                                              placements):
            want = "/".join(path)
            if rec["path"] != want:
                raise ValueError(f"checkpoint leaf {rec['path']!r} where "
                                 f"like has {want!r}")
            if list(rec["shape"]) != list(leaf_like.shape):
                raise ValueError(f"checkpoint leaf {want!r}: shape "
                                 f"{rec['shape']} vs {list(leaf_like.shape)}")
            arr = np.load(os.path.join(d, rec["file"]), allow_pickle=False)
            out.append(_place(_from_host(arr, rec["dtype"]), sh,
                              leaf_like.device))
            del arr
        return _unflatten(like, iter(out))

    # --------------------------------------------------------------- gc
    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:06d}"),
                          ignore_errors=True)
