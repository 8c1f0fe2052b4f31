"""Atomic checkpoints of a train state, in the reference's layout.

The port of the reference's ``train/checkpoint.py`` for one card:

  * a checkpoint is a directory ``step_<10 digits>/`` with one ``.npy``
    file a leaf and a ``manifest.json`` (step, time, each leaf's shape and
    dtype); a leaf's file name is the reference's ``_leaf_path`` of the
    same tree (dict keys and ``TrainState`` field indices joined by dots,
    so ``0``, ``1.<param path>``, ``2.<state path>``), so either package
    restores the other's float32 / int32 checkpoints;
  * numpy has no bfloat16: a bfloat16 leaf is written as its uint16 bits
    with ``"dtype": "bfloat16"`` in the manifest;
  * writes go to ``<dir>/tmp.<step>.<pid>`` and are renamed to
    ``step_<k>`` when whole, so a crash mid-write never corrupts the latest
    checkpoint; the last ``keep`` are kept;
  * a restore casts each leaf to the template's dtype and moves it to the
    template's device.

On a rank mesh the state is this rank's blocks, and ``shardings`` (the
state's ``launch.mesh.state_shardings``) say how each is cut.
``save_checkpoint(..., shardings=)`` gathers every leaf and the mesh's rank
0 writes it, so the files are the global leaves, the same as an unsharded
save; ``restore_checkpoint(..., shardings=)`` reads each whole leaf's file
and keeps this rank's block, which may be on another mesh than the one
that saved it (the elastic restore).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _leaf_name(path) -> str:
    return _SAFE.sub("_", ".".join(str(p) for p in path))


def _children(tree):
    """``(key, child)`` pairs of a node in the reference's flattening
    order (a dataclass by field index, a dict by sorted key), or None for
    a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(i, getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def named_leaves(tree, path=()) -> list:
    """``(file name, leaf)`` of every leaf, in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(_leaf_name(path), tree)]
    return [nl for k, v in kids for nl in named_leaves(v, path + (k,))]


def _rebuild(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return None if tree is None else fn(_leaf_name(path), tree)
    new = {k: _rebuild(v, fn, path + (k,)) for k, v in kids}
    if isinstance(tree, dict):
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[i] for i in range(len(tree)))
    return dataclasses.replace(tree, **{
        f.name: new[i] for i, f in enumerate(dataclasses.fields(tree))})


def _to_numpy(leaf) -> tuple:
    """(array to save, manifest dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *,
                    keep: int = 3, shardings: Any = None) -> str:
    """Write ``state``; atomic rename; keep the last ``keep``.  With
    ``shardings`` every rank of the mesh calls it with its blocks: each
    leaf is gathered whole and written once, by the mesh's rank 0, and
    every rank returns when the checkpoint is in place."""
    if shardings is not None:
        return _save_sharded(ckpt_dir, step, state, keep, shardings)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "time": time.time(), "leaves": {}}
    for name, leaf in named_leaves(state):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    ckpts = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, old))
    return final


def sharded_leaves(tree, sh, path=()) -> list:
    """``(file name, leaf, sharding)`` of every leaf of ``tree`` beside
    its Sharding tree ``sh`` (the same structure, a record for a leaf)."""
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(_leaf_name(path), tree, sh)]
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        sub = lambda k: getattr(sh, names[k])  # noqa: E731
    else:
        sub = lambda k: sh[k]  # noqa: E731
    return [x for k, v in kids
            for x in sharded_leaves(v, sub(k), path + (k,))]


def _save_sharded(ckpt_dir, step, state, keep, shardings) -> str:
    from ..launch.mesh import gather_leaf
    leaves = sharded_leaves(state, shardings)
    mesh = leaves[0][2].mesh
    writer = not any(mesh.coords.values())
    # every rank takes part in every leaf's gather; rank 0 keeps each on
    # the host as it comes
    whole = {}
    for name, leaf, sh in leaves:
        t = gather_leaf(leaf, sh)
        if writer:
            whole[name] = t.cpu()
        del t
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if writer:
        final = save_checkpoint(ckpt_dir, step, _rebuild(
            state, lambda name, _leaf: whole.pop(name)), keep=keep)
    mesh.barrier()
    return final


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, template: Any, *,
                       shardings: Any = None) -> Any:
    """Restore into the structure of ``template``: each leaf cast to the
    template leaf's dtype, on its device (a leaf without a dtype keeps the
    saved one, on the CPU).  With ``shardings`` (a tree of
    ``core.executor.Sharding`` on a live mesh, which may differ from the
    mesh that saved) each rank keeps its block of every whole leaf, read
    from the file's memory map; a meta template leaf puts it on the
    mesh's device."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    sh = ({name: s for name, _, s in sharded_leaves(template, shardings)}
          if shardings is not None else {})

    def load(name, leaf):
        if name not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(os.path.join(path, name + ".npy"),
                      mmap_mode="r" if name in sh else None)
        if name in sh:
            arr = np.array(arr[sh[name].index(arr.shape)])  # a copy
        if manifest["leaves"][name]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if isinstance(leaf, torch.Tensor):
            dev = leaf.device
            if dev.type == "meta" and name in sh:
                dev = sh[name].mesh.device
            return t.to(device=dev, dtype=leaf.dtype)
        return t

    return _rebuild(template, load)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as fh:
        return int(json.load(fh)["step"])
