"""Checkpointing + restart manager, own copy of ``repro.ckpt.checkpoint`` in
PyTorch, in the same on-disk format: a checkpoint written by either package
restores in the other.

Each host writes its leaves to ``<dir>/step_<k:08d>.tmp/host<j>.npz`` and
host 0 a ``manifest.json`` (every leaf's path, logical axes, dtype and
shape, and the step); the commit is an atomic rename to ``step_<k:08d>``.
Paths are the tree's keys joined by ``/`` (dict keys sorted, lists in
order); in the npz ``/`` is ``|``, and the ``__dtypes__`` array holds
``path=dtype``.  numpy has no bf16 or float8, so those leaves are stored as
their uint16 / uint8 bit patterns and viewed back through torch's own
dtypes (no ``ml_dtypes``).  Dtypes carry numpy's names (``bfloat16``,
``float32``, ``int32``, ``float8_e4m3fn``, ...).

The port's parameter trees are plain tensors: the logical axes that the JAX
package keeps in each ``Param`` come to ``save`` as a separate tree
(``axes=``, e.g. ``{"params": models.param_axes(spec)}``); leaves it does
not cover are recorded with ``"axes": null``, as the JAX package records
its raw arrays (optimizer moments, ``step``, ``ef``).  ``save`` takes
DTensor leaves (a state placed on a mesh) and writes each whole, the same
bytes as for the plain state; every rank of the mesh must call it.
``restore`` places the leaves on one device, or, where ``shardings`` (a
tree of ``parallel.NamedSharding``) has an entry, as DTensors with those
placements, as ``jax.device_put`` does.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.common import whole


class CheckpointError(Exception):
    """Base class for checkpoint save/restore failures."""


class TemplateMismatchError(CheckpointError):
    """The restore template asks for a path the checkpoint lacks (or
    vice versa) — carries the first offending tree path."""

    def __init__(self, path: str, detail: str = ""):
        self.path = path
        suffix = f": {detail}" if detail else ""
        super().__init__(
            f"checkpoint/template structure mismatch at {path!r}{suffix}")


class ManifestMismatchError(CheckpointError):
    """A loaded array disagrees with the manifest's recorded dtype or
    shape — the checkpoint is corrupt or was rewritten out-of-band."""

    def __init__(self, path: str, field: str, expect, got):
        self.path = path
        super().__init__(
            f"manifest mismatch at {path!r}: {field} recorded as "
            f"{expect!r} but loaded {got!r}")


# torch dtype -> the name numpy (and ml_dtypes) gives it in the manifest
_NAMES = {torch.float64: "float64", torch.float32: "float32",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.float8_e4m3fn: "float8_e4m3fn",
          torch.float8_e5m2: "float8_e5m2", torch.int64: "int64",
          torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool"}
# dtypes numpy lacks, stored as their bit patterns: uint16 / uint8
_NPZ_VIEW = {"bfloat16": torch.uint16, "float8_e4m3fn": torch.uint8,
             "float8_e5m2": torch.uint8}


def _dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise CheckpointError(f"no checkpoint format for {dtype}") from None


def _to_storable(t: torch.Tensor) -> np.ndarray:
    """The leaf on the host as the numpy array the npz holds (a DTensor
    whole, gathered from its shards)."""
    t = whole(t).detach().cpu().contiguous()
    view = _NPZ_VIEW.get(_dtype_name(t.dtype))
    return (t.view(view) if view is not None else t).numpy()


def _from_storable(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(getattr(torch, dtype)) if dtype in _NPZ_VIEW else t


def _flatten(tree, seq=(list, tuple), path: str = "",
             out: Optional[list] = None) -> list[tuple[str, Any]]:
    """(path, leaf) of every leaf, dict keys sorted, ``seq`` in order; an
    axes tree passes ``seq=list``, so that its tuples are leaves.  (The
    recursions here are module-level functions: a nested function that
    calls itself is a reference cycle, which would hold the leaves until
    the garbage collector ran.)"""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], seq, f"{path}/{k}", out)
    elif isinstance(tree, seq):
        for i, v in enumerate(tree):
            _flatten(v, seq, f"{path}/{i}", out)
    else:
        out.append((path, tree))
    return out


def _unflatten_into(node, values: dict, device: torch.device,
                    path: str = ""):
    if isinstance(node, dict):
        return {k: _unflatten_into(v, values, device, f"{path}/{k}")
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_unflatten_into(v, values, device, f"{path}/{i}")
                          for i, v in enumerate(node))
    if node is None:
        return None
    try:
        value = values[path]
    except KeyError:
        raise TemplateMismatchError(
            path, "present in template, absent from checkpoint") from None
    return value if _is_dtensor(value) else value.to(device)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def save(ckpt_dir: str, step: int, state: dict, *, axes=None,
         host_id: int = 0, n_hosts: int = 1) -> str:
    """Write ``state`` (nested dicts/lists of tensors; None leaves allowed)
    for this host; atomic commit.  ``axes`` is a tree of logical-axes tuples
    for part of ``state`` (paths as in ``state``); the manifest records
    them, and null for every other leaf.  Returns the committed
    directory."""
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flatten(state)
    axes_of = {p: tuple(a) for p, a in _flatten(axes, seq=list)
               if a is not None}
    unknown = sorted(set(axes_of) - {p for p, n in flat if n is not None})
    if unknown:
        raise CheckpointError(f"axes given for paths the state lacks: "
                              f"{unknown[:3]}")
    os.makedirs(tmp, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    manifest = {"step": step, "entries": [], "n_hosts": n_hosts}
    for path, node in flat:
        if node is None:
            manifest["entries"].append({"path": path, "none": True})
            continue
        t = node if isinstance(node, torch.Tensor) else torch.as_tensor(node)
        ax = axes_of.get(path)
        if ax is not None and len(ax) != t.dim():
            raise CheckpointError(f"{path}: axes {ax} for a tensor of shape "
                                  f"{tuple(t.shape)}")
        dtypes[path] = _dtype_name(t.dtype)
        arrays[path] = _to_storable(t)
        manifest["entries"].append({
            "path": path,
            "axes": list(ax) if ax is not None else None,
            "dtype": dtypes[path],
            "shape": list(t.shape),
        })
    np.savez(os.path.join(tmp, f"host{host_id}.npz"),
             **{k.replace("/", "|"): v for k, v in arrays.items()},
             __dtypes__=np.asarray([f"{k}={dtypes[k]}" for k in arrays]))
    if host_id == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore(ckpt_dir: str, template: dict, *, step: Optional[int] = None,
            host_id: int = 0, device=None,
            shardings=None) -> tuple[dict, int]:
    """Load into the structure of ``template``; returns (state, step).
    Leaves keep the dtype they were saved in and land on ``device`` (the
    card unless ``"cpu"``), or, where ``shardings`` has a ``NamedSharding``
    at their path, on its mesh as DTensors with its placements (each rank
    keeps its own shard).  Paths the template lacks are not read into the
    state."""
    device = resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, f"host{host_id}.npz")) as data:
        dtypes = {}
        if "__dtypes__" in data.files:
            for ent in data["__dtypes__"]:
                k, _, dt = str(ent).partition("=")
                dtypes[k] = dt
        values = {}
        for k in data.files:
            if k == "__dtypes__":
                continue
            path = k.replace("|", "/")
            values[path] = _from_storable(data[k], dtypes.get(path, ""))
    _validate_manifest(d, values)
    if shardings is not None:
        from ..parallel.sharding import NamedSharding, place
        for k, sh in _flatten(shardings, seq=list):
            if isinstance(sh, NamedSharding) and k in values:
                values[k] = place(values[k], sh)
    return _unflatten_into(template, values, device), step


def _validate_manifest(step_dir: str, values: dict) -> None:
    """Check loaded arrays against the committed manifest (when this
    host can see one): dtype and shape per path must match what host 0
    recorded at save time — a disagreement means the checkpoint was
    corrupted or rewritten out-of-band, and restoring it would poison
    training silently."""
    mpath = os.path.join(step_dir, "manifest.json")
    if not os.path.exists(mpath):
        return
    with open(mpath) as f:
        manifest = json.load(f)
    for entry in manifest.get("entries", []):
        path = entry["path"]
        if entry.get("none") or path not in values:
            continue
        t = values[path]
        name = _dtype_name(t.dtype)
        if entry.get("dtype") and name != entry["dtype"]:
            raise ManifestMismatchError(path, "dtype", entry["dtype"], name)
        if entry.get("shape") is not None \
                and list(t.shape) != list(entry["shape"]):
            raise ManifestMismatchError(path, "shape", tuple(entry["shape"]),
                                        tuple(t.shape))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", f))]
    return max(steps) if steps else None


class CheckpointManager:
    """keep-N rotation + resume + (simulated) failure recovery."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, every: int = 100):
        self.dir = ckpt_dir
        self.keep = keep
        self.every = every
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, state: dict, **kw) -> Optional[str]:
        # step 0 is the init state — nothing trained yet, and a ckpt
        # there burns a keep-N slot before the first real save
        if step == 0 or step % self.every:
            return None
        path = save(self.dir, step, state, **kw)
        self._gc()
        return path

    def _gc(self):
        # keep=0 deletes nothing (steps[:-0] is empty), as in the JAX
        # package
        steps = sorted(int(re.fullmatch(r"step_(\d+)", f).group(1))
                       for f in os.listdir(self.dir)
                       if re.fullmatch(r"step_(\d+)", f))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def resume(self, template: dict, **kw) -> tuple[Optional[dict], int]:
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        state, step = restore(self.dir, template, step=step, **kw)
        return state, step
