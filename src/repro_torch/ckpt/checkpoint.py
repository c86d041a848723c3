"""Fault-tolerant checkpointing — port of ``repro.ckpt.checkpoint``.

The on-disk format is the reference's, byte for byte, so a checkpoint
written by either package loads in the other:

* **Atomicity** — a step directory is staged as ``.tmp-<step>`` and
  ``os.replace``d into place only after every array and the manifest are
  written and the manifest fsynced; a crash mid-save never leaves a
  readable-but-corrupt latest.
* **Integrity** — every leaf carries a sha256 in ``manifest.json``;
  restore verifies it before returning.
* **Leaf names** — a tree of dicts, lists, tuples and named tuples is
  flattened as ``jax.tree_util`` flattens it (dict keys in sorted order,
  ``None`` holds no leaf), each leaf named by its sanitized key path
  (``['ward 1']['state'][0][1]`` → ``ward_1_state_0_1``), repeats
  disambiguated positionally with ``__k``.
* **bf16** — numpy has no bfloat16: a ``torch.bfloat16`` leaf is written
  as the reference writes an ``ml_dtypes.bfloat16`` array (descr
  ``'<V2'``, the 16-bit patterns, manifest dtype ``"bfloat16"``) and read
  back as a ``torch.bfloat16`` tensor.
* **Placement** — arrays are stored host-side; ``restore(device=...)``
  puts every leaf on a device as a tensor (the reference's
  ``shardings``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np
import torch

_LEAF_RE = re.compile(r"[^\w.-]+")
BF16 = "bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=""):
    """``[(key path, leaf), ...]`` in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    return [leaf for _, leaf in _flatten(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of each tree
    of ``rest``, in ``tree``'s structure (``jax.tree.map``)."""
    return tree_unflatten(tree, [fn(*xs) for xs in zip(
        tree_leaves(tree), *map(tree_leaves, rest), strict=True)])


def tree_unflatten(like, leaves):
    """``like``'s structure over ``leaves``, given in ``jax.tree_util``
    order."""
    return _unflatten(like, iter(leaves))


def _leaf_names(tree) -> list[str]:
    names = []
    for path, _ in _flatten(tree):
        name = _LEAF_RE.sub("_", path).strip("_")
        names.append(name or "leaf")
    # disambiguate duplicates deterministically
    seen: dict[str, int] = {}
    out = []
    for n in names:
        k = seen.get(n, 0)
        seen[n] = k + 1
        out.append(f"{n}__{k}" if k else n)
    return out


def _write_leaf(path: str, leaf) -> tuple[str, list[int]]:
    """Write one leaf as ``.npy``; returns (manifest dtype, shape)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape = tuple(t.shape)
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": shape})
                f.write(t.view(torch.int16).numpy().astype("<i2").tobytes())
            return BF16, list(shape)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return str(arr.dtype), list(arr.shape)


def save(directory: str, step: int, tree, *, meta=None) -> str:
    """Atomically save a tree as step-<step>/ under directory.

    ``meta``: optional JSON-serializable dict stored inside
    ``manifest.json``; it rides the same atomic rename as the arrays.
    Read it back with :func:`load_meta`.
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step-{step:010d}")
    tmp = os.path.join(directory, f".tmp-{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = [leaf for _, leaf in _flatten(tree)]
    names = _leaf_names(tree)
    manifest = {"step": step, "leaves": []}
    if meta is not None:
        # fail fast if not JSON
        manifest["meta"] = json.loads(json.dumps(meta))
    for name, leaf in zip(names, leaves):
        path = os.path.join(tmp, name + ".npy")
        dtype, shape = _write_leaf(path, leaf)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"].append({
            "name": name, "dtype": dtype, "shape": shape, "sha256": digest})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return [int(d.split("-")[1]) for d in os.listdir(directory)
            if d.startswith("step-")]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def _reinterpret(arr: np.ndarray, want: str, name: str, path: str):
    """Give a leaf its manifest dtype back on load.

    numpy reads a bf16 leaf as opaque ``V2`` records (``uint16`` where
    another writer stored the raw bits); the manifest remembers
    ``"bfloat16"``, so it becomes a ``torch.bfloat16`` tensor through an
    int16 view — bit-exact, the bytes on disk are the bytes that were
    checksummed.  Any other mismatch is an error.
    """
    if str(arr.dtype) == want:
        return arr
    if want == BF16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "Vu":
        bits = np.ascontiguousarray(arr).view("<i2")
        return torch.from_numpy(bits.astype(np.int16).reshape(
            arr.shape)).view(torch.bfloat16)
    raise IOError(f"cannot reinterpret {name} in {path} as {want!r}: "
                  f"stored as {arr.dtype}")


def place(leaf, device):
    """A restored leaf on ``device`` as a tensor (None: as it is)."""
    if device is None:
        return leaf
    if isinstance(leaf, np.ndarray):
        # ascontiguousarray returns at least 1-d: keep a 0-d leaf 0-d (an
        # AdamWState.step, say), as the reference restores it.
        leaf = torch.from_numpy(np.ascontiguousarray(leaf).reshape(
            leaf.shape))
    return leaf.to(device)


def load_meta(directory: str, step: int):
    """The ``meta`` dict a checkpoint was saved with, or None."""
    path = os.path.join(directory, f"step-{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("meta")


def restore(directory: str, step: int, like, device=None, *,
            partial: bool = False):
    """Restore into the structure of ``like``; verify checksums.

    Leaves come back as numpy arrays (bf16 leaves as ``torch.bfloat16``
    CPU tensors), or with ``device`` as tensors on that device.

    ``partial``: when True, ``like`` may name only a *subset* of the saved
    leaves (matched by flattened path name).  A leaf of ``like`` that the
    manifest doesn't know is still an error: partial restore narrows the
    read, it never invents data.  When False (the default), ``like`` must
    cover every saved leaf.
    """
    path = os.path.join(directory, f"step-{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = _leaf_names(like)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    if not partial and (missing := set(by_name) - set(names)):
        raise ValueError(
            f"like-tree misses {len(missing)} saved leaves (e.g. "
            f"{sorted(missing)[:3]}); pass partial=True for a subset "
            "restore")
    if partial:
        # The __k duplicate-name disambiguation is positional over the FULL
        # tree; a subset like-tree re-derives different positions, so a
        # name that was deduplicated at save time cannot be addressed
        # safely — refuse rather than silently return a sibling's data.
        for name in names:
            if f"{name}__1" in by_name or re.search(r"__\d+$", name):
                raise ValueError(
                    f"leaf name {name!r} was disambiguated positionally at "
                    "save time; a partial restore cannot address it safely "
                    "— restore the full tree or save under unique keys")
    leaves = []
    for name in names:
        try:
            entry = by_name[name]
        except KeyError:
            raise KeyError(
                f"leaf {name!r} not in checkpoint {path}"
                + (" (partial restore reads a subset, it cannot add leaves)"
                   if partial else "")) from None
        fpath = os.path.join(path, name + ".npy")
        with open(fpath, "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != entry["sha256"]:
            raise IOError(f"checksum mismatch for {name} in {path}")
        arr = _reinterpret(np.load(fpath), entry["dtype"], name, path)
        leaves.append(place(arr, device))
    return _unflatten(like, iter(leaves))


def resume_or_none(directory: str, like, device=None):
    """(step, tree) from the latest valid checkpoint, else None."""
    step = latest_step(directory)
    while step is not None:
        try:
            return step, restore(directory, step, like, device)
        except (IOError, FileNotFoundError, KeyError, ValueError):
            # corrupt/partial: fall back to the previous step
            older = [s for s in _steps(directory) if s < step]
            step = max(older) if older else None
    return None


def keep_last(directory: str, n: int = 3) -> None:
    """Garbage-collect old checkpoints, keeping the newest n."""
    if not os.path.isdir(directory):
        return
    steps = sorted(_steps(directory))
    for s in steps[:-n]:
        shutil.rmtree(os.path.join(directory, f"step-{s:010d}"),
                      ignore_errors=True)
