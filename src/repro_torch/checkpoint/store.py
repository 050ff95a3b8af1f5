"""Checkpoints: atomic, async-capable, mesh-agnostic, in ``repro``'s
on-disk format.

Each leaf of a state tree (nested dicts, named tuples, lists; None is an
empty subtree) is stored whole as a ``.npy`` beside a ``manifest.json``
that names it by ``repro``'s ``jax.tree_util.keystr`` path (dict keys
sorted, as ``jax.tree`` walks them), so a checkpoint written by either
package restores in the other.  A bfloat16 leaf has no numpy dtype
without ``ml_dtypes``: it is stored as its raw ``uint16`` bits with
``"dtype": "bfloat16"`` in the manifest, and a bfloat16 leaf that
``repro`` wrote (numpy's two-byte void) is read back through the same
bits.

A write goes to a temporary directory renamed into place, so a crash
never leaves a half checkpoint that :func:`latest_step` would pick.  The
host copies are made before the writer thread starts, so the caller may
go on changing its tensors; ``keep_last`` prunes older steps.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

_BF16 = "bfloat16"


def _flatten(tree, path: str = "") -> list[tuple[str, object]]:
    """``(keystr path, leaf)`` pairs in ``jax.tree``'s order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for f in tree._fields
                for pair in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(like, leaves):
    """``like``'s structure holding the next leaves of the iterator
    ``leaves``, consumed in :func:`_flatten`'s order."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(getattr(like, f), leaves)
                            for f in like._fields])
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # a copy on the CPU too
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3,
         blocking: bool = True) -> threading.Thread | None:
    """Write checkpoint ``step`` of ``tree``.  Returns the writer thread
    when ``blocking=False``."""
    pairs = _flatten(tree)
    host = [_to_host(leaf) for _, leaf in pairs]

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, ((path, _), (arr, dtype)) in enumerate(zip(pairs, host)):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({"path": path, "file": fn,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _prune(ckpt_dir, keep_last)

    if blocking:
        write()
        return None
    th = threading.Thread(target=write, daemon=True)
    th.start()
    return th


def _prune(ckpt_dir: str, keep_last: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like):
    """Checkpoint ``step`` in the structure of ``like``: each leaf on the
    device of ``like``'s leaf in its place (the CPU where that is no
    tensor), with the dtype it was saved in."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = _flatten(like)
    if len(manifest["leaves"]) != len(pairs):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"expected {len(pairs)}")
    out = []
    for rec, (path, ref) in zip(manifest["leaves"], pairs):
        t = _load(os.path.join(d, rec["file"]), rec["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {rec['path']}: checkpoint shape "
                             f"{tuple(t.shape)} != expected "
                             f"{tuple(ref.shape)}")
        dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        out.append(t.to(dev))
    return _rebuild(like, iter(out))


__all__ = ["save", "restore", "latest_step", "all_steps"]
