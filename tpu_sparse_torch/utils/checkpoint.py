"""Checkpoints of pytrees of tensors, for long-running solves.

Counterpart of ``tpu_sparse/utils/checkpoint.py``: the array leaves of a
pytree go to one ``.npz``, keyed by the leaf's path, and come back into
the structure of a template pytree. The keys are written as the JAX
package writes them (``"/".join(str(p) for p in path)``: ``['a']/[0]``,
``.field`` for a named tuple's field), so a checkpoint written by either
package loads in the other. ``None`` is an empty subtree, as in JAX: it
holds no leaf and stays ``None``. A loaded leaf lands on the template
leaf's device (the card for a card template) and is a tensor whatever the
template leaf was.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _path_key(path) -> str:
    return "/".join(str(p) for p in path)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().resolve_conj().numpy()
    return np.asarray(v)


def save_pytree(path: str, tree: Any) -> str:
    """Save all array leaves of ``tree`` to ``path`` (.npz)."""
    flat = pytree.tree_flatten_with_path(tree)[0]
    arrays = {_path_key(p): _host(v) for p, v in flat if v is not None}
    np.savez(path, **arrays)
    return path


def load_pytree(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like`` (same treedef)."""
    flat, spec = pytree.tree_flatten_with_path(like)
    leaves = []
    with np.load(path) as data:
        for p, v in flat:
            if v is None:
                leaves.append(None)
                continue
            key = _path_key(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            loaded = data[key]
            if isinstance(v, torch.Tensor):
                tmpl_shape = tuple(v.shape)
                tmpl_dtype = np.dtype(str(v.dtype).replace("torch.", ""))
                device = v.device
            else:
                tmpl_shape = tuple(np.shape(v))
                tmpl_dtype = np.asarray(v).dtype
                device = torch.device("cpu")
            if tuple(loaded.shape) != tmpl_shape:
                raise ValueError(
                    f"checkpoint leaf {key} has shape "
                    f"{tuple(loaded.shape)}, template expects {tmpl_shape} "
                    "(different grid size?)")
            if np.dtype(loaded.dtype) != tmpl_dtype:
                raise ValueError(
                    f"checkpoint leaf {key} has dtype {loaded.dtype}, "
                    f"template expects {tmpl_dtype} (different precision?)")
            leaves.append(torch.from_numpy(loaded).to(device))
    return pytree.tree_unflatten(leaves, spec)
