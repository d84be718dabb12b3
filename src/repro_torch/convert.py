"""Carry state and reports across from the reference package.

With these the tests give both packages the same state, parameters and
masks: ``state_from_numpy`` turns the reference's state, as numpy arrays,
into the port's tensors (same names, same order), ``params_from_numpy``
does the same for a model's parameters and checks them against the port's
own ``init_params``, and ``report_from_masks`` builds a port report from
the reference's host masks.  None imports the reference package; the
reference's bf16 arrays arrive as any array with a ``bfloat16`` dtype name
and go through their raw bits.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._tensors import (alloc_device, from_host, itemsize,
                                  leaf_dtype_name)
from repro_torch.core.criticality import CriticalityReport, LeafReport
from repro_torch.core.policy import LeafPolicy
from repro_torch.core.regions import RegionTable
from repro_torch.models.model import init_params


def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True)          # the tensor owns its memory
    name = str(arr.dtype)
    if name == "bfloat16":                # numpy array of an ml_dtypes bf16
        return from_host(arr.view(np.uint16), name, device)
    return from_host(arr, name, device)


def state_from_numpy(tree: Any, device=None) -> Any:
    """The same pytree with every array leaf as a tensor on ``device``: the
    card unless the caller asks for the CPU."""
    device = alloc_device(device)
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [_leaf_from_numpy(l, device)
                                     for _, l in named])


def params_from_numpy(cfg, tree: Any, device=None) -> Any:
    """The reference's parameters for ``cfg`` (numpy arrays, bf16 through
    its bits) as the port's tensors on ``device`` (the card unless the
    caller asks for the CPU).  Raises when a leaf name, shape or dtype
    differs from the port's ``init_params`` tree."""
    device = alloc_device(device)
    want = {n: (tuple(l.shape), leaf_dtype_name(l)) for n, l in
            _tree.flatten_with_names(init_params(cfg, None,
                                                 device="meta"))[0]}
    got = {n: (tuple(np.shape(l)), str(np.asarray(l).dtype)) for n, l in
           _tree.flatten_with_names(tree)[0]}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"params_from_numpy: {cfg.name} parameters differ "
                         f"from the port's init_params tree: {diff[:6]}")
    return state_from_numpy(tree, device)


def report_from_masks(masks: Dict[str, np.ndarray], state: Any,
                      policy: LeafPolicy = LeafPolicy.AD
                      ) -> CriticalityReport:
    """A port report holding ``masks`` (flat bool, by leaf name) for the
    leaves of ``state``; a leaf without a mask is all critical."""
    leaves = {}
    for name, leaf in _tree.flatten_with_names(state)[0]:
        dt = leaf_dtype_name(leaf)
        n = int(np.prod(tuple(leaf.shape))) if len(leaf.shape) else 1
        mask = np.asarray(masks.get(name, np.ones(n, bool)),
                          bool).reshape(-1)
        leaves[name] = LeafReport(
            name=name, shape=tuple(leaf.shape), dtype=dt, policy=policy,
            mask=mask, table=RegionTable.from_mask(mask, itemsize(dt)),
            magnitude=None)
    return CriticalityReport(leaves=leaves)
