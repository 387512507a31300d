"""Carry the JAX package's objects across to the port.

The device loop has no model weights; its "state" is the graph state
and the static tables. These helpers turn the JAX package's objects (its
``Params``, and anything ``np.asarray`` accepts, so JAX arrays too,
without importing JAX) into the port's own objects and tensors on a
given device, so tests can feed both packages from one source.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.poa_loop import GState, LoopConfig, PackedState
from .params import Params


def params(p) -> Params:
    """A JAX-package ``Params`` -> the port's, field by field (the
    derived score matrix is copied, so the two never share state); a
    field of the port's alone (``device``) keeps its default."""
    kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(Params)
          if hasattr(p, f.name)}
    if kw["mat"] is not None:
        kw["mat"] = np.array(kw["mat"], copy=True)
    return Params(**kw)


def tensor(x, device) -> torch.Tensor:
    """int32 tensor on `device` from any numpy-convertible array (e.g.
    ``make_scal_base``'s)."""
    return torch.from_numpy(np.array(np.asarray(x), dtype=np.int32,
                                     copy=True)).to(device)


def loop_config(cfg) -> LoopConfig:
    """A JAX ``LoopConfig`` -> the port's, ``wmode`` included (the TPU
    packing and probe fields G, GT, gk, abl, dv, gv and the unused
    use_zdrop have no counterpart)."""
    return LoopConfig(**{f: getattr(cfg, f) for f in LoopConfig._fields})


def gstate(st, device) -> GState:
    """A numpy (or JAX) GState -> the port's GState of tensors."""
    return GState(*(tensor(x, device) for x in st))


def packed_state(ps, device) -> PackedState:
    """A JAX PackedState -> the port's PackedState of tensors (the
    out-edge entries keep their layout: halves in wmode 0, full words
    in wmode 1)."""
    return PackedState(*(tensor(x, device) for x in ps))


def loop_inputs(st, i2n, n2i, remain, device):
    """``init_state_np``'s tuple -> (GState, i2n, n2i, remain) tensors."""
    return (gstate(st, device), tensor(i2n, device), tensor(n2i, device),
            tensor(remain, device))
