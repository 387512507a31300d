"""Standalone Kahn FIFO sort with aligned grouping.

Counterpart of ``topo_batch`` / ``make_topo_kernel`` in
``abpoa_tpu/ops/poa_loop.py``. The CUDA kernel is ``csrc/topo.cu``;
``topo_batch_ref`` is its plain version (``graph_update.kahn_ref``, the
sort of the plain graph update). It is the second implementation that
the split device round (``poa_loop.device_round(split=True)``) holds the
graph kernel's sort against, so it shares no code with
``csrc/graph_update.cu``.

The kernel stages the instance's out-edge ids, aligned lists and counts
into shared memory as 16-bit ids, so the one thread that runs the sort
waits on shared-memory loads, and it walks a chain of single links on a
short path; an instance too large for a block's shared memory
(``staged``) runs a second instance of the kernel that reads the state
from device memory.

Per instance (ref src/abpoa_graph.c:186-231): from SRC, pop the FIFO
head, give it the next topological index, decrement its out-nodes'
in-degrees; a node whose in-degree reaches 0 is queued together with its
aligned list once every member is at in-degree 0. ``ok`` holds when SINK
is popped with ``node_n`` nodes sorted, and the instance's fail flag is
clear. Entries of i2n/n2i that the sort never wrote are 0.
"""
from __future__ import annotations

import torch

from . import layout as L
from ._build import check_launch, library

I32 = torch.int32


def staged(cfg) -> bool:
    """Whether ``csrc/topo.cu`` stages the state in shared memory at this
    geometry (the rule of ``topo_launch``: the in-degrees, the queue and
    two results as int32, the out-ids, aligned ids and counts as 16
    bits)."""
    R, E, A = cfg.R, cfg.E, cfg.A
    return (R <= 1 << 16 and E < 256 and A < 256
            and 4 * (2 * R + A + 3) + 2 * R * (E + A + 1)
            <= L.MAX_SMEM_BYTES)


def _check(cfg, st, name):
    B, R = st.bases.shape[0], cfg.R
    want = {"out_ids": (st.out_ids, (B, R, cfg.E)),
            "n_out": (st.n_out, (B, R)),
            "al_ids": (st.al_ids, (B, R, cfg.A)), "n_al": (st.n_al, (B, R)),
            "n_in": (st.n_in, (B, R)), "node_n": (st.node_n, (B,)),
            "fail": (st.fail, (B,))}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key}: shape {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != st.bases.device:
            raise ValueError(f"{name}: {key} on {t.device}")


def topo_batch(cfg, st):
    """Batched FIFO Kahn sort of a ``GState`` (``cfg`` a ``LoopConfig``).
    Returns (i2n [B, R], n2i [B, R], ok [B] bool).

    CUDA tensors launch ``csrc/topo.cu``; CPU tensors run the plain
    version."""
    dev = st.bases.device
    _check(cfg, st, "topo_batch")
    if dev.type == "cpu":
        return topo_batch_ref(cfg, st)
    if dev.type != "cuda":
        raise ValueError(f"topo_batch: unsupported device {dev}")
    B, R = st.bases.shape[0], cfg.R
    ins = [x.to(I32).contiguous() for x in (st.out_ids, st.n_out, st.al_ids,
                                             st.n_al, st.n_in, st.node_n,
                                             st.fail)]
    i2n = torch.zeros(B, R, dtype=I32, device=dev)
    n2i = torch.zeros(B, R, dtype=I32, device=dev)
    ok = torch.zeros(B, dtype=I32, device=dev)
    lib = library("topo")
    with torch.cuda.device(dev):
        rc = lib.topo_launch(*(t.data_ptr() for t in ins), i2n.data_ptr(),
                             n2i.data_ptr(), ok.data_ptr(), B, R, cfg.E,
                             cfg.A, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "topo")
    topo_batch.launches += 1
    return i2n, n2i, ok > 0


topo_batch.launches = 0


def topo_batch_ref(cfg, st):
    """Plain version of ``topo_batch`` (any device)."""
    from .graph_update import kahn_ref
    _check(cfg, st, "topo_batch_ref")
    i2n, n2i, ok = kahn_ref(cfg, st)
    return i2n, n2i, ok & (st.fail == 0)
