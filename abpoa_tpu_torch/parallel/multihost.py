"""Processes: per-process instance shards and a gather of the rendered
text on process 0, over ``torch.distributed``.

Counterpart of ``abpoa_tpu/parallel/multihost.py``. The instances are
independent, so no collective touches the DP: each process runs
``BatchPOA(devices=...)`` over its contiguous shard of the global
instance list on its own cards, renders each aligner's output (consensus
FASTA, MSA, GFA) and process 0 gathers the text in global order:

    process p:  BatchPOA over instances[shard_p]  (its local cards)
    all:        all_gather(shard text)            (two collectives a run)
    process 0:  concatenate in process order

The gather runs over gloo on host tensors: the rendered text is host
data, and gloo lets several processes share one card (NCCL would refuse
two ranks on one device).

Usage (one process per card or host; ``torchrun`` sets the env:// keys):

    from abpoa_tpu_torch.parallel import multihost as mh
    mh.initialize()                        # or init_method="file://..."
    out = mh.run_consensus_fasta(params, instances)   # str on process 0

The JAX version's ``engine=`` argument has no counterpart: the port has
one engine. ``python -m abpoa_tpu_torch.parallel.scaling --procs M``
spawns M local processes and compares their gathered output with a
one-process run.
"""
from __future__ import annotations

import dataclasses
import io
import os

import numpy as np
import torch

from ..params import Params

# seconds a process waits for the others at the rendezvous and in a
# collective
INIT_TIMEOUT_S = 600


def initialize(init_method=None, world_size=None, rank=None):
    """Bring up torch.distributed with the gloo backend (idempotent).
    init_method defaults to ``env://`` (MASTER_ADDR/PORT, WORLD_SIZE and
    RANK, as torchrun sets them); tests and the local launcher pass a
    ``file://`` store, which needs world_size and rank."""
    import datetime
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def _world() -> tuple[int, int]:
    """(world size, rank); (1, 0) without an initialised process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def shard_bounds(n: int, num_shards: int, shard: int) -> tuple[int, int]:
    """Contiguous block partition (shard sizes differ by at most 1)."""
    base, rem = divmod(n, num_shards)
    lo = shard * base + min(shard, rem)
    return lo, lo + base + (1 if shard < rem else 0)


def local_shard(instances):
    """This process's contiguous shard of the global instance list."""
    size, rank = _world()
    lo, hi = shard_bounds(len(instances), size, rank)
    return instances[lo:hi]


def gather_text(text: str) -> list[str] | None:
    """All-gather one UTF-8 string per process; process 0 gets the list
    in rank order, the others None. Two collectives over gloo: the
    lengths (int64), then max-padded uint8 buffers."""
    size, rank = _world()
    if size == 1:
        return [text]
    import torch.distributed as dist
    data = torch.from_numpy(np.frombuffer(text.encode(), np.uint8).copy())
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
    dist.all_gather(lens, torch.tensor([data.numel()], dtype=torch.int64))
    mx = max(max(int(n) for n in lens), 1)
    buf = torch.zeros(mx, dtype=torch.uint8)
    buf[:data.numel()] = data
    bufs = [torch.zeros(mx, dtype=torch.uint8) for _ in range(size)]
    dist.all_gather(bufs, buf)
    if rank != 0:
        return None
    return [bytes(b[:int(n)].numpy()).decode() for b, n in zip(bufs, lens)]


def local_devices(device=None) -> list[str]:
    """The device list of this process (the counterpart of the JAX
    version's ``_local_mesh``): ``"cpu"`` gives ["cpu"]; ``"cuda:i"``
    gives that card; by default (or ``"cuda"``) the cards this process
    owns among the host's local processes (LOCAL_RANK of
    LOCAL_WORLD_SIZE): ``cuda:{LOCAL_RANK % count}`` when the host runs
    as many processes as cards or more, else every card c with
    c % LOCAL_WORLD_SIZE == LOCAL_RANK (one process drives all cards)."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"]
    if device is not None and torch.device(device).index is not None:
        return [str(torch.device(device))]
    if not torch.cuda.is_available():
        raise RuntimeError("local_devices: no CUDA device; pass "
                           "device=\"cpu\" to run on the host")
    size, rank = _world()
    count = torch.cuda.device_count()
    lrank = int(os.environ.get("LOCAL_RANK", rank))
    lworld = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if lworld >= count:
        return [f"cuda:{lrank % count}"]
    return [f"cuda:{c}" for c in range(lrank, count, lworld)]


def run_render_gather(params: Params, instances, render, devices=None,
                      stats=None, seeded=False):
    """Run BatchPOA over this process's shard on `devices` (default
    ``local_devices()``), render each aligner's output with
    ``render(ab, params, out_io)`` and gather across processes.

    seeded: the shard runs the seeded window rounds (-S/-p,
    ``BatchPOA.run_seeded``). Returns the concatenated text (global
    instance order) on process 0, None elsewhere. ``stats`` (a dict)
    receives this process's shard_instances, wall_s, dp_cells, busy_s
    (``BatchPOA.dp_busy_seconds()``: the union of its device phases),
    fallbacks and rounds."""
    import time
    from .batch import BatchPOA
    mine = local_shard(instances)
    bp = BatchPOA(params, devices=local_devices() if devices is None
                  else devices)
    t0 = time.perf_counter()
    abs_ = bp.run_seeded(mine) if seeded else bp.run(mine)
    out = io.StringIO()
    for ab in abs_:
        render(ab, params, out)
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.update(shard_instances=len(mine), wall_s=dt,
                     dp_cells=bp.dp_cells, busy_s=bp.dp_busy_seconds(),
                     fallbacks=bp.fallbacks, rounds=bp.rounds)
    parts = gather_text(out.getvalue())
    return "".join(parts) if parts is not None else None


def _render_output(ab, params, out):
    """The reference's abpoa_output dispatch (consensus/MSA/GFA) per
    aligner (ref src/abpoa_align.c:346-362)."""
    ab.output(params, out)


def run_consensus_fasta(params: Params, instances, devices=None,
                        stats=None, seeded=False):
    """The distributed pipeline -> output text (consensus FASTA unless
    params asks for MSA or GFA) on process 0, None elsewhere."""
    if not (params.out_cons or params.out_msa or params.out_gfa):
        params = dataclasses.replace(params, out_cons=1)
    return run_render_gather(params, instances, _render_output,
                             devices=devices, stats=stats, seeded=seeded)
