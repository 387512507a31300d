"""abpoa_tpu_torch: the PyTorch + CUDA port of abpoa_tpu.

The package stands alone: it imports torch and never JAX, and nothing of
``abpoa_tpu``. It keeps its own copies of the host layers that fix the
output bytes (``params``, ``alphabet``, ``seqio``, ``cigar``, the graph
store and its native C core in ``graph``/``native``, ``consensus``,
``msa``, ``gfa``, the bit-exact oracle in ``align/engine_np``, ``api``)
and of the numpy export of the batched DP (``align/export``). The tests
hold those copies to the JAX package (oracle and export equality, the
golden files).

What ran on the TPU runs here through hand-written CUDA kernels
(``csrc/``) with a plain PyTorch version beside each (``ops/``), driven
by ``BatchPOA`` (``parallel/``) on two paths:
  * the device-resident loop (band DP in node-id mode + graph update) for
    global, banded, nucleotide batches with 16-bit scores;
  * the round-based path (topo-mode band DP or full-width DP per round)
    for local (``-m 1``), extend (``-m 2``), unbanded (``-b -1``),
    protein (``-c``), incremental (``-i``) and 32-bit-score batches.
The serial device engine (``align/engine_torch.py``) aligns one read at a
time on the card for the CLI (``cli.py``) and ``pyabpoa.py``.
"""
from .device import resolve_device
from .parallel.batch import BatchPOA, batch_msa_from_files

__version__ = "0.1.0"

__all__ = ["BatchPOA", "batch_msa_from_files", "resolve_device"]
