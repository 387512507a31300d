"""abpoa_tpu_torch: the PyTorch + CUDA port of abpoa_tpu's device layer.

The host layers that fix the output bytes (params, alphabet, seqio, the
graph store and its native C core, consensus, MSA/GFA emission, the
oracle aligner) are imported from ``abpoa_tpu``, never copied. This
package owns what ran on the TPU: the device-resident POA loop (banded
DP + graph update, ``ops/``) with hand-written CUDA kernels
(``csrc/``), and the batched driver (``parallel/``). It imports torch and
never JAX.
"""
from .device import resolve_device
from .parallel.batch import BatchPOA, batch_msa_from_files

__all__ = ["BatchPOA", "batch_msa_from_files", "resolve_device"]
