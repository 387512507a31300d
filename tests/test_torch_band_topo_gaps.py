"""abpoa_tpu_torch: the topo-mode band DP in affine and linear gap mode,
against the JAX kernel in interpret mode and, on a GPU, the CUDA kernel
against the plain version. Same rounds and checks as
test_torch_band_topo.py (split out to keep each file near a minute on
one core).
"""
import pytest

from test_torch_band_topo import (check_kernel_equals_ref,
                                  check_ref_equals_jax, cuda_device)  # noqa

CASES = ["affine", "linear"]


@pytest.mark.parametrize("case", CASES)
def test_band_topo_gaps_ref_equals_jax_interpret(case):
    check_ref_equals_jax(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_band_topo_gaps_kernel_equals_ref_on_gpu(case, cuda_device):
    check_kernel_equals_ref(case, cuda_device)
