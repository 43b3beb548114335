"""Mixed precision: a two-batch ``fit`` of the plain narrow ResNet in
bfloat16 and float16, the port's against ``mxnet_tpu``'s on the CPU, with
the JAX side lowered as its XLA composition and as its Pallas kernels
(``test_torch_bf16.resnet_fit_matches_jax`` says what is held and
why).
"""
import pytest

from test_torch_bf16 import (HALVES, jax_tier,  # noqa: F401
                             resnet_fit_matches_jax)


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("fused", [False], ids=["plain"])
def test_resnet_bf16_fit_matches_jax(fused, dtype, jax_tier):
    resnet_fit_matches_jax(fused, dtype)
