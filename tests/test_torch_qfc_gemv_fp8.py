"""The dequant-fused matmul's GEMV route with float8_e4m3fn weights: its
emulated order against the JAX package's Pallas kernel in interpret mode
and the port's plain version on the CPU (``tests/test_torch_qfc_gemv.py``
describes the route, the emulation and the bound, and holds the int8
weights).
"""
import pytest

from test_torch_qfc_gemv import gemv_order_matches, on_grid


@on_grid
@pytest.mark.parametrize("storage", ["fp8"])
def test_gemv_order_matches_pallas_and_plain(storage, dtype, m, k, n):
    gemv_order_matches(storage, dtype, m, k, n)
