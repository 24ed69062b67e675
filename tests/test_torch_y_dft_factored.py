"""K2's factored form (tpu_qg_torch.ops.dft_kernels.y_dft_factored_plain,
what csrc y_dft_factored_kernel computes) against K2's plain version and
against tpu_qg's Pallas y-DFT in interpret mode; the factored kernel's
shape rule and shared-memory layout; and y_dft's counts on the CPU.

Tolerances, relative to max|ref|: float64 against y_dft_plain 1e-12 (the
same transform, factored); float32 against PlanarFFT2._call_y 1e-5 (K2's
gate: float32 transforms of length <= 512).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg_torch.ops.dft_kernels import (SMEM_LIMIT, SM_SMEM, SMEM_RESERVED,
                                          Y_FACTORED_RB_BY_P,
                                          Y_FACTORED_THREADS, y_dft,
                                          y_dft_factored,
                                          y_dft_factored_layout,
                                          y_dft_factored_plain,
                                          y_dft_factored_takes, y_dft_plain)

POWERS = (256, 512, 1024, 2048, 4096, 8192)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _field(rows, P, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((2, rows, P)).astype(
        dtype)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("P", [256, 1024, 8192])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_factored_plain_matches_plain_float64(P, inverse):
    z = torch.from_numpy(_field(4, P, P + inverse))
    _close(y_dft_factored_plain(z, inverse), y_dft_plain(z, inverse), 1e-12)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_factored_plain_matches_pallas(inverse):
    M, P = 256, 512
    x = _field(M, P, 11 + inverse, np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_y(jnp.asarray(x), inverse)
    _close(y_dft_factored_plain(torch.from_numpy(x), inverse), want, 1e-5)


def test_factored_plain_round_trip():
    z = torch.from_numpy(_field(3, 2048, 5))
    _close(y_dft_factored_plain(y_dft_factored_plain(z, False), True), z,
           1e-12)


def test_takes_the_powers_of_two_from_256_to_8192():
    """The powers of two from 256 to 8192 and, by the mixed-radix form,
    the mixed extents 128 * n (384, 2432, 6144); not 128, 100, 16384 or
    128 * 65."""
    for P in POWERS + (384, 2432, 6144):
        assert y_dft_factored_takes(P)
    for P in (128, 100, 16384, 128 * 65):
        assert not y_dft_factored_takes(P)


def test_layouts_fit_shared_memory():
    """Every launched layout (Rb, threads) fits one block's shared memory;
    a layout outside the block sizes, with Rb not a power of two, or too
    large for a block, is refused."""
    assert set(Y_FACTORED_RB_BY_P) <= set(POWERS)
    for P, (rb, threads) in Y_FACTORED_RB_BY_P.items():
        lay = y_dft_factored_layout(P, rb, threads)
        assert lay == (P // 128, rb, threads, lay.smem)
        assert threads in Y_FACTORED_THREADS
        assert lay.smem <= SMEM_LIMIT
        assert y_dft_factored_takes(P, (rb, threads))
    assert not y_dft_factored_takes(2048, (3, 256))
    assert not y_dft_factored_takes(2048, (2, 128))
    assert not y_dft_factored_takes(8192, (4, 256))   # 278 KB


def test_layout_matches_the_kernel_at_8192():
    """P = 8192, Rb = 1: 64 p-rows of 135 float2 and the 32-, 64-, 64- and
    128-entry tables, 69.75 KB, the figure the kernel's source note gives:
    three blocks an SM."""
    lay = y_dft_factored_layout(8192, 1)
    assert lay.smem == 8 * (64 * 135 + 32 + 64 + 64 + 128) == 71424
    assert 3 * (lay.smem + SMEM_RESERVED) <= SM_SMEM
    assert 4 * (lay.smem + SMEM_RESERVED) > SM_SMEM


@pytest.mark.parametrize("P", [384, 2048])
def test_y_dft_on_cpu_takes_the_plain_version_and_counts_nothing(P):
    z = torch.from_numpy(_field(5, P, 3, np.float32))
    n = (y_dft.launches, y_dft.factored_launches)
    for inverse in (False, True):
        torch.testing.assert_close(y_dft(z, inverse), y_dft_plain(z, inverse),
                                   rtol=0, atol=0)
    assert (y_dft.launches, y_dft.factored_launches) == n


def test_factored_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError):
        y_dft_factored(torch.zeros((2, 4, 256)), False)
