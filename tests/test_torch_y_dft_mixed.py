"""K2's factored kernel on the mixed extents P = 128 * N2 (N2 not a power
of two): its emulation (tpu_qg_torch.ops.dft_kernels.y_dft_factored_emulated,
which runs csrc y_dft_mixed_kernel's pass plan, weights and digit reversal
with torch ops) and the factored plain version against K2's plain version
and against tpu_qg's Pallas y-DFT in interpret mode; the pass plan, the
digit reversal, the shape rule and the launched layouts.

Tolerances, relative to max|ref|: float64 against y_dft_plain 1e-12 (the
same transform, factored); float32 against PlanarFFT2._call_y 1e-5 (K2's
gate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_qg.ops.pallas_fft import PlanarFFT2
from tpu_qg_torch.ops.dft_kernels import (SMEM_LIMIT, SM_SMEM, SMEM_RESERVED,
                                          Y_FACTORED_RB_BY_P,
                                          Y_MIXED_PROWS, Y_REG_RADICES,
                                          y_dft, y_dft_factored_emulated,
                                          y_dft_factored_launched,
                                          y_dft_factored_layout,
                                          y_dft_factored_plain,
                                          y_dft_factored_takes,
                                          y_dft_mixed_plan, y_dft_mixed_rho,
                                          y_dft_plain)

MIXED_N2 = (3, 5, 6, 7, 9, 12, 15, 19, 24, 48, 61, 63)
FORMS = {"emulated": y_dft_factored_emulated, "plain": y_dft_factored_plain}


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


def _bitrev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n2", MIXED_N2)
def test_factored_forms_match_plain_float64(n2, inverse, form):
    P = 128 * n2
    z = torch.from_numpy(_field(3, P, n2 + 100 * inverse))
    _close(FORMS[form](z, inverse), y_dft_plain(z, inverse), 1e-12)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("P", [384, 2432])
def test_emulation_matches_pallas(P, inverse):
    M = 128
    x = _field(M, P, P + inverse, np.float32)
    want = PlanarFFT2(M, P, interpret=True)._call_y(jnp.asarray(x), inverse)
    _close(y_dft_factored_emulated(torch.from_numpy(x), inverse), want, 1e-5)


@pytest.mark.parametrize("n2", [6, 19, 63])
def test_emulation_round_trip(n2):
    z = torch.from_numpy(_field(2, 128 * n2, 7 * n2))
    _close(y_dft_factored_emulated(y_dft_factored_emulated(z, False), True),
           z, 1e-12)


def test_plans_multiply_out_and_order_their_radices():
    """Every N2 = 2^c m <= 64 (m odd > 1): 2^c first as one register
    radix, then 3s, 5s and 7s, then at most one prime >= 11, last."""
    for n2 in range(3, 65):
        if n2 & (n2 - 1) == 0:
            continue
        plan = y_dft_mixed_plan(n2)
        assert int(np.prod(plan)) == n2
        regs = [r for r in plan if r in Y_REG_RADICES]
        primes = [r for r in plan if r not in Y_REG_RADICES]
        assert list(plan) == regs + primes and len(primes) <= 1
        assert all(all(r % d for d in range(2, r)) and r >= 11
                   for r in primes)
        assert [r for r in regs if r & (r - 1) == 0] == (
            [n2 & -n2] if n2 % 2 == 0 else [])
        assert regs == sorted(regs, key=lambda r: (r & (r - 1) != 0, r))
        assert len(plan) <= 4


def test_rho_is_a_permutation_and_bitrev_on_powers_of_two():
    for n2 in range(2, 65):
        rho = y_dft_mixed_rho(y_dft_mixed_plan(n2))
        assert sorted(rho) == list(range(n2))
        if n2 & (n2 - 1) == 0:
            bits = n2.bit_length() - 1
            assert list(rho) == [_bitrev(p, bits) for p in range(n2)]
    # A mixed plan's digits: 12 = (4, 3), p = 3 b0 + b1 -> k2 = b0 + 4 b1.
    assert list(y_dft_mixed_rho((4, 3))) == [
        b0 + 4 * b1 for b0 in range(4) for b1 in range(3)]


def test_takes_every_128_n_from_256_to_8192():
    for n2 in range(1, 66):
        assert y_dft_factored_takes(128 * n2) == (2 <= n2 <= 64)
    for P in (100, 130, 2431, 16384):
        assert not y_dft_factored_takes(P)


def test_mixed_layouts_fit_and_meet_the_row_rule():
    """Every mixed extent's launched layout fits one block's shared memory,
    with Rb N2 >= Y_MIXED_PROWS >= 16 (the p-row bank argument), Rb the
    least such power of two, 256 threads; the power-of-two extents keep
    Y_FACTORED_RB_BY_P."""
    for n2 in range(3, 64):
        P = 128 * n2
        if n2 & (n2 - 1) == 0:
            continue
        rb, threads = y_dft_factored_launched(P)
        lay = y_dft_factored_layout(P, rb, threads)
        assert lay.smem <= SMEM_LIMIT and threads == 256
        assert rb * n2 >= Y_MIXED_PROWS >= 16 and (
            rb == 1 or rb * n2 // 2 < Y_MIXED_PROWS)
        # N2 p-rows of 135 float2 a row, the N2-, 64-, 64- and 2 N2-entry
        # tables, the two N2-entry int maps and the prime pass's weights.
        prime = [r for r in y_dft_mixed_plan(n2) if r not in Y_REG_RADICES]
        h = prime[0] // 2 if prime else 0
        assert lay.smem == (8 * (rb * n2 * 135 + 3 * n2 + 128 + h * (h + 1))
                            + 8 * n2)
        # Three blocks an SM (the register budget's count) where the rule
        # leaves them room.
        assert 3 * (lay.smem + SMEM_RESERVED) <= SM_SMEM
    for P, layout in Y_FACTORED_RB_BY_P.items():
        assert y_dft_factored_launched(P) == layout
    assert y_dft_factored_layout(8064, 1).smem == 71080      # 69.4 KB
    assert y_dft_factored_layout(7808, 1).smem == 76296      # p = 61


@pytest.mark.parametrize("P", [384, 2432])
def test_y_dft_on_cpu_counts_no_mixed_launch(P):
    z = torch.from_numpy(_field(5, P, 3, np.float32))
    n = (y_dft.launches, y_dft.factored_launches, y_dft.mixed_launches)
    for inverse in (False, True):
        torch.testing.assert_close(y_dft(z, inverse), y_dft_plain(z, inverse),
                                   rtol=0, atol=0)
    assert (y_dft.launches, y_dft.factored_launches,
            y_dft.mixed_launches) == n
