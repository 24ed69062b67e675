"""K10, the multigrid smoother, and K11, the coarse correction plus
post-smoother: one pass each over a V-cycle level's fields.

K10 replaces ``tpu_qg/ops/pallas_mg.py`` ``mg_smooth`` (:340): nu damped-
Jacobi sweeps (omega = 0.8) of (lap + alpha_k) u_k = f_k for K modes, with
optionally the residual, or the residual restricted by full weighting to
(K, M/2, P/2). K11 replaces ``mg_prolong_smooth`` (:298): u2 plus the
bilinear prolongation of the coarse correction ec (K, M/2, P/2), then nu
sweeps. Both are hand-written CUDA kernels in ``csrc/mg_kernels.cu``.

Bound: device-memory bandwidth. One (2, n, n) float32 field is 8 n^2 bytes;
K10's restrict form and K11 move 3.25 fields (u and f in, u and a quarter
field out), 1745 MB and 0.52 ms at 3.35 TB/s at 8192^2; the residual form
moves 4 fields, the smooth-only form 3. Design (in the source's header):
one block per 32 x 64 tile and mode loads u and f with a halo of nu + 1
(+1 for the restriction), runs the nu sweeps in shared memory, each sweep
shrinking the valid ring by one, and writes only the tile: the halo is
recomputed, never written back, so each input is read once and each output
written once from device memory.

The wrappers launch the kernels on CUDA tensors (float32, contiguous) and
run the plain versions, ``mg_smooth_plain`` and ``mg_prolong_smooth_plain``,
on CPU tensors. The plain versions follow the Pallas kernels' arithmetic,
which differs from the level ops of ``ops/multigrid.py`` at the rounding
level: the Laplacian grouped as in ``_lap_alpha_slab``; the update
w + (omega/diag) r with omega/diag one constant (``jacobi_smooth`` computes
c + omega (f - A u) / diag); the restriction rows then columns, each
0.25 a + 0.5 c + 0.25 b; the prolongation rows first, then columns. Each
constant is rounded once from its float64 value, in the kernels as here.

The reference's shape gates (``mg_smooth_supported``,
``mg_prolong_supported``, ``_pick_tile_mg``, ``_footprint_mg``) are copied
so that ``MultigridSolver`` picks the same kernel levels as ``tpu_qg``; the
kernels themselves take every shape (restriction and prolongation need
even extents) and up to 4 modes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .step_kernel import _check_operands
from .stencils import roll_shift

# --- The reference's gates (tpu_qg/ops/pallas_mg.py:42-103) ------------------

_H = 8                          # the Pallas kernel's halo rows
_MAX_NU_RES = _H - 1            # sweeps + residual the gate admits
_VMEM_LIMIT_MG = 96 * 1024 * 1024
_VMEM_BUDGET_MG = int(0.70 * _VMEM_LIMIT_MG)


def _footprint_mg(T: int, P: int, K: int) -> int:
    slab = (T + 2 * _H) * P * 4
    bufs = 2 * K * slab * 2
    outs = 2 * 2 * K * T * P * 4
    temps = 5 * slab
    return bufs + outs + temps


def _pick_tile_mg(M: int, P: int, K: int) -> int:
    for T in (256, 128, 64, 32, 16, 8):
        if (M % T == 0 and M // T >= 2
                and _footprint_mg(T, P, K) <= _VMEM_BUDGET_MG):
            return T
    return 0


def mg_smooth_supported(K: int, M: int, P: int, nu: int, residual: bool,
                        restrict: bool = False) -> bool:
    """The reference's gate for K10 (and, with ``restrict``, its in-kernel
    restriction)."""
    if P % 128 or M % 8 or M < 128:
        return False
    if nu + (1 if residual else 0) > _MAX_NU_RES:
        return False
    T = _pick_tile_mg(M, P, K)
    if T <= 0:
        return False
    if restrict and (P % 256 or T % 16 or not residual):
        return False
    return True


def mg_prolong_supported(K: int, M: int, P: int, nu: int) -> bool:
    """The reference's gate for K11."""
    if not mg_smooth_supported(K, M, P, nu, False):
        return False
    T = _pick_tile_mg(M, P, K)
    return P % 256 == 0 and T % 16 == 0


# --- Plain versions: the kernels' arithmetic in torch -----------------------


def _lap_alpha(w, inv_dx2: float, alpha: float):
    lap = (((roll_shift(w, 1, 0) - w) + (roll_shift(w, -1, 0) - w))
           + ((roll_shift(w, 0, 1) - w) + (roll_shift(w, 0, -1) - w))
           ) * inv_dx2
    return lap + alpha * w


def _mode_consts(dx: float, alphas: Sequence[float], omega: float):
    """(inv_dx2, [(alpha_k, omega / diag_k)]) as float64 Python scalars."""
    inv_dx2 = 1.0 / (dx * dx)
    return inv_dx2, [(float(a), float(omega) / (-4.0 * inv_dx2 + float(a)))
                     for a in alphas]


def _sweeps(w, fv, inv_dx2: float, alpha: float, cw: float, nu: int):
    for _ in range(nu):
        w = w + cw * (fv - _lap_alpha(w, inv_dx2, alpha))
    return w


def _restrict(r):
    """Full weighting as the kernel forms it: rows, subsample, columns,
    subsample."""
    rw = 0.25 * roll_shift(r, 1, 0) + 0.5 * r + 0.25 * roll_shift(r, -1, 0)
    rh = rw[..., ::2, :]
    rh = (0.25 * roll_shift(rh, 0, -1) + 0.5 * rh
          + 0.25 * roll_shift(rh, 0, 1))
    return rh[..., ::2]


def interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """out[..., 2j, ...] = a[..., j, ...], out[..., 2j+1, ...] = b[..., j, ...]
    along ``dim`` (-1 or -2)."""
    out = torch.stack([a, b], dim=dim)
    shape = list(a.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def _prolong(ec):
    """Bilinear prolongation as the kernel forms it: rows first (odd rows
    0.5 ec[q] + 0.5 ec[q+1]), then columns (odd columns the mean of the two
    neighbours)."""
    v = interleave(ec, 0.5 * ec + 0.5 * roll_shift(ec, 1, 0), -2)
    return interleave(v, 0.5 * (v + roll_shift(v, 0, 1)), -1)


def mg_smooth_plain(u: torch.Tensor, f: torch.Tensor, dx: float,
                    alphas: Sequence[float], nu: int = 2,
                    residual: bool = True, omega: float = 0.8,
                    restrict: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain-torch K10: (u after nu sweeps, the residual, its restriction
    or None)."""
    if restrict and not residual:
        raise ValueError("mg_smooth: restrict needs residual")
    inv_dx2, consts = _mode_consts(dx, alphas, omega)
    us, rs = [], []
    for k, (a, cw) in enumerate(consts):
        w = _sweeps(u[k], f[k], inv_dx2, a, cw, nu)
        us.append(w)
        if residual:
            r = f[k] - _lap_alpha(w, inv_dx2, a)
            rs.append(_restrict(r) if restrict else r)
    return torch.stack(us), (torch.stack(rs) if residual else None)


def mg_prolong_smooth_plain(u2: torch.Tensor, ec: torch.Tensor,
                            f: torch.Tensor, dx: float,
                            alphas: Sequence[float], nu: int = 2,
                            omega: float = 0.8) -> torch.Tensor:
    """Plain-torch K11: nu sweeps from u2 + prolong(ec)."""
    inv_dx2, consts = _mode_consts(dx, alphas, omega)
    return torch.stack([
        _sweeps(u2[k] + _prolong(ec[k]), f[k], inv_dx2, a, cw, nu)
        for k, (a, cw) in enumerate(consts)])


# --- Wrappers ----------------------------------------------------------------


def _lib():
    lib = _build.load()
    if lib.qg_mg_smooth_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _build.declare(lib.qg_mg_smooth_launch,
                       [p, p, p, p, i, i, i, i, i, i, p, p])
        _build.declare(lib.qg_mg_prolong_launch,
                       [p, p, p, p, i, i, i, i, p, p])
        for fn in (lib.qg_mg_num_consts, lib.qg_mg_max_modes,
                   lib.qg_mg_max_halo):
            fn.restype = ctypes.c_int
    return lib


def _kernel_consts(lib, what: str, dx: float, alphas: Sequence[float],
                   omega: float) -> ctypes.Array:
    """MgConsts: 1/dx^2, then alpha_k and omega/diag_k for up to the kernel's
    mode count, each rounded once from float64."""
    n_modes = lib.qg_mg_max_modes()
    if len(alphas) > n_modes:
        raise ValueError(f"{what}: the kernel takes at most {n_modes} modes, "
                         f"got {len(alphas)}")
    inv_dx2, consts = _mode_consts(dx, alphas, omega)
    pad = [0.0] * (n_modes - len(consts))
    vals = ([inv_dx2] + [a for a, _ in consts] + pad
            + [cw for _, cw in consts] + pad)
    if len(vals) != lib.qg_mg_num_consts():
        raise RuntimeError(f"{what}: constant table does not match the "
                           "compiled kernel")
    return (ctypes.c_float * len(vals))(*vals)


def _check(what: str, ref: torch.Tensor, alphas, fine, coarse=()) -> None:
    """CUDA, float32, contiguous (K, M, P) ``fine`` and (K, M/2, P/2)
    ``coarse`` operands on ref's device, one alpha per mode."""
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ref.device}")
    if ref.dim() != 3 or ref.shape[0] != len(alphas):
        raise ValueError(f"{what}: fields must be (K, M, P) with K = "
                         f"len(alphas) = {len(alphas)}, got "
                         f"{tuple(ref.shape)}")
    K, M, P = ref.shape
    _check_operands(what, ref, fine, (K, M, P))
    _check_operands(what, ref, coarse, (K, M // 2, P // 2))


def mg_smooth(u: torch.Tensor, f: torch.Tensor, dx: float,
              alphas: Sequence[float], nu: int = 2, residual: bool = True,
              omega: float = 0.8, restrict: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K10 on CUDA tensors (one launch), the plain version on CPU tensors.
    Returns (u after nu sweeps, r | rc | None): the residual (K, M, P), with
    ``restrict`` its full-weighting restriction (K, M/2, P/2)."""
    if restrict and not residual:
        raise ValueError("mg_smooth: restrict needs residual")
    if u.device.type == "cpu":
        return mg_smooth_plain(u, f, dx, alphas, nu, residual, omega,
                               restrict)
    _check("mg_smooth", u, alphas, (("u", u), ("f", f)))
    K, M, P = u.shape
    lib = _lib()
    halo = nu + int(residual) + int(restrict)
    if nu < 0 or halo > lib.qg_mg_max_halo():
        raise ValueError(f"mg_smooth: nu + residual + restrict = {halo} "
                         f"exceeds the kernel's halo {lib.qg_mg_max_halo()}")
    if restrict and (M % 2 or P % 2):
        raise ValueError(f"mg_smooth: restriction needs even extents, got "
                         f"({M}, {P})")
    consts = _kernel_consts(lib, "mg_smooth", dx, alphas, omega)
    u_out = torch.empty_like(u)
    r_out = None
    if residual:
        r_out = (u.new_empty((K, M // 2, P // 2)) if restrict
                 else torch.empty_like(u))
    code = lib.qg_mg_smooth_launch(
        u.data_ptr(), f.data_ptr(), u_out.data_ptr(),
        None if r_out is None else r_out.data_ptr(), K, M, P, nu,
        int(residual), int(restrict), consts,
        torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(code, "mg_smooth (K10)")
    mg_smooth.launches += 1
    return u_out, r_out


mg_smooth.launches = 0


def mg_prolong_smooth(u2: torch.Tensor, ec: torch.Tensor, f: torch.Tensor,
                      dx: float, alphas: Sequence[float], nu: int = 2,
                      omega: float = 0.8) -> torch.Tensor:
    """K11 on CUDA tensors (one launch), the plain version on CPU tensors:
    nu sweeps from u2 + prolong(ec), ec of shape (K, M/2, P/2)."""
    if u2.device.type == "cpu":
        return mg_prolong_smooth_plain(u2, ec, f, dx, alphas, nu, omega)
    _check("mg_prolong_smooth", u2, alphas, (("u2", u2), ("f", f)),
           (("ec", ec),))
    K, M, P = u2.shape
    if M % 2 or P % 2:
        raise ValueError(f"mg_prolong_smooth: prolongation needs even "
                         f"extents, got ({M}, {P})")
    lib = _lib()
    if nu < 0 or nu > lib.qg_mg_max_halo():
        raise ValueError(f"mg_prolong_smooth: nu = {nu} exceeds the "
                         f"kernel's halo {lib.qg_mg_max_halo()}")
    consts = _kernel_consts(lib, "mg_prolong_smooth", dx, alphas, omega)
    u_out = torch.empty_like(u2)
    code = lib.qg_mg_prolong_launch(
        u2.data_ptr(), ec.data_ptr(), f.data_ptr(), u_out.data_ptr(), K, M, P,
        nu, consts, torch.cuda.current_stream(u2.device).cuda_stream)
    _build.check(code, "mg_prolong_smooth (K11)")
    mg_prolong_smooth.launches += 1
    return u_out


mg_prolong_smooth.launches = 0
