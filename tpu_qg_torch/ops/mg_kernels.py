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
moves 4 fields, the smooth-only form 3. Two designs, chosen by shape and
alignment (design notes in the source's header): the row-streaming kernel
(``mg_rows``: a warp walks a run of rows of a 120-column strip, its input
rows brought in ahead by bulk copies, each sweep one row behind the last in
registers) where ``mg_rows_takes`` holds, counted also in
``mg_smooth.rows_launches`` and ``mg_prolong_smooth.rows_launches``; the
tile kernel (``mg_smooth_tile``, ``mg_prolong_tile``: one block a 32 x 64
tile and its halo in shared memory) on the rest. Both give the same bits.
``mg_rows_emulated`` is the row kernel's schedule in plain torch, for the
CPU tests.

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
``mg_prolong_supported``, ``_pick_tile_mg``, ``_footprint_mg``) are kept
beside the reference's own, which the tests hold them against; the port's
MultigridSolver routes levels by its own gate
(``MultigridSolver._kernel_level``), and the kernels take every shape
(restriction and prolongation need even extents) and up to 4 modes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

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


# --- The row-streaming design (csrc mg_rows_kernel) -------------------------

# The kernel's forms, by its form code: K10's smooth-only, residual and
# restrict forms, K11.
MG_FORMS = ("smooth", "residual", "restrict", "prolong")
MG_MAX_HALO = 8            # the tile kernels' halo (csrc kMaxHalo)
MG_ROWS_WIDTH = 120        # output columns of a warp's strip (csrc kRowsW)
MG_ROWS_HALO = 4           # the y halo a ring row holds (kRowsHalo)
MG_ROWS_NUS = (1, 2)       # the sweep counts the source instantiates
# The layouts (R, D, NT) of the sweep: R rows a run, D rows ahead, NT
# threads (NT / 32 warps, each on its own run). R, D and NT are launch
# arguments (R even, 1 <= D <= 8, NT a multiple of 32 up to 256). The
# wrappers launch MG_ROWS_BY_M at the largest extent in it not above the
# level's M rows (the layout of chip_smoke.py's mg_sweep with the least
# K10 + K11 device time at that level, PERF.md), and MG_ROWS below its
# smallest extent (the sweep's least at 64^2 too).
MG_ROWS_RUNS = (4, 8, 16, 32, 64, 128)
MG_ROWS_AHEAD = (1, 2, 8)
MG_ROWS_THREADS = (64, 128)
MG_ROWS_MAX_AHEAD = 8
MG_ROWS_MAX_THREADS = 256
MG_ROWS = (4, 8, 64)
MG_ROWS_BY_M = {512: (4, 8, 64), 1024: (8, 2, 64), 2048: (16, 1, 128),
                4096: (32, 1, 64), 8192: (128, 1, 64)}


class MgRowsLayout(NamedTuple):
    """A row-streaming block (csrc MgRows): R rows a run, D rows ahead, NT
    threads, S ring slots a warp (L + 1 + D, L the steps a row stays live:
    nu, or nu + 1 with the residual) and bytes of shared memory a block (a
    warp's S mbarriers padded to 16 bytes and S slots of u and f rows of
    128 floats, K11's also a coarse row of 68)."""
    R: int
    D: int
    NT: int
    S: int
    smem: int


def mg_rows_layout(form: str, nu: int, layout: tuple) -> MgRowsLayout:
    R, D, NT = layout
    L = nu + (form in ("residual", "restrict"))
    S = L + 1 + D
    slot = 2 * (MG_ROWS_WIDTH + 8) + (MG_ROWS_WIDTH // 2 + 8
                                      if form == "prolong" else 0)
    warp = -(-8 * S // 16) * 16 + S * slot * 4
    return MgRowsLayout(R, D, NT, S, NT // 32 * warp)


def mg_rows_layouts() -> list:
    """Every layout of the sweep, in sweep order."""
    return [(R, D, NT) for NT in MG_ROWS_THREADS for D in MG_ROWS_AHEAD
            for R in MG_ROWS_RUNS]


def mg_rows_launched(M: int) -> tuple:
    """The layout mg_smooth and mg_prolong_smooth launch at M rows."""
    below = [m for m in MG_ROWS_BY_M if m <= M]
    return MG_ROWS_BY_M[max(below)] if below else MG_ROWS


def _halo(form: str, nu: int) -> int:
    return nu + (form in ("residual", "restrict")) + (form == "restrict")


def mg_rows_takes(form: str, P: int, nu: int, *tensors: torch.Tensor) -> bool:
    """True iff the row-streaming kernel takes ``form`` on fields P wide
    with nu sweeps and these operands: nu an instantiated count and the
    form's halo within the ring row's (MG_ROWS_HALO), P a multiple of 4 (a
    row is whole 16-byte pieces; of 8 for the restrict and prolong forms,
    whose coarse rows are too), and every operand 16-byte aligned (the bulk
    copies and 16-byte stores). A tensor that torch allocates is aligned; a
    view that starts part way into a 16-byte piece is not, and takes the
    tile kernel, which rows_launches shows."""
    step = 8 if form in ("restrict", "prolong") else 4
    return (nu in MG_ROWS_NUS and _halo(form, nu) <= MG_ROWS_HALO
            and P >= step and P % step == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_rows_layout(what: str, layout: tuple) -> None:
    R, D, NT = layout
    if (R < 2 or R % 2 or not 1 <= D <= MG_ROWS_MAX_AHEAD or NT % 32
            or not 32 <= NT <= MG_ROWS_MAX_THREADS):
        raise ValueError(f"{what}: layout {layout} (R, D, NT) is not one the "
                         "kernel takes (R even, 1 <= D <= "
                         f"{MG_ROWS_MAX_AHEAD}, NT a multiple of 32 up to "
                         f"{MG_ROWS_MAX_THREADS})")


def _fw3(lo, mid, hi):
    """[1, 2, 1]/4 in _restrict's order."""
    return 0.25 * lo + 0.5 * mid + 0.25 * hi


def mg_rows_emulated(form: str, u: torch.Tensor, f: torch.Tensor,
                     ec: Optional[torch.Tensor], dx: float,
                     alphas: Sequence[float], nu: int, omega: float,
                     layout: tuple, slots: Optional[int] = None):
    """The row-streaming kernel's schedule in plain torch, in the plain
    versions' arithmetic: every strip of MG_ROWS_WIDTH columns of a mode at
    once, the modes and the runs of R rows in turn, through csrc
    mg_rows_kernel's steps: the ring of S slots (u or u2 and f rows of 128
    columns from y0 - 4, K11's coarse row ceil(x/2) of 68 coarse columns
    from y0/2 - 4) filled D rows ahead and refilled after each step, the
    wait on the row that enters, stage 0 (K11: u2 + prolong(ec), coarse rows
    from slot x, and x - 1 where x is odd), sweep s forming row xin - s from
    the last three rows of stage s - 1 once xin >= x_lo + 2 s, the residual
    one row behind sweep nu, the restriction when an odd row 2X + 1 enters
    the residual's rows, and the stores. Every ring entry the producer did
    not fill, every stage row never formed and every y neighbour past the
    ring row's edge is NaN, so a stored point that reads one is NaN.
    ``slots`` overrides S (to show that a short ring is caught).

    Returns (u_out, r_out, stores, bad): r_out the residual (K, M, P), the
    restricted residual (K, M/2, P/2) or None; ``stores`` counts the stores
    of each element of u_out and r_out (a tuple); ``bad`` counts the slot
    reads that did not find their row filled and waited on, and the fills
    of a slot whose previous row was never waited on."""
    K, M, P = u.shape
    R, D, _ = layout
    S = slots or mg_rows_layout(form, nu, layout).S
    res = form in ("residual", "restrict")
    top = {"smooth": 0, "residual": 1, "restrict": 2, "prolong": 0}[form]
    dev, dt = u.device, u.dtype
    nan = float("nan")
    W, ring = MG_ROWS_WIDTH, MG_ROWS_WIDTH + 8
    strips = -(-P // W)
    y0 = torch.arange(strips, device=dev) * W
    w = torch.clamp(P - y0, max=W)
    j = torch.arange(ring, device=dev)
    cols = (y0[:, None] - 4 + j) % P                  # (strips, 128)
    cols_ok = j < w[:, None] + 8
    Mc, Pc = M // 2, P // 2
    jc = torch.arange(W // 2 + 8, device=dev)
    ccols = (y0[:, None] // 2 - 4 + jc) % max(Pc, 1)
    ccols_ok = jc < w[:, None] // 2 + 8
    # The stored ring columns 4 .. 4 + w of each strip, as flat indices.
    out_j = torch.arange(4, W + 4, device=dev)
    out_ok = out_j[None, :] < w[:, None] + 4
    out_y = (y0[:, None] + out_j - 4)[out_ok]
    cout_j = torch.arange(4, W + 4, 2, device=dev)
    cout_ok = cout_j[None, :] < w[:, None] + 4
    cout_y = ((y0[:, None] + cout_j - 4) // 2)[cout_ok]
    inv_dx2, consts = _mode_consts(dx, alphas, omega)

    def with_nan(row, idx, ok):
        return torch.where(ok, row[idx], torch.full(idx.shape, nan, dtype=dt,
                                                    device=dev))

    def ynb(v, d):
        """v at column + d (d = +-1) within the ring row, NaN past it."""
        pad = torch.full_like(v[..., :1], nan)
        if d > 0:
            return torch.cat([v[..., 1:], pad], -1)
        return torch.cat([pad, v[..., :-1]], -1)

    def lap_alpha(rows, alpha):
        """_lap_alpha at the middle of rows (x - 1, x, x + 1)."""
        xm, c, xp = rows
        lap = (((xp - c) + (xm - c)) + ((ynb(c, 1) - c) + (ynb(c, -1) - c))
               ) * inv_dx2
        return lap + alpha * c

    u_out = torch.full_like(u, nan)
    r_out = None
    stores = [torch.zeros(u.shape, dtype=torch.int64, device=dev)]
    if res:
        r_out = (torch.full((K, Mc, Pc), nan, dtype=dt, device=dev)
                 if form == "restrict" else torch.full_like(u, nan))
        stores.append(torch.zeros(r_out.shape, dtype=torch.int64,
                                  device=dev))
    bad = 0

    def store(dst, count, k, row, vals, ys):
        dst[k, row, ys] = vals
        count[k, row, ys] += 1

    def run(k, alpha, cw, x0):
        """The steps of the warp on run x0 of mode k."""
        nonlocal bad
        x_end = min(x0 + R, M)
        x_lo = x0 - nu - top
        if form == "prolong":
            x_lo -= x_lo & 1
        x_hi = x_end - 1 + nu + res
        uring = torch.full((strips, S, ring), nan, dtype=dt, device=dev)
        fring = torch.full_like(uring, nan)
        cring = torch.full((strips, S, W // 2 + 8), nan, dtype=dt,
                           device=dev)
        filled, seen = [None] * S, [None] * S

        def slot(r):
            return (r - x_lo) % S

        def fill(r):
            nonlocal bad
            s = slot(r)
            if filled[s] is not None and seen[s] != filled[s]:
                bad += 1
            filled[s], seen[s] = r, None
            uring[:, s] = with_nan(u[k, r % M], cols, cols_ok)
            fring[:, s] = with_nan(f[k, r % M], cols, cols_ok)
            if form == "prolong":
                cring[:, s] = with_nan(ec[k, ((r + 1) // 2) % Mc], ccols,
                                       ccols_ok)

        def read(r, rows):
            nonlocal bad
            s = slot(r)
            if filled[s] != r or seen[s] != r:
                bad += 1
            return rows[:, s]

        blank = torch.full((strips, ring), nan, dtype=dt, device=dev)
        stage = [[blank] * 3 for _ in range(nu + 1)]
        rres = [blank] * 3
        nxt = x_lo
        while nxt <= min(x_lo + D, x_hi):
            fill(nxt)
            nxt += 1
        for xin in range(x_lo, x_hi + 1):
            s_in = slot(xin)
            if filled[s_in] != xin:
                bad += 1
            seen[s_in] = xin
            new = read(xin, uring).clone()     # into the lane's registers
            if form == "prolong":
                # Fine ring column jj sits on coarse ring column 2 + jj // 2;
                # the rows' stage, then the columns'.
                odd = xin & 1
                e1 = read(xin, cring)
                e0 = read(xin - 1, cring) if odd else e1
                v = 0.5 * e0 + 0.5 * e1 if odd else e0
                q = 2 + j // 2
                new = new + torch.where(j % 2 == 1, 0.5 * (v[:, q] + v[:, q + 1]),
                                        v[:, q])
            stage[0] = stage[0][1:] + [new]
            for s in range(1, nu + 1):
                row = stage[s][2]
                if xin >= x_lo + 2 * s:
                    fv = read(xin - s, fring)
                    row = stage[s - 1][1] + cw * (
                        fv - lap_alpha(stage[s - 1], alpha))
                stage[s] = stage[s][1:] + [row]
            xu, xr = xin - nu, xin - nu - 1
            if x0 <= xu < x_end:
                store(u_out, stores[0], k, xu,
                      stage[nu][2][:, 4:W + 4][out_ok], out_y)
            if res:
                r = rres[2]
                if xin >= x_lo + 2 * (nu + 1):
                    r = read(xr, fring) - lap_alpha(stage[nu], alpha)
                rres = rres[1:] + [r]
                if form == "residual" and x0 <= xr < x_end:
                    store(r_out, stores[1], k, xr, r[:, 4:W + 4][out_ok],
                          out_y)
                if form == "restrict" and xr & 1 and x0 < xr < x_end:
                    rw = _fw3(rres[2], rres[1], rres[0])
                    rc = _fw3(ynb(rw, -1), rw, ynb(rw, 1))
                    store(r_out, stores[1], k, (xr - 1) // 2,
                          rc[:, cout_j][cout_ok], cout_y)
            while nxt <= min(xin + 1 + D, x_hi):     # lane 0's refills
                fill(nxt)
                nxt += 1

    for k, (alpha, cw) in enumerate(consts):
        for x0 in range(0, M, R):
            run(k, alpha, cw, x0)
    return u_out, r_out, tuple(stores), bad


# --- Wrappers ----------------------------------------------------------------


def _lib():
    lib = _build.load()
    if lib.qg_mg_smooth_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _build.declare(lib.qg_mg_smooth_launch,
                       [p, p, p, p, i, i, i, i, i, i, p, p])
        _build.declare(lib.qg_mg_prolong_launch,
                       [p, p, p, p, i, i, i, i, p, p])
        _build.declare(lib.qg_mg_rows_launch,
                       [i] + [p] * 5 + [i] * 7 + [p, p])
        _build.declare(lib.qg_mg_rows_attributes, [i] * 4 + [p] * 4)
        for fn in (lib.qg_mg_num_consts, lib.qg_mg_max_modes,
                   lib.qg_mg_max_halo, lib.qg_mg_rows_width):
            fn.restype = ctypes.c_int
        if (lib.qg_mg_rows_width(), lib.qg_mg_max_halo()) != (
                MG_ROWS_WIDTH, MG_MAX_HALO):
            raise RuntimeError("mg kernels: strip width or halo does not "
                               "match the compiled kernels")
    return lib


@functools.lru_cache(maxsize=None)
def _table_sizes(lib) -> Tuple[int, int]:
    """(modes, floats) of the compiled kernel's MgConsts."""
    return lib.qg_mg_max_modes(), lib.qg_mg_num_consts()


@functools.lru_cache(maxsize=64)
def _consts_table(n_modes: int, n_consts: int, dx: float,
                  alphas: Tuple[float, ...], omega: float) -> ctypes.Array:
    inv_dx2, consts = _mode_consts(dx, alphas, omega)
    pad = [0.0] * (n_modes - len(consts))
    vals = ([inv_dx2] + [a for a, _ in consts] + pad
            + [cw for _, cw in consts] + pad)
    if len(vals) != n_consts:
        raise RuntimeError("mg kernels: constant table does not match the "
                           "compiled kernel")
    return (ctypes.c_float * len(vals))(*vals)


def _kernel_consts(lib, what: str, dx: float, alphas: Sequence[float],
                   omega: float) -> ctypes.Array:
    """MgConsts: 1/dx^2, then alpha_k and omega/diag_k for up to the kernel's
    mode count, each rounded once from float64; built once per (dx, alphas,
    omega) and shared by every launch with them (the kernels copy it into
    their arguments at the launch)."""
    n_modes, n_consts = _table_sizes(lib)
    if len(alphas) > n_modes:
        raise ValueError(f"{what}: the kernel takes at most {n_modes} modes, "
                         f"got {len(alphas)}")
    return _consts_table(n_modes, n_consts, float(dx),
                         tuple(float(a) for a in alphas), float(omega))


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


def _smooth_form(residual: bool, restrict: bool) -> str:
    if restrict and not residual:
        raise ValueError("mg_smooth: restrict needs residual")
    return "restrict" if restrict else "residual" if residual else "smooth"


def _outputs(form: str, u: torch.Tensor):
    """(u_out, r_out or None) of a K10 form, or K11's u_out."""
    K, M, P = u.shape
    r_out = None
    if form == "residual":
        r_out = torch.empty_like(u)
    elif form == "restrict":
        r_out = u.new_empty((K, M // 2, P // 2))
    return torch.empty_like(u), r_out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def mg_rows(form: str, u: torch.Tensor, f: torch.Tensor,
            ec: Optional[torch.Tensor], dx: float, alphas: Sequence[float],
            nu: int = 2, omega: float = 0.8, layout: Optional[tuple] = None):
    """One launch of the row-streaming kernel (csrc mg_rows_kernel) in
    ``form`` ("smooth", "residual", "restrict": K10; "prolong": K11, u the
    u2 it corrects and ec (K, M/2, P/2)) on CUDA tensors, in ``layout`` (R,
    D, NT), by default mg_rows_launched(M). Returns (u_out, r_out or None).
    Raises on a shape, operand or layout the kernel does not take and on a
    launch error. Counts nothing: the counting wrappers are mg_smooth and
    mg_prolong_smooth.

    Replaces ``tpu_qg/ops/pallas_mg.py:340`` mg_smooth (K10) and ``:298``
    mg_prolong_smooth (K11). Bound: device-memory bandwidth, 3.25 (2, n, n)
    fields for the restrict form and K11 (1745 MB, 0.52 ms at 3.35 TB/s at
    8192^2), 4 for the residual form, 3 for smooth only. Why rows: the
    tile kernel loads its halo'd window with 4-byte loads behind an integer
    division, then computes with no load in flight; here a warp walks a run
    of rows with D rows of bulk copies in flight, keeps each stage's last
    three rows in registers and takes y neighbours from the lanes beside
    it (design in csrc/mg_kernels.cu)."""
    what = f"mg_rows ({form})"
    if form not in MG_FORMS:
        raise ValueError(f"{what}: unknown form")
    coarse = (("ec", ec),) if form == "prolong" else ()
    _check(what, u, alphas, (("u", u), ("f", f)), coarse)
    K, M, P = u.shape
    layout = tuple(layout or mg_rows_launched(M))
    _check_rows_layout(what, layout)
    if form in ("restrict", "prolong") and M % 2:
        raise ValueError(f"{what}: needs an even M, got {M}")
    if not mg_rows_takes(form, P, nu, u, f, *(t for _, t in coarse)):
        raise ValueError(f"{what}: takes nu in {MG_ROWS_NUS} with a halo "
                         f"within {MG_ROWS_HALO}, P a multiple of "
                         f"{8 if coarse or form == 'restrict' else 4} and "
                         f"16-byte aligned operands; got nu = {nu}, P = {P}")
    return _launch_rows(form, u, f, ec, dx, alphas, nu, omega, layout)


def _launch_rows(form, u, f, ec, dx, alphas, nu, omega, layout):
    """mg_rows's launch on checked operands."""
    K, M, P = u.shape
    lib = _lib()
    consts = _kernel_consts(lib, "mg_rows", dx, alphas, omega)
    u_out, r_out = _outputs(form, u)
    R, D, NT = layout
    code = lib.qg_mg_rows_launch(
        MG_FORMS.index(form), u.data_ptr(), f.data_ptr(),
        None if ec is None else ec.data_ptr(), u_out.data_ptr(),
        None if r_out is None else r_out.data_ptr(), K, M, P, nu, R, D, NT,
        consts, _stream(u))
    _build.check(code, f"mg_rows ({form}) {layout}")
    return u_out, r_out


@functools.lru_cache(maxsize=64)
def mg_rows_attributes(form: str, nu: int, layout: tuple, device: int) -> dict:
    """The compiled instance of ``form`` and ``nu`` in ``layout`` on card
    ``device``: registers a thread, local memory (spill) bytes a thread,
    shared memory a block and the most blocks an SM holds."""
    _, D, NT = layout
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        code = _lib().qg_mg_rows_attributes(
            MG_FORMS.index(form), nu, D, NT,
            *(ctypes.byref(v) for v in vals))
    _build.check(code, f"mg rows attributes {form} nu={nu} {layout}")
    return dict(zip(("regs", "local_bytes", "smem", "blocks_per_sm"),
                    (v.value for v in vals)))


def mg_smooth_tile(u: torch.Tensor, f: torch.Tensor, dx: float,
                   alphas: Sequence[float], nu: int = 2,
                   residual: bool = True, omega: float = 0.8,
                   restrict: bool = False):
    """One launch of K10 in the tile design (csrc mg_smooth_kernel, one
    block a 32 x 64 tile) on CUDA tensors: mg_smooth's kernel where
    mg_rows_takes does not hold. Returns (u, r | rc | None); counts
    nothing."""
    form = _smooth_form(residual, restrict)
    _check("mg_smooth", u, alphas, (("u", u), ("f", f)))
    K, M, P = u.shape
    lib = _lib()
    halo = _halo(form, nu)
    if nu < 0 or halo > MG_MAX_HALO:
        raise ValueError(f"mg_smooth: nu + residual + restrict = {halo} "
                         f"exceeds the kernel's halo {MG_MAX_HALO}")
    if restrict and (M % 2 or P % 2):
        raise ValueError(f"mg_smooth: restriction needs even extents, got "
                         f"({M}, {P})")
    consts = _kernel_consts(lib, "mg_smooth", dx, alphas, omega)
    u_out, r_out = _outputs(form, u)
    code = lib.qg_mg_smooth_launch(
        u.data_ptr(), f.data_ptr(), u_out.data_ptr(),
        None if r_out is None else r_out.data_ptr(), K, M, P, nu,
        int(residual), int(restrict), consts, _stream(u))
    _build.check(code, "mg_smooth (K10)")
    return u_out, r_out


def mg_prolong_tile(u2: torch.Tensor, ec: torch.Tensor, f: torch.Tensor,
                    dx: float, alphas: Sequence[float], nu: int = 2,
                    omega: float = 0.8) -> torch.Tensor:
    """One launch of K11 in the tile design (csrc mg_prolong_kernel) on
    CUDA tensors: mg_prolong_smooth's kernel where mg_rows_takes does not
    hold. Counts nothing."""
    _check("mg_prolong_smooth", u2, alphas, (("u2", u2), ("f", f)),
           (("ec", ec),))
    K, M, P = u2.shape
    if M % 2 or P % 2:
        raise ValueError(f"mg_prolong_smooth: prolongation needs even "
                         f"extents, got ({M}, {P})")
    lib = _lib()
    if nu < 0 or nu > MG_MAX_HALO:
        raise ValueError(f"mg_prolong_smooth: nu = {nu} exceeds the "
                         f"kernel's halo {MG_MAX_HALO}")
    consts = _kernel_consts(lib, "mg_prolong_smooth", dx, alphas, omega)
    u_out = torch.empty_like(u2)
    code = lib.qg_mg_prolong_launch(
        u2.data_ptr(), ec.data_ptr(), f.data_ptr(), u_out.data_ptr(), K, M, P,
        nu, consts, _stream(u2))
    _build.check(code, "mg_prolong_smooth (K11)")
    return u_out


def mg_smooth(u: torch.Tensor, f: torch.Tensor, dx: float,
              alphas: Sequence[float], nu: int = 2, residual: bool = True,
              omega: float = 0.8, restrict: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K10 on CUDA tensors (one launch), the plain version on CPU tensors.
    Returns (u after nu sweeps, r | rc | None): the residual (K, M, P), with
    ``restrict`` its full-weighting restriction (K, M/2, P/2). Two
    hand-written kernels chosen by shape and alignment: the row-streaming
    kernel (mg_rows, layout mg_rows_launched(M)) where mg_rows_takes, also
    counted in ``mg_smooth.rows_launches``; the tile kernel (mg_smooth_tile)
    on the rest."""
    form = _smooth_form(residual, restrict)
    if u.device.type == "cpu":
        return mg_smooth_plain(u, f, dx, alphas, nu, residual, omega,
                               restrict)
    _check("mg_smooth", u, alphas, (("u", u), ("f", f)))
    _, M, P = u.shape
    if mg_rows_takes(form, P, nu, u, f) and not (restrict and M % 2):
        out = _launch_rows(form, u, f, None, dx, alphas, nu, omega,
                           mg_rows_launched(M))
        mg_smooth.rows_launches += 1
    else:
        out = mg_smooth_tile(u, f, dx, alphas, nu, residual, omega, restrict)
    mg_smooth.launches += 1
    return out


mg_smooth.launches = 0
mg_smooth.rows_launches = 0


def mg_prolong_smooth(u2: torch.Tensor, ec: torch.Tensor, f: torch.Tensor,
                      dx: float, alphas: Sequence[float], nu: int = 2,
                      omega: float = 0.8) -> torch.Tensor:
    """K11 on CUDA tensors (one launch), the plain version on CPU tensors:
    nu sweeps from u2 + prolong(ec), ec of shape (K, M/2, P/2). The
    row-streaming kernel where mg_rows_takes (also counted in
    ``mg_prolong_smooth.rows_launches``), the tile kernel on the rest."""
    if u2.device.type == "cpu":
        return mg_prolong_smooth_plain(u2, ec, f, dx, alphas, nu, omega)
    _check("mg_prolong_smooth", u2, alphas, (("u2", u2), ("f", f)),
           (("ec", ec),))
    _, M, P = u2.shape
    if mg_rows_takes("prolong", P, nu, u2, f, ec) and not M % 2:
        out = _launch_rows("prolong", u2, f, ec, dx, alphas, nu, omega,
                           mg_rows_launched(M))[0]
        mg_prolong_smooth.rows_launches += 1
    else:
        out = mg_prolong_tile(u2, ec, f, dx, alphas, nu, omega)
    mg_prolong_smooth.launches += 1
    return out


mg_prolong_smooth.launches = 0
mg_prolong_smooth.rows_launches = 0
