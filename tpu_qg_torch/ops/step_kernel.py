"""K1, the fused two-layer step (tendency + Euler/AB3 or leapfrog-RA update),
K8, the same step for one or two layers with the modal projection, K9, the
tendency alone, K15, the step of the y-fused chain, K17, the whole step
in one launch, and the sharded forms of K1 (K12) and K15 on one rank's row
block.

K1 replaces ``tpu_qg/ops/pallas_tendency.py`` ``fused_step_streamed`` (v4)
and its single-tile form ``fused_step_pre_fft`` (v3); K8 replaces its
``fused_pre_inversion`` (v2), the step of the single-layer and pin-gauge
configurations; K9 its ``fused_tendency`` (v1). All are hand-written CUDA
kernels of ``csrc/step_kernel.cu`` (design and bound in its header: they
are bandwidth-bound, 6 x 33.5 MB per step at 2048^2, and keep every stencil
neighbour in shared memory), every one on the same point body. K1, K9 and
K12 are the row-streaming design (``fused_step_rows``,
``fused_tendency_rows``: a block marches down a run of rows of one strip,
its psi and zeta rows brought in ahead by bulk copies; K9 with the update
cut off) on P % 4 == 0 with 16-byte aligned operands, counted also in
``fused_step.rows_launches``, ``fused_tendency.rows_launches`` and
``fused_step_sharded.rows_launches``, and the tile design of K8
(``fused_step_tile``, ``fused_tendency_tile``,
``fused_step_sharded_tile``) on any other shape. K15 replaces ``fused_step_streamed_yspec``
(v5): K1 with psi in, and zeta_new also out, as permuted y-spectra, in one
cooperative launch (inverse-y, the step, and forward-y as stages). K17
replaces ``tpu_qg/ops/pallas_fullstep.py`` ``fused_step_full``: the step,
then the whole packed inversion of zeta_new, in one cooperative launch. Each
has two kernels chosen by shape: the persistent kernel of
``csrc/coop_rows.cuh`` (``fused_step_yspec_rows``, ``fused_step_full_rows``),
whose stages loop over the units of the redesigned K1, K2 and K3, where
``coop_rows_takes``, counted also in ``rows_launches``; and the first form of
``csrc/fused_kernels.cu`` (``fused_step_yspec_coop``,
``fused_step_full_coop``) on the rest.

K12 (``fused_step_sharded``) replaces ``fused_step_streamed_sharded``
and K15's sharded form (``fused_step_yspec_sharded``)
``fused_step_streamed_yspec_sharded``: the same kernels on a (2, m, P) row
block with the rows above and below it from (2, H, P) slabs the caller
exchanged with its x-neighbours (top = the previous rank's last H rows,
bottom = the next rank's first H rows). The TPU kernels take H = 8, their
sublane alignment; the stencil reads 2 rows of psi and 1 of zeta, and
these take any H >= 2. K15's sharded form, as K15, runs its persistent
kernel (``fused_step_yspec_sharded_rows``) where coop_rows_takes over the
block's operands and slabs, its first form
(``fused_step_yspec_sharded_coop``) on the rest.

``fused_step``/``fused_pre_inversion``/``fused_tendency``/
``fused_step_yspec``/``fused_step_full`` and the sharded forms launch their
kernels for CUDA tensors and use their ``*_plain`` versions — the same
arithmetic in plain torch — only for CPU tensors. The carry follows
``tpu_qg.models.core.make_step_fn``: the tendency under ``euler_ab3``, the
Robert-Asselin-filtered current level under ``leapfrog_ra``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..config import ModelConfig
from . import _build
from . import dft_kernels
from .dft_kernels import (check_consts, coop_launch_args,
                          mono_invert_plain, y_dft_plain)
from .spectral import symbol_consts


def update_plain(cfg: ModelConfig, step: int, tend: torch.Tensor,
                 zeta: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor):
    """One time update: (zeta_new, carry) under cfg.time_scheme.

    ``step`` is the host-side count of completed steps, so the Euler start
    (steps 0-1 of euler_ab3, step 0 of leapfrog_ra) is a host branch."""
    dt = cfg.dt
    if cfg.time_scheme == "leapfrog_ra":
        # f1 holds the filtered previous level; step 0 is forward Euler with
        # zeta_bar^{-1} := zeta^0.
        zeta_prev_f = zeta if step == 0 else f1
        if step == 0:
            zeta_new = zeta + dt * tend
        else:
            zeta_new = zeta_prev_f + (2.0 * dt) * tend
        zeta_filt = zeta + cfg.ra_filter * (zeta_prev_f - 2.0 * zeta
                                            + zeta_new)
        return zeta_new, zeta_filt
    if step < 2:
        update = dt * tend
    else:
        update = dt * ((23.0 / 12.0) * tend - (16.0 / 12.0) * f1
                       + (5.0 / 12.0) * f2)
    return zeta + update, tend


def fused_step_plain(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                     f1: torch.Tensor, f2: torch.Tensor, step: int):
    """Plain-torch K1: the stencil tendency then the time update."""
    from ..models.core import _tendencies
    return update_plain(cfg, step, _tendencies(cfg, zeta, psi), zeta, f1, f2)


def fused_pre_inversion_plain(cfg: ModelConfig, zeta: torch.Tensor,
                              psi: torch.Tensor, f1: torch.Tensor,
                              f2: torch.Tensor, step: int):
    """Plain-torch K8: (zeta_new, carry, modes) with modes = P^-1 zeta_new
    for two layers and zeta_new itself for one."""
    zeta_new, carry = fused_step_plain(cfg, zeta, psi, f1, f2, step)
    if cfg.n_layers == 1:
        return zeta_new, carry, zeta_new
    (q11, q12), (q21, q22) = cfg.P_inv_matrix()
    modes = torch.stack([q11 * zeta_new[0] + q12 * zeta_new[1],
                         q21 * zeta_new[0] + q22 * zeta_new[1]])
    return zeta_new, carry, modes


def fused_step_yspec_plain(cfg: ModelConfig, zeta: torch.Tensor,
                           psi_ys: torch.Tensor, f1: torch.Tensor,
                           f2: torch.Tensor, step: int):
    """Plain-torch K15: psi from its permuted y-spectrum (the plain K2^-1),
    K1's step, and the permuted y-spectrum of the packed zeta_new (the plain
    K2). Returns (zeta_new, carry, zeta_ys)."""
    psi = y_dft_plain(psi_ys, True)
    zeta_new, carry = fused_step_plain(cfg, zeta, psi, f1, f2, step)
    return zeta_new, carry, y_dft_plain(zeta_new, False)


HALO_ROWS = 2   # rows of the slabs the stencil reads (psi; zeta reads 1)


def _pad_rows(a: torch.Tensor, top: torch.Tensor,
              bot: torch.Tensor) -> torch.Tensor:
    """(L, m, P) block -> (L, m + 4, P) with 2 slab rows above and below."""
    return torch.cat([top[:, -HALO_ROWS:], a, bot[:, :HALO_ROWS]], dim=1)


def fused_step_sharded_plain(cfg: ModelConfig, zeta: torch.Tensor,
                             psi: torch.Tensor, f1: torch.Tensor,
                             f2: torch.Tensor, step: int,
                             zeta_top: torch.Tensor, zeta_bot: torch.Tensor,
                             psi_top: torch.Tensor, psi_bot: torch.Tensor):
    """Plain-torch K12: K1's plain version on the block padded with 2 slab
    rows on each side (the history fields with zeros), then the block's
    rows. Returns (zeta_new, carry)."""
    pad = (0, 0, HALO_ROWS, HALO_ROWS)
    zn, carry = fused_step_plain(
        cfg, _pad_rows(zeta, zeta_top, zeta_bot),
        _pad_rows(psi, psi_top, psi_bot), torch.nn.functional.pad(f1, pad),
        torch.nn.functional.pad(f2, pad), step)
    return (zn[:, HALO_ROWS:-HALO_ROWS].contiguous(),
            carry[:, HALO_ROWS:-HALO_ROWS].contiguous())


def fused_step_yspec_sharded_plain(cfg: ModelConfig, zeta: torch.Tensor,
                                   psi_ys: torch.Tensor, f1: torch.Tensor,
                                   f2: torch.Tensor, step: int,
                                   zeta_top: torch.Tensor,
                                   zeta_bot: torch.Tensor,
                                   psi_top: torch.Tensor,
                                   psi_bot: torch.Tensor):
    """Plain-torch K15 sharded: psi and its slab rows from their permuted
    y-spectra (the plain K2^-1), K12's plain step, and the permuted
    y-spectrum of the packed zeta_new. Returns (zeta_new, carry, zeta_ys)."""
    zeta_new, carry = fused_step_sharded_plain(
        cfg, zeta, y_dft_plain(psi_ys, True), f1, f2, step, zeta_top,
        zeta_bot, y_dft_plain(psi_top[:, -HALO_ROWS:], True),
        y_dft_plain(psi_bot[:, :HALO_ROWS], True))
    return zeta_new, carry, y_dft_plain(zeta_new, False)


def _consts(cfg: ModelConfig) -> ctypes.Array:
    """The kernels' float constants in StepConsts order, each rounded once
    from its float64 value; the per-layer betas are (beta_1, beta_2), or
    (beta, 0) for one layer."""
    dx = cfg.dx
    betas = ((cfg.beta, 0.0) if cfg.n_layers == 1
             else (cfg.beta_1, cfg.beta_2))
    vals = [1.0 / (dx * dx), 0.5 / dx, 12.0 * dx * dx, cfg.visc,
            *betas, cfg.U, cfg.r, cfg.dt, 2.0 * cfg.dt,
            cfg.ra_filter, 23.0 / 12.0, 16.0 / 12.0, 5.0 / 12.0]
    return (ctypes.c_float * len(vals))(*vals)


@functools.lru_cache(maxsize=8)
def _wind_row(cfg: ModelConfig, device: torch.device):
    """The (P,) layer-1 wind forcing F(y) in float32 on ``device``; None
    when the forcing is off."""
    if cfg.wind_tau0 == 0.0:
        return None
    from ..models.core import _wind_forcing
    return _wind_forcing(cfg, torch.float32, device)[0].contiguous()


def _modal_consts(cfg: ModelConfig) -> ctypes.Array:
    """K8's P^-1 entries in ModalConsts order, rounded once."""
    (q11, q12), (q21, q22) = cfg.P_inv_matrix()
    return (ctypes.c_float * 4)(q11, q12, q21, q22)


def _lib():
    lib = _build.load()
    if lib.qg_step_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _build.declare(lib.qg_step_launch,
                       [p, p, p, p, p, p, p, i, i, p, i, i, p])
        _build.declare(lib.qg_pre_inversion_launch,
                       [p, p, p, p, p, p, p, p, i, i, i, p, p, i, i, p])
        _build.declare(lib.qg_yspec_launch,
                       [p] * 9 + [i, i, p, p, p, i, p, p])
        _build.declare(lib.qg_fullstep_launch,
                       [p] * 9 + [i, i] + [p] * 8 + [i, p, p])
        _build.declare(lib.qg_tendency_launch, [p, p, p, p, i, i, i, p, p])
        _build.declare(lib.qg_tendency_rows_launch,
                       [p, p, p, p, i, i, i, p, i, i, i, i, p])
        _build.declare(lib.qg_tendency_rows_attributes, [i] * 4 + [p] * 4)
        _build.declare(lib.qg_step_sharded_launch,
                       [p] * 7 + [i, i, p, i, i] + [p] * 4 + [i, p])
        _build.declare(lib.qg_step_rows_launch,
                       [p] * 7 + [i, i, p, i, i, i, i, i, i, i] + [p] * 4
                       + [i, p])
        _build.declare(lib.qg_step_rows_attributes, [i] * 4 + [p] * 4)
        _build.declare(lib.qg_yspec_sharded_launch,
                       [p] * 9 + [i, i, p, p, p] + [p] * 4
                       + [i, p, p, i, p, p])
        _build.declare(lib.qg_yspec_rows_launch,
                       [p] * 9 + [i, i, p, p, i, p, p])
        _build.declare(lib.qg_fullstep_rows_launch,
                       [p] * 9 + [i, i] + [p] * 6 + [i, p, p])
        _build.declare(lib.qg_yspec_sharded_rows_launch,
                       [p] * 9 + [i, i, p, p] + [p] * 4
                       + [i, p, p, i, p, p])
        lib.qg_coop_rows_plan_size.restype = ctypes.c_int
        lib.qg_step_num_consts.restype = ctypes.c_int
        lib.qg_modal_num_consts.restype = ctypes.c_int
    return lib


def _check_operands(what: str, zeta: torch.Tensor, operands, shape) -> None:
    """float32, contiguous, of ``shape``, on zeta's device."""
    for name, t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != zeta.device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"zeta on {zeta.device}")


def _check_two_layer_step(what: str, cfg: ModelConfig, zeta: torch.Tensor,
                         psi: torch.Tensor, f1: torch.Tensor,
                         f2: torch.Tensor) -> None:
    """The operands of a two-layer step kernel (K1, K15, K17): CUDA,
    float32, contiguous (2, M, P) fields."""
    if zeta.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {zeta.device}")
    if cfg.n_layers != 2 or zeta.dim() != 3 or zeta.shape[0] != 2:
        raise ValueError(f"{what}: the kernel takes two-layer (2, M, P) "
                         f"fields, got {tuple(zeta.shape)}")
    _check_operands(what, zeta, (("zeta", zeta), ("psi", psi), ("f1", f1),
                                 ("f2", f2)), (2, cfg.M, cfg.P))


def _checked_consts(cfg: ModelConfig, lib, what: str) -> ctypes.Array:
    consts = _consts(cfg)
    if len(consts) != lib.qg_step_num_consts():
        raise RuntimeError(f"{what}: constant table does not match the "
                           "compiled kernel")
    return consts


# ---------------------------------------------------------------------------
# K1 and K12 in the row-streaming design (csrc step_rows_kernel,
# step_rows_sharded_kernel).
# ---------------------------------------------------------------------------

# The layouts (W, R, D, NT) of the sweep: W columns a strip, R rows a run,
# D rows ahead, NT threads; each thread owns 4 columns of a row, so a group
# is G = 4 NT / W rows. The source instantiates every (W, D, NT); R is a
# launch argument (any R >= 1). fused_step and fused_step_sharded launch
# STEP_ROWS_BY_M[M] (the layout of chip_smoke.py's k1_sweep with the least
# device time at that M, PERF.md), else STEP_ROWS.
STEP_ROWS_WIDTHS = (128, 256)
STEP_ROWS_RUNS = (32, 64, 128)
STEP_ROWS_AHEAD = (2, 4, 8)
STEP_ROWS_THREADS = (128,)
STEP_ROWS = (256, 64, 4, 128)
STEP_ROWS_BY_M = {2048: (256, 64, 8, 128), 8192: (256, 32, 4, 128)}


class RowsLayout(NamedTuple):
    """A row-streaming block (csrc RowsLayout): W columns, R rows a run, D
    rows ahead, NT threads, G rows a group, S ring slots of psi and
    zeta (G + 3 + D), and bytes of shared memory (the S mbarriers padded to
    16 bytes, the two rings and the G + 2 lap(psi) rows of W + 8 floats)."""
    W: int
    R: int
    D: int
    NT: int
    G: int
    S: int
    smem: int


def step_rows_layout(layout: tuple) -> RowsLayout:
    W, R, D, NT = layout
    G = 4 * NT // W
    S = G + 3 + D
    smem = -(-8 * S // 16) * 16 + (2 * S + G + 2) * (W + 8) * 4
    return RowsLayout(W, R, D, NT, G, S, smem)


def step_rows_layouts() -> list:
    """Every layout of the sweep, in sweep order."""
    return [(W, R, D, NT) for W in STEP_ROWS_WIDTHS for NT in STEP_ROWS_THREADS
            for D in STEP_ROWS_AHEAD for R in STEP_ROWS_RUNS]


def step_rows_launched(M: int) -> tuple:
    """The layout fused_step and fused_step_sharded launch at M rows."""
    return STEP_ROWS_BY_M.get(M, STEP_ROWS)


def step_rows_takes(P: int, *tensors: torch.Tensor) -> bool:
    """True iff the row-streaming kernels take a block P wide with these
    operands: P a multiple of 4 (a row is whole 16-byte pieces) and every
    operand 16-byte aligned (the bulk copies and float4 accesses). A
    tensor that torch allocates is aligned; a view that starts part way
    into a 16-byte piece is not, and sends the call to the tile kernel
    (1.4-1.8x slower, PERF.md), which rows_launches shows."""
    return (P >= 4 and P % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_rows_layout(what: str, layout: tuple) -> None:
    W, R, D, NT = layout
    if (W not in STEP_ROWS_WIDTHS or D not in STEP_ROWS_AHEAD
            or NT not in STEP_ROWS_THREADS or R < 1):
        raise ValueError(f"{what}: layout {layout} (W, R, D, NT) is not one "
                         f"the source instantiates")


def _row_source(field: torch.Tensor, slab, M: int):
    """Row x of every layer of ``field`` as the producer picks it: wrapped
    periodically (slab None: K1), else from the block, the top slab above
    it or the bottom slab below it (K12). None past the bottom slab."""
    if slab is None:
        return lambda x: field[:, x % M]
    top, bot = slab
    H = top.shape[1]

    def row(x):
        if x < 0:
            return top[:, H + x]
        if x >= M:
            return bot[:, x - M] if x - M < H else None
        return field[:, x]
    return row


# csrc step_device.cuh's tendency bodies (kBody): K1's, every neighbour read
# as the centre, the x neighbours read as the centre, no Jacobian (K18's
# norot, noslice and nojac; ops/_stencil_lab.py KERNEL_BODY names them).
BODY_BASE, BODY_NOROT, BODY_NOSLICE, BODY_NOJAC = 0, 1, 2, 3


def fused_step_rows_emulated(cfg: ModelConfig, zeta: torch.Tensor,
                             psi: torch.Tensor, f1: torch.Tensor | None,
                             f2: torch.Tensor | None, step: int,
                             layout: tuple, slabs=None,
                             slots: int | None = None, body: int = BODY_BASE,
                             tend_only: bool = False):
    """The row-streaming kernel's index maps in plain torch: every block
    of ``layout`` (W, R, D, NT), all layers and strips of a run at once and
    the runs in turn, through the same schedule as csrc step_rows: the
    prologue fill of the psi and zeta rings, then per group the waits on
    the rows it newly needs, lap(psi) into the lap ring, the body of its G
    rows from the rings and from f1 and f2 (read where the scheme reads
    them), and the producer's refills. A ring row holds the columns
    (y0 - 4 + k) mod P, k < w + 8 (the strip and its two 4-column halo
    pieces); every unfilled entry is NaN. ``slabs`` = (zeta_top,
    zeta_bot, psi_top, psi_bot) makes it K12's (rows outside [0, M) from
    the slabs), None K1's (the periodic wrap); ``slots`` overrides the ring
    size S (to show that a short ring is caught). The layer count L is the
    fields' first extent; ``body`` is the tendency body (BODY_*: K18's,
    with lap(psi) and the body reading the centre for the neighbours it
    drops); ``tend_only`` is K9's (the tendency into the first output, no
    f1/f2 reads, no update, no carry: f1 and f2 may be None).

    Returns (zeta_new, carry, stores, bad_reads), zeta_new the tendency and
    carry None with ``tend_only``: ``stores`` counts the stores of each
    output element; ``bad_reads`` counts the ring reads and waits that did
    not find their row filled and waited on, and the fills of a slot whose
    previous row was never waited on."""
    lay = step_rows_layout(layout)
    W, D, G = lay.W, lay.D, lay.G
    S = slots or lay.S
    L, M, P = zeta.shape
    DX = 0 if body in (BODY_NOROT, BODY_NOSLICE) else 1
    DY = 0 if body == BODY_NOROT else 1
    R = lay.R
    dev, dt = zeta.device, zeta.dtype
    nan = float("nan")
    strips = -(-P // W)
    y0 = torch.arange(strips, device=dev) * W
    w = torch.clamp(P - y0, max=W)
    k = torch.arange(W + 8, device=dev)
    ring_cols = (y0[:, None] - 4 + k) % P                     # (strips, W+8)
    ring_ok = k < w[:, None] + 8
    src_p = _row_source(psi, None if slabs is None else slabs[2:], M)
    src_z = _row_source(zeta, None if slabs is None else slabs[:2], M)
    rd1 = not tend_only and ((step != 0) if cfg.time_scheme == "leapfrog_ra"
                             else step >= 2)
    rd2 = not tend_only and cfg.time_scheme != "leapfrog_ra" and step >= 2
    wind = None
    if cfg.wind_tau0 != 0.0:
        from ..models.core import _wind_forcing
        wind = _wind_forcing(cfg, dt, dev)[0]
    zeta_new = torch.full_like(zeta, nan)
    carry = None if tend_only else torch.full_like(zeta, nan)
    stores = torch.zeros(zeta.shape, dtype=torch.int64, device=dev)
    bad = 0
    j = torch.arange(W, device=dev)
    col_ok = j < w[:, None]                                    # (strips, W)
    inv = 1.0 / (cfg.dx * cfg.dx)

    def lap(c, xm, xp, ym, yp):
        return ((((xm + xp) - 4.0 * c) + ym) + yp) * inv

    def as_ring(row):
        """(L, P) row -> (L, strips, W + 8) ring rows, NaN where unfilled."""
        r = row[:, ring_cols]
        return torch.where(ring_ok, r, torch.full_like(r, nan))

    for x0 in range(0, M, R):
        x_end = min(x0 + R, M)
        last = x_end + 1
        pring = torch.full((L, strips, S, W + 8), nan, dtype=dt, device=dev)
        zring = torch.full_like(pring, nan)
        lring = torch.full((L, strips, G + 2, W + 8), nan, dtype=dt,
                           device=dev)
        filled = [None] * S       # the row each slot was last filled with
        seen = [None] * S         # the row visible after its wait
        lap_held = [None] * (G + 2)

        def slot(r):
            return (r - x0 + 2) % S

        def fill(r):
            nonlocal bad
            s = slot(r)
            if filled[s] is not None and seen[s] != filled[s]:
                bad += 1
            filled[s], seen[s] = r, None
            prow = src_p(r)
            if prow is None:
                bad += 1
                return
            pring[:, :, s] = as_ring(prow)
            zrow = src_z(r) if x0 - 1 <= r <= x_end else None
            zring[:, :, s] = nan if zrow is None else as_ring(zrow)

        def slots_of(rows, held, kind):
            """Ring slots of ``rows``, counting reads that miss their row."""
            nonlocal bad
            out = []
            for r in rows:
                s = slot(r) if kind == "ring" else (r - x0 + 1) % (G + 2)
                if held[s] != r:
                    bad += 1
                out.append(s)
            return torch.tensor(out, device=dev)

        nxt = x0 - 2
        while nxt <= min(x0 - 3 + S, last):
            fill(nxt)
            nxt += 1
        ready = x0 - 3
        for x in range(x0, x_end, G):
            for r in range(ready + 1, min(x + G + 1, last) + 1):
                s = slot(r)
                if filled[s] != r:
                    bad += 1
                seen[s] = r
            ready = min(x + G + 1, last)

            lap_rows = list(range(x0 - 1 if x == x0 else x + 1,
                                  min(x + G, x_end) + 1))
            pc = pring[:, :, slots_of(lap_rows, seen, "ring")]
            pm = pring[:, :, slots_of([r - 1 for r in lap_rows], seen, "ring")]
            pp = pring[:, :, slots_of([r + 1 for r in lap_rows], seen, "ring")]
            ls = torch.tensor([(r - x0 + 1) % (G + 2) for r in lap_rows],
                              device=dev)
            # columns -1 .. W of the strip: ring entries 3 .. W + 4; the
            # body's dropped neighbours read as the centre
            cc = slice(3, W + 5)
            qm, qp = (pm, pp) if DX else (pc, pc)
            ym, yp = ((slice(2, W + 4), slice(4, W + 6)) if DY
                      else (cc, cc))
            lring[:, :, ls, cc] = lap(pc[..., cc], qm[..., cc], qp[..., cc],
                                      pc[..., ym], pc[..., yp])
            for r in lap_rows:
                lap_held[(r - x0 + 1) % (G + 2)] = r

            rows = [xi for xi in range(x, x + G) if xi < x_end]
            zm, zc, zp = (zring[:, :, slots_of([r + d for r in rows], seen,
                                               "ring")]
                          for d in (-1, 0, 1))
            p_m, p_c, p_p = (pring[:, :, slots_of([r + d for r in rows], seen,
                                                  "ring")]
                             for d in (-1, 0, 1))
            lm, lc, lp = (lring[:, :, slots_of([r + d for r in rows],
                                               lap_held, "lap")]
                          for d in (-1, 0, 1))
            C = slice(4, W + 4)
            Ym, Yp = (slice(3, W + 3), slice(5, W + 5)) if DY else (C, C)
            if not DX:
                zm, zp, p_m, p_p, lm, lp = zc, zc, p_c, p_c, lc, lc
            visc = cfg.visc * lap(lc[..., C], lm[..., C], lp[..., C],
                                  lc[..., Ym], lc[..., Yp])
            z_xp, z_xm = zp[..., C], zm[..., C]
            z_yp, z_ym = zc[..., Yp], zc[..., Ym]
            z_xpyp, z_xpym = zp[..., Yp], zp[..., Ym]
            z_xmyp, z_xmym = zm[..., Yp], zm[..., Ym]
            p_xp, p_xm = p_p[..., C], p_m[..., C]
            p_yp, p_ym = p_c[..., Yp], p_c[..., Ym]
            p_xpyp, p_xpym = p_p[..., Yp], p_p[..., Ym]
            p_xmyp, p_xmym = p_m[..., Yp], p_m[..., Ym]
            j_pp = (z_xp - z_xm) * (p_yp - p_ym) - (z_yp - z_ym) * (p_xp - p_xm)
            j_pt = (((z_xp * (p_xpyp - p_xpym) - z_xm * (p_xmyp - p_xmym))
                     - z_yp * (p_xpyp - p_xmyp)) + z_ym * (p_xpym - p_xmym))
            j_tp = (((z_xpyp * (p_yp - p_xp) - z_xmym * (p_xm - p_ym))
                     - z_xmyp * (p_yp - p_xm)) + z_xpym * (p_xp - p_ym))
            tend = visc
            if body != BODY_NOJAC:
                tend = tend - ((j_pp + j_pt) + j_tp) / (12.0 * cfg.dx
                                                        * cfg.dx)
            dpsi_dx = (0.5 / cfg.dx) * (p_xp - p_xm)
            betas = (cfg.beta,) if L == 1 else (cfg.beta_1, cfg.beta_2)
            t0 = tend[0] - betas[0] * dpsi_dx[0]
            if L == 2 or body in (BODY_BASE, BODY_NOROT):
                t0 = t0 - cfg.U * ((0.5 / cfg.dx) * (z_xp[0] - z_xm[0]))
            if L == 1:
                t0 = t0 - cfg.r * lc[0][..., C]
            if wind is not None:
                t0 = t0 + wind[(y0[:, None] + j) % P][:, None, :]
            layers = [t0]
            if L == 2:
                layers.append((tend[1] - betas[1] * dpsi_dx[1])
                              - cfg.r * lc[1][..., C])
            tend = torch.stack(layers)

            xi = torch.tensor(rows, device=dev)
            at = ((torch.arange(L, device=dev)[:, None, None, None] * M
                   + xi[None, None, :, None]) * P
                  + (y0[:, None] + j)[None, :, None, :])
            ok = col_ok[None, :, None, :].expand_as(at)
            at = torch.where(ok, at, torch.zeros_like(at))
            flat = at[ok]
            if tend_only:
                zeta_new.view(-1)[flat] = tend.expand_as(at)[ok]
            else:
                zero = torch.zeros((), dtype=dt, device=dev)
                fv1 = f1.reshape(-1)[at] if rd1 else zero
                fv2 = f2.reshape(-1)[at] if rd2 else zero
                zn, out = _update_point(cfg, step, zc[..., C], tend, fv1,
                                        fv2)
                zeta_new.view(-1)[flat] = zn.expand_as(at)[ok]
                carry.view(-1)[flat] = out.expand_as(at)[ok]
            stores.view(-1).index_add_(0, flat, torch.ones_like(flat))

            upto = min(x + 2 * G + 1 + D, last)
            while nxt <= upto:
                fill(nxt)
                nxt += 1
    return zeta_new, carry, stores, bad


def _update_point(cfg: ModelConfig, step: int, zc, tend, f1v, f2v):
    """csrc step_update on tensors: (zeta_new, carry)."""
    dt = cfg.dt
    if cfg.time_scheme == "leapfrog_ra":
        zpf = zc if step == 0 else f1v
        zn = zc + dt * tend if step == 0 else zpf + (2.0 * dt) * tend
        return zn, zc + cfg.ra_filter * ((zpf - 2.0 * zc) + zn)
    if step < 2:
        return zc + dt * tend, tend
    return zc + dt * (((23.0 / 12.0) * tend - (16.0 / 12.0) * f1v)
                      + (5.0 / 12.0) * f2v), tend


@functools.lru_cache(maxsize=64)
def step_rows_attributes(layout: tuple, sharded: bool, device: int) -> dict:
    """The compiled kernel of ``layout`` (K12's with ``sharded``) on card
    ``device``: registers a thread, local memory (spill) bytes a thread,
    shared memory a block and the most blocks an SM holds."""
    W, _, D, NT = layout
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        code = _lib().qg_step_rows_attributes(
            W, D, NT, int(sharded), *(ctypes.byref(v) for v in vals))
    _build.check(code, f"step rows attributes {layout}")
    return dict(zip(("regs", "local_bytes", "smem", "blocks_per_sm"),
                    (v.value for v in vals)))


def fused_step_rows(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                    f1: torch.Tensor, f2: torch.Tensor, step: int,
                    layout: tuple | None = None, slabs=None):
    """One launch of the row-streaming step on CUDA tensors: K1's
    (step_rows_kernel) on the (2, M, P) fields, or with ``slabs`` =
    (zeta_top, zeta_bot, psi_top, psi_bot) K12's
    (step_rows_sharded_kernel) on a (2, m, P) row block, in ``layout``
    (W, R, D, NT), by default step_rows_launched(M). Returns (zeta_new,
    carry). Raises on a shape or layout the kernel does not take and on a
    launch error. Counts nothing: the counting wrappers are fused_step and
    fused_step_sharded.

    Replaces ``tpu_qg/ops/pallas_tendency.py:555`` fused_step_streamed and
    ``:997`` fused_step_pre_fft (K1), ``:608`` fused_step_streamed_sharded
    (K12). Bound: six (2, M, P) fields through device memory (201 MB at
    2048^2, 0.060 ms at 3.35 TB/s). Why rows: the tile design loads its
    halo'd tile with one 4-byte load per element behind an integer division,
    and no block has a load in flight while it computes. Here one thread a
    block keeps D rows ahead of the block's group in flight with 1-D bulk
    copies, and the threads read the rings and move f1, f2, zeta_new and
    the carry 16 bytes at a time (design in csrc/step_kernel.cu)."""
    what = "fused_step_rows"
    _, M, P = zeta.shape
    layout = tuple(layout or step_rows_launched(M))
    _check_rows_layout(what, layout)
    if slabs is None:
        _check_two_layer_step(what, cfg, zeta, psi, f1, f2)
        wind = _wind_row(cfg, zeta.device)
        slab_ptrs, H = [None] * 4, 0
    else:
        wind = _check_sharded(what, cfg, (("zeta", zeta), ("psi", psi),
                                          ("f1", f1), ("f2", f2)),
                              tuple(zip(("zeta_top", "zeta_bot", "psi_top",
                                         "psi_bot"), slabs)))
        slab_ptrs, H = [t.data_ptr() for t in slabs], slabs[0].shape[1]
    extra = () if wind is None else (wind,)
    if not step_rows_takes(P, zeta, psi, f1, f2, *extra, *(slabs or ())):
        raise ValueError(f"{what}: P = {P} must be a multiple of 4 and "
                         f"every operand 16-byte aligned")
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    W, R, D, NT = layout
    zeta_new = torch.empty_like(zeta)
    carry = torch.empty_like(zeta)
    code = lib.qg_step_rows_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), M, P, consts, int(cfg.time_scheme == "leapfrog_ra"),
        int(step), W, R, D, NT, int(slabs is not None), *slab_ptrs, H,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, f"{what} {'(K12)' if slabs else '(K1)'} {layout}")
    return zeta_new, carry


def fused_step_tile(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                    f1: torch.Tensor, f2: torch.Tensor, step: int):
    """One launch of K1 in the tile design (csrc step_kernel, one block a
    32 x 64 tile) on CUDA tensors: fused_step's kernel on the shapes the
    row-streaming design does not take. Returns (zeta_new, carry); counts
    nothing."""
    _check_two_layer_step("fused_step_tile", cfg, zeta, psi, f1, f2)
    lib = _lib()
    consts = _checked_consts(cfg, lib, "fused_step_tile")
    wind = _wind_row(cfg, zeta.device)
    zeta_new = torch.empty_like(zeta)
    carry = torch.empty_like(zeta)
    stream = torch.cuda.current_stream(zeta.device).cuda_stream
    code = lib.qg_step_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(),
        zeta_new.data_ptr(), carry.data_ptr(), cfg.M, cfg.P, consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step), stream)
    _build.check(code, "fused_step_tile (K1)")
    return zeta_new, carry


def fused_step(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
               f1: torch.Tensor, f2: torch.Tensor, step: int):
    """K1: both layers' tendency + time update in one kernel pass on CUDA
    tensors, the plain version on CPU tensors. Returns (zeta_new, carry).
    Two hand-written kernels chosen by shape: the row-streaming kernel
    (fused_step_rows, layout step_rows_launched(M)) where step_rows_takes,
    counted also in ``fused_step.rows_launches``; the tile kernel
    (fused_step_tile) on the rest: P % 4 != 0, or an operand that is not
    16-byte aligned (a view part way into a 16-byte piece)."""
    if zeta.device.type == "cpu":
        return fused_step_plain(cfg, zeta, psi, f1, f2, step)
    wind = _wind_row(cfg, zeta.device)
    if step_rows_takes(cfg.P, zeta, psi, f1, f2,
                       *(() if wind is None else (wind,))):
        out = fused_step_rows(cfg, zeta, psi, f1, f2, step)
        fused_step.rows_launches += 1
    else:
        out = fused_step_tile(cfg, zeta, psi, f1, f2, step)
    fused_step.launches += 1
    return out


fused_step.launches = 0
fused_step.rows_launches = 0


def fused_tendency_plain(cfg: ModelConfig, zeta: torch.Tensor,
                         psi: torch.Tensor) -> torch.Tensor:
    """Plain-torch K9: ``models.core._tendencies``."""
    from ..models.core import _tendencies
    return _tendencies(cfg, zeta, psi)


# K9's row-streaming kernel (csrc tendency_rows_kernel<L, W, NT, D>): the
# source instantiates L in {1, 2} over every (W, D, NT) of K1's sweep, R a
# launch argument. fused_tendency launches TENDENCY_ROWS_BY_M[M] (the layout
# of chip_smoke.py's k9_sweep with the least device time at that M,
# PERF.md), else step_rows_launched(M).
TENDENCY_ROWS_BY_M = {2048: (256, 64, 8, 128), 8192: (256, 32, 8, 128)}


def tendency_rows_launched(M: int) -> tuple:
    """The layout fused_tendency launches at M rows."""
    return TENDENCY_ROWS_BY_M.get(M, step_rows_launched(M))


def _check_tendency(what: str, cfg: ModelConfig, zeta: torch.Tensor,
                    psi: torch.Tensor) -> None:
    if zeta.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {zeta.device}")
    _check_operands(what, zeta, (("zeta", zeta), ("psi", psi)),
                    (cfg.n_layers, cfg.M, cfg.P))


def fused_tendency_rows(cfg: ModelConfig, zeta: torch.Tensor,
                        psi: torch.Tensor,
                        layout: tuple | None = None) -> torch.Tensor:
    """One launch of K9's row-streaming kernel on CUDA tensors (one or two
    layers), in ``layout`` (W, R, D, NT), by default
    tendency_rows_launched(M). Raises on a shape or layout it does not take
    and on a launch error; counts nothing (fused_tendency counts)."""
    what = "fused_tendency_rows"
    _check_tendency(what, cfg, zeta, psi)
    layout = tuple(layout or tendency_rows_launched(cfg.M))
    _check_rows_layout(what, layout)
    wind = _wind_row(cfg, zeta.device)
    if not step_rows_takes(cfg.P, zeta, psi,
                           *(() if wind is None else (wind,))):
        raise ValueError(f"{what}: P = {cfg.P} must be a multiple of 4 and "
                         f"every operand 16-byte aligned")
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    W, R, D, NT = layout
    tend = torch.empty_like(zeta)
    code = lib.qg_tendency_rows_launch(
        zeta.data_ptr(), psi.data_ptr(),
        None if wind is None else wind.data_ptr(), tend.data_ptr(),
        cfg.n_layers, cfg.M, cfg.P, consts, W, R, D, NT,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, f"{what} (K9) {layout}")
    return tend


def fused_tendency_tile(cfg: ModelConfig, zeta: torch.Tensor,
                        psi: torch.Tensor) -> torch.Tensor:
    """One launch of K9's tile kernel (csrc tendency_kernel<L>, one block a
    32 x 64 tile) on CUDA tensors: fused_tendency's kernel on the shapes
    the row-streaming kernel does not take. Counts nothing."""
    _check_tendency("fused_tendency_tile", cfg, zeta, psi)
    lib = _lib()
    consts = _checked_consts(cfg, lib, "fused_tendency_tile")
    wind = _wind_row(cfg, zeta.device)
    tend = torch.empty_like(zeta)
    code = lib.qg_tendency_launch(
        zeta.data_ptr(), psi.data_ptr(),
        None if wind is None else wind.data_ptr(), tend.data_ptr(),
        cfg.n_layers, cfg.M, cfg.P, consts,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, "fused_tendency_tile (K9)")
    return tend


def fused_tendency(cfg: ModelConfig, zeta: torch.Tensor,
                   psi: torch.Tensor) -> torch.Tensor:
    """K9: every layer's tendency (with the wind forcing) in one kernel pass
    on CUDA tensors, the plain version on CPU tensors; a drop-in for
    ``_tendencies``. Replaces ``tpu_qg/ops/pallas_tendency.py:181``
    ``fused_tendency``; no step route runs it (the reference's tests and
    ``scripts/bench_variants.py`` call it). Bound: device-memory bandwidth;
    it reads zeta and psi and writes the tendency, three (L, M, P) fields,
    101 MB at 2048^2 and 1611 MB at 8192^2 for two layers (0.030 and 0.481
    ms at 3.35 TB/s). Two hand-written kernels, chosen by shape, giving the
    same bits: K1's row-streaming design with the f1/f2 loads, the update
    and the carry cut (fused_tendency_rows, ``tendency_rows_kernel`` in
    ``csrc/step_kernel.cu``: one thread a block keeps D rows of psi and
    zeta ahead in shared-memory rings by bulk copies, every thread stores
    its 4 points of the tendency with one 16-byte store) where
    step_rows_takes, counted also in ``fused_tendency.rows_launches``; K1's
    32 x 64 tile (fused_tendency_tile, ``tendency_kernel<L>``) on the rest:
    P % 4 != 0, or an operand that is not 16-byte aligned."""
    if zeta.device.type == "cpu":
        return fused_tendency_plain(cfg, zeta, psi)
    _check_tendency("fused_tendency", cfg, zeta, psi)
    wind = _wind_row(cfg, zeta.device)
    if step_rows_takes(cfg.P, zeta, psi, *(() if wind is None else (wind,))):
        tend = fused_tendency_rows(cfg, zeta, psi)
        fused_tendency.rows_launches += 1
    else:
        tend = fused_tendency_tile(cfg, zeta, psi)
    fused_tendency.launches += 1
    return tend


fused_tendency.launches = 0
fused_tendency.rows_launches = 0


@functools.lru_cache(maxsize=64)
def tendency_rows_attributes(layout: tuple, layers: int, device: int) -> dict:
    """K9's row kernel of ``layout`` for ``layers`` layers on card
    ``device``: registers a thread, local memory (spill) bytes a thread,
    shared memory a block and the most blocks an SM holds."""
    W, _, D, NT = layout
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        code = _lib().qg_tendency_rows_attributes(
            layers, W, D, NT, *(ctypes.byref(v) for v in vals))
    _build.check(code, f"tendency rows attributes {layout}")
    return dict(zip(("regs", "local_bytes", "smem", "blocks_per_sm"),
                    (v.value for v in vals)))


def fused_pre_inversion(cfg: ModelConfig, zeta: torch.Tensor,
                        psi: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                        step: int):
    """K8: every layer's tendency + time update, and the modes for the
    spectral solves, in one kernel pass on CUDA tensors; the plain version on
    CPU tensors. Returns (zeta_new, carry, modes); for one layer the modes
    are zeta_new itself."""
    if zeta.device.type == "cpu":
        return fused_pre_inversion_plain(cfg, zeta, psi, f1, f2, step)
    if zeta.device.type != "cuda":
        raise ValueError(f"fused_pre_inversion: unsupported device "
                         f"{zeta.device}")
    L = cfg.n_layers
    _check_operands("fused_pre_inversion", zeta,
                    (("zeta", zeta), ("psi", psi), ("f1", f1), ("f2", f2)),
                    (L, cfg.M, cfg.P))
    lib = _lib()
    consts = _checked_consts(cfg, lib, "fused_pre_inversion")
    modal = _modal_consts(cfg)
    if len(modal) != lib.qg_modal_num_consts():
        raise RuntimeError("fused_pre_inversion: modal constant table does "
                           "not match the compiled kernel")
    wind = _wind_row(cfg, zeta.device)
    zeta_new = torch.empty_like(zeta)
    carry = torch.empty_like(zeta)
    modes = torch.empty_like(zeta) if L == 2 else zeta_new
    stream = torch.cuda.current_stream(zeta.device).cuda_stream
    code = lib.qg_pre_inversion_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), modes.data_ptr() if L == 2 else None, L, cfg.M,
        cfg.P, consts, modal, int(cfg.time_scheme == "leapfrog_ra"),
        int(step), stream)
    _build.check(code, "fused_pre_inversion (K8)")
    fused_pre_inversion.launches += 1
    return zeta_new, carry, modes


fused_pre_inversion.launches = 0


def fused_step_yspec_coop(cfg: ModelConfig, zeta: torch.Tensor,
                          psi_ys: torch.Tensor, f1: torch.Tensor,
                          f2: torch.Tensor, step: int):
    """One launch of K15's first form (csrc/fused_kernels.cu
    coop_yspec_kernel: the first stage bodies in 512-thread blocks) on CUDA
    tensors: fused_step_yspec's kernel on the shapes coop_rows_takes
    refuses.
    Returns (zeta_new, carry, zeta_ys); counts nothing, records its grid in
    ``fused_step_yspec.grid``."""
    _check_two_layer_step("fused_step_yspec", cfg, zeta, psi_ys, f1, f2)
    lib = _lib()
    consts = _checked_consts(cfg, lib, "fused_step_yspec")
    plan, smem, (twy, twny, _, _), _, info = coop_launch_args(
        "fused_step_yspec", cfg.M, cfg.P, False, zeta.device)
    wind = _wind_row(cfg, zeta.device)
    zeta_new, carry, zeta_ys = (torch.empty_like(zeta) for _ in range(3))
    code = lib.qg_yspec_launch(
        zeta.data_ptr(), psi_ys.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), zeta_ys.data_ptr(), consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step), plan, twy, twny,
        smem, info, torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, "fused_step_yspec (K15)")
    fused_step_yspec.grid = tuple(info)
    return zeta_new, carry, zeta_ys


def fused_step_yspec(cfg: ModelConfig, zeta: torch.Tensor,
                     psi_ys: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                     step: int):
    """K15 on CUDA tensors (one cooperative launch), the plain version on
    CPU tensors. ``psi_ys`` is the permuted y-spectrum of the packed
    psi_1 + i psi_2 (what K3 or K5 writes). Returns (zeta_new, carry,
    zeta_ys), zeta_ys the permuted y-spectrum of the packed zeta_new (what
    K2 forward writes). Two hand-written kernels chosen by shape: the
    persistent kernel on the redesigned stages (fused_step_yspec_rows)
    where coop_rows_takes, counted also in ``fused_step_yspec.rows_launches``;
    the first form (fused_step_yspec_coop) on the rest."""
    if zeta.device.type == "cpu":
        return fused_step_yspec_plain(cfg, zeta, psi_ys, f1, f2, step)
    if coop_rows_takes(cfg.M, cfg.P, False, zeta, psi_ys, f1, f2,
                       *_wind_operand(cfg, zeta)):
        out = fused_step_yspec_rows(cfg, zeta, psi_ys, f1, f2, step)
        fused_step_yspec.rows_launches += 1
    else:
        out = fused_step_yspec_coop(cfg, zeta, psi_ys, f1, f2, step)
    fused_step_yspec.launches += 1
    return out


fused_step_yspec.launches = 0
fused_step_yspec.rows_launches = 0
fused_step_yspec.grid = None
fused_step_yspec.rows_grid = None


def _check_sharded(what: str, cfg: ModelConfig, fields, slabs):
    """The operands of a sharded step kernel: CUDA, float32, contiguous
    two-layer (2, m, P) fields and (2, H, P) slabs, H >= 2, and the wind
    row (if any) as wide as the block. Returns the wind row or None."""
    zeta = fields[0][1]
    if zeta.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {zeta.device}")
    if cfg.n_layers != 2 or zeta.dim() != 3 or zeta.shape[0] != 2:
        raise ValueError(f"{what}: the kernel takes two-layer (2, m, P) "
                         f"blocks, got {tuple(zeta.shape)}")
    _, m, P = zeta.shape
    _check_operands(what, zeta, fields, (2, m, P))
    H = slabs[0][1].shape[1] if slabs[0][1].dim() == 3 else 0
    if H < HALO_ROWS:
        raise ValueError(f"{what}: slabs need at least {HALO_ROWS} rows, got "
                         f"{tuple(slabs[0][1].shape)}")
    _check_operands(what, zeta, slabs, (2, H, P))
    if cfg.wind_tau0 != 0.0 and P != cfg.P:
        raise ValueError(f"{what}: the wind forcing needs whole rows "
                         f"(P = {cfg.P}), got a block {P} wide")
    return _wind_row(cfg, zeta.device)


def fused_step_sharded_tile(cfg: ModelConfig, zeta: torch.Tensor,
                            psi: torch.Tensor, f1: torch.Tensor,
                            f2: torch.Tensor, step: int,
                            zeta_top: torch.Tensor, zeta_bot: torch.Tensor,
                            psi_top: torch.Tensor, psi_bot: torch.Tensor):
    """One launch of K12 in the tile design (csrc step_sharded_kernel) on
    CUDA tensors: fused_step_sharded's kernel on the shapes the
    row-streaming design does not take. Returns (zeta_new, carry); counts
    nothing."""
    what = "fused_step_sharded_tile (K12)"
    wind = _check_sharded(what, cfg, (("zeta", zeta), ("psi", psi),
                                      ("f1", f1), ("f2", f2)),
                          (("zeta_top", zeta_top), ("zeta_bot", zeta_bot),
                           ("psi_top", psi_top), ("psi_bot", psi_bot)))
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    zeta_new = torch.empty_like(zeta)
    carry = torch.empty_like(zeta)
    _, m, P = zeta.shape
    code = lib.qg_step_sharded_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), m, P, consts, int(cfg.time_scheme == "leapfrog_ra"),
        int(step), zeta_top.data_ptr(), zeta_bot.data_ptr(),
        psi_top.data_ptr(), psi_bot.data_ptr(), zeta_top.shape[1],
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, what)
    return zeta_new, carry


def fused_step_sharded(cfg: ModelConfig, zeta: torch.Tensor,
                       psi: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                       step: int, zeta_top: torch.Tensor,
                       zeta_bot: torch.Tensor, psi_top: torch.Tensor,
                       psi_bot: torch.Tensor):
    """K12: K1 on one rank's (2, m, P) row block with its (2, H, P) slabs,
    one kernel pass on CUDA tensors; the plain version on CPU tensors.
    Replaces ``tpu_qg/ops/pallas_tendency.py:608``. Returns (zeta_new,
    carry). Two hand-written kernels chosen by shape, as fused_step's: the
    row-streaming kernel (fused_step_rows with the slabs) where
    step_rows_takes, counted also in ``fused_step_sharded.rows_launches``;
    the tile kernel (fused_step_sharded_tile) on the rest: P % 4 != 0, or
    an operand or slab that is not 16-byte aligned."""
    if zeta.device.type == "cpu":
        return fused_step_sharded_plain(cfg, zeta, psi, f1, f2, step,
                                        zeta_top, zeta_bot, psi_top, psi_bot)
    slabs = (zeta_top, zeta_bot, psi_top, psi_bot)
    wind = _wind_row(cfg, zeta.device)
    if step_rows_takes(zeta.shape[-1], zeta, psi, f1, f2, *slabs,
                       *(() if wind is None else (wind,))):
        out = fused_step_rows(cfg, zeta, psi, f1, f2, step, slabs=slabs)
        fused_step_sharded.rows_launches += 1
    else:
        out = fused_step_sharded_tile(cfg, zeta, psi, f1, f2, step, *slabs)
    fused_step_sharded.launches += 1
    return out


fused_step_sharded.launches = 0
fused_step_sharded.rows_launches = 0


def fused_step_yspec_sharded_coop(cfg: ModelConfig, zeta: torch.Tensor,
                                  psi_ys: torch.Tensor, f1: torch.Tensor,
                                  f2: torch.Tensor, step: int,
                                  zeta_top: torch.Tensor,
                                  zeta_bot: torch.Tensor,
                                  psi_top: torch.Tensor,
                                  psi_bot: torch.Tensor):
    """One launch of the first form of K15's sharded form
    (csrc/fused_kernels.cu coop_yspec_sharded_kernel: the first stage
    bodies in 512-thread blocks) on CUDA tensors: fused_step_yspec_sharded's
    kernel on the blocks and operands coop_rows_takes refuses. Returns
    (zeta_new, carry, zeta_ys); counts nothing, records its grid in
    ``fused_step_yspec_sharded.grid``."""
    what = "fused_step_yspec_sharded (K15 sharded)"
    wind = _check_sharded(what, cfg, (("zeta", zeta), ("psi_ys", psi_ys),
                                      ("f1", f1), ("f2", f2)),
                          (("zeta_top", zeta_top), ("zeta_bot", zeta_bot),
                           ("psi_top", psi_top), ("psi_bot", psi_bot)))
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    _, m, P = zeta.shape
    plan, smem, (twy, twny, _, _), _, info = coop_launch_args(
        what, m, P, False, zeta.device)
    zeta_new, carry, zeta_ys = (torch.empty_like(zeta) for _ in range(3))
    top_nat, bot_nat = torch.empty_like(psi_top), torch.empty_like(psi_bot)
    code = lib.qg_yspec_sharded_launch(
        zeta.data_ptr(), psi_ys.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), zeta_ys.data_ptr(), consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step), plan, twy, twny,
        zeta_top.data_ptr(), zeta_bot.data_ptr(), psi_top.data_ptr(),
        psi_bot.data_ptr(), zeta_top.shape[1], top_nat.data_ptr(),
        bot_nat.data_ptr(), smem, info,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, what)
    fused_step_yspec_sharded.grid = tuple(info)
    return zeta_new, carry, zeta_ys


def fused_step_yspec_sharded(cfg: ModelConfig, zeta: torch.Tensor,
                             psi_ys: torch.Tensor, f1: torch.Tensor,
                             f2: torch.Tensor, step: int,
                             zeta_top: torch.Tensor, zeta_bot: torch.Tensor,
                             psi_top: torch.Tensor, psi_bot: torch.Tensor):
    """K15's sharded form on CUDA tensors (one cooperative launch), the
    plain version on CPU tensors: K15 on one rank's (2, m, P) row block,
    zeta's slabs natural and psi's rows of its permuted y-spectrum.
    Replaces ``tpu_qg/ops/pallas_tendency.py:913``. Returns (zeta_new,
    carry, zeta_ys). Two hand-written kernels chosen by shape and operands:
    the persistent kernel on the redesigned stages
    (fused_step_yspec_sharded_rows) where coop_rows_takes over the block's
    operands and its four slabs, counted also in
    ``fused_step_yspec_sharded.rows_launches``; the first form
    (fused_step_yspec_sharded_coop) on the rest, a misaligned slab view
    among them."""
    if zeta.device.type == "cpu":
        return fused_step_yspec_sharded_plain(cfg, zeta, psi_ys, f1, f2,
                                              step, zeta_top, zeta_bot,
                                              psi_top, psi_bot)
    slabs = (zeta_top, zeta_bot, psi_top, psi_bot)
    if coop_rows_takes(zeta.shape[-2], zeta.shape[-1], False, zeta, psi_ys,
                       f1, f2, *_wind_operand(cfg, zeta), *slabs):
        out = fused_step_yspec_sharded_rows(cfg, zeta, psi_ys, f1, f2, step,
                                            *slabs)
        fused_step_yspec_sharded.rows_launches += 1
    else:
        out = fused_step_yspec_sharded_coop(cfg, zeta, psi_ys, f1, f2, step,
                                            *slabs)
    fused_step_yspec_sharded.launches += 1
    return out


fused_step_yspec_sharded.launches = 0
fused_step_yspec_sharded.rows_launches = 0
fused_step_yspec_sharded.grid = None
fused_step_yspec_sharded.rows_grid = None


# ---------------------------------------------------------------------------
# K17: the whole step in one launch.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def packed_symbol_consts(cfg: ModelConfig) -> tuple:
    """The packed inversion's symbol constants for cfg's grid (as
    PackedModalInverterKernels builds them)."""
    return symbol_consts(cfg.M, cfg.P, cfg.dx, cfg.S_eig, cfg.P_inv_matrix(),
                         cfg.back_projection_matrix())


def fused_step_full_plain(cfg: ModelConfig, zeta: torch.Tensor,
                          psi: torch.Tensor, f1: torch.Tensor,
                          f2: torch.Tensor, step: int):
    """Plain-torch K17: K1's plain version, then K16's on zeta_new.
    Returns (zeta_new, carry, psi_new)."""
    zeta_new, carry = fused_step_plain(cfg, zeta, psi, f1, f2, step)
    return zeta_new, carry, mono_invert_plain(zeta_new,
                                              packed_symbol_consts(cfg))


def fused_step_full_coop(cfg: ModelConfig, zeta: torch.Tensor,
                         psi: torch.Tensor, f1: torch.Tensor,
                         f2: torch.Tensor, step: int):
    """One launch of K17's first form (csrc/fused_kernels.cu
    coop_fullstep_kernel: the first stage bodies in 512-thread blocks) on CUDA
    tensors: fused_step_full's kernel on the shapes coop_rows_takes refuses.
    Returns (zeta_new, carry, psi_new); counts nothing, records its grid in
    ``fused_step_full.grid``."""
    _check_two_layer_step("fused_step_full", cfg, zeta, psi, f1, f2)
    lib = _lib()
    consts = _checked_consts(cfg, lib, "fused_step_full")
    sym = check_consts("fused_step_full", packed_symbol_consts(cfg), cfg.M,
                       cfg.P)
    plan, smem, tw, (own, mirror), info = coop_launch_args(
        "fused_step_full", cfg.M, cfg.P, True, zeta.device)
    wind = _wind_row(cfg, zeta.device)
    zeta_new, carry, psi_new = (torch.empty_like(zeta) for _ in range(3))
    code = lib.qg_fullstep_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), psi_new.data_ptr(), consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step), plan, sym, *tw,
        own.data_ptr(), mirror.data_ptr(), smem, info,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, "fused_step_full (K17)")
    fused_step_full.grid = tuple(info)
    return zeta_new, carry, psi_new


def fused_step_full(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                    f1: torch.Tensor, f2: torch.Tensor, step: int):
    """K17 on CUDA tensors (one cooperative launch: the step, then the
    packed inversion of zeta_new), the plain version on CPU tensors.
    Replaces ``tpu_qg/ops/pallas_fullstep.py`` ``fused_step_full``.
    Returns (zeta_new, carry, psi_new). Two hand-written kernels chosen by
    shape: the persistent cluster kernel on the redesigned stages
    (fused_step_full_rows) where coop_rows_takes, counted also in
    ``fused_step_full.rows_launches``; the first form
    (fused_step_full_coop) on the rest."""
    if zeta.device.type == "cpu":
        return fused_step_full_plain(cfg, zeta, psi, f1, f2, step)
    if coop_rows_takes(cfg.M, cfg.P, True, zeta, psi, f1, f2,
                       *_wind_operand(cfg, zeta)):
        out = fused_step_full_rows(cfg, zeta, psi, f1, f2, step)
        fused_step_full.rows_launches += 1
    else:
        out = fused_step_full_coop(cfg, zeta, psi, f1, f2, step)
    fused_step_full.launches += 1
    return out


fused_step_full.launches = 0
fused_step_full.rows_launches = 0
fused_step_full.grid = None
fused_step_full.rows_grid = None


# ---------------------------------------------------------------------------
# K15, its sharded form and K17 on the redesigned stages
# (csrc/coop_rows.cuh): persistent cooperative kernels whose stages loop
# over K1's (K12's) row units, K2's factored row groups and (K17) K3's
# cluster tile pairs.
# ---------------------------------------------------------------------------

# The step stage's units: K1's row-streaming layout (W, R, D, NT) with W =
# 256, D = 8 (K1's launched layout at 2048^2) and R that of K1's launched
# layout at M; two 128-thread units a 256-thread block, each with its own
# ring (csrc coop_rows.cuh). The source instantiates this (W, D, NT) alone.
COOP_ROWS_STEP = (256, 8, 128)
COOP_ROWS_THREADS = dft_kernels.COOP_ROWS_THREADS


class CoopRowsPlan(NamedTuple):
    """A persistent one-launch kernel's plan (csrc RowsPlan): ``ints`` in
    RowsPlan order (M, P, R, y N2, log2 Rb, y's packed mixed plan or 0, x
    N2, log2 G, log2 Cw, tile pairs, x's packed plan or 0, the y-spectrum's
    N1, the stages run: all, 4 or 3); each stage's layout (``step`` (W, R, D, NT), ``y`` K2's (Rb,
    threads), ``x`` K3's (G, Cw) or None) and bytes of shared memory for
    the largest stage."""
    ints: tuple
    step: tuple
    y: tuple
    x: tuple | None
    smem: int


@functools.lru_cache(maxsize=256)
def coop_rows_plan(M: int, P: int, x_stage: bool) -> CoopRowsPlan:
    """The plan of K17 (``x_stage``) or K15 and its sharded form (M the
    block's rows) at (M, P): every stage in its separate kernel's launched
    layout (K1's R, K2's y_dft_factored_launched, K3's
    pair_x_cluster_launched: dft_kernels.coop_rows_transforms), shared
    memory the largest of two step units' rings, K2's block and K3's block.
    Raises where a stage's kernel does not take the shape (coop_rows_takes
    says where)."""
    if not coop_rows_shape(M, P, x_stage):
        raise ValueError(f"the persistent one-launch kernels do not take "
                         f"({M}, {P}) (x stage: {x_stage})")
    W, D, NT = COOP_ROWS_STEP
    step = (W, step_rows_launched(M)[1], D, NT)
    t = dft_kernels.coop_rows_transforms(M, P, x_stage)
    ints = (M, P, step[1], *t.y, *t.x, t.n1y, 4 if x_stage else 3)
    return CoopRowsPlan(ints, step, t.y_layout, t.x_layout,
                        max(2 * step_rows_layout(step).smem, t.smem))


@functools.lru_cache(maxsize=1024)
def coop_rows_shape(M: int, P: int, x_stage: bool) -> bool:
    """True iff every stage's redesigned kernel takes (M, P): K1's row
    kernel (P % 4 == 0), K2's factored or mixed-radix kernel at P in its
    256-thread layout, and, with the x stage, K3's cluster or mixed cluster
    kernel at M (dft_kernels.coop_rows_transforms_shape); and the largest
    stage's shared memory fits a block."""
    if not (P % 4 == 0
            and dft_kernels.coop_rows_transforms_shape(M, P, x_stage)):
        return False
    W, D, NT = COOP_ROWS_STEP
    return max(2 * step_rows_layout((W, 1, D, NT)).smem,
               dft_kernels.coop_rows_transforms(M, P, x_stage).smem
               ) <= dft_kernels.SMEM_LIMIT


def coop_rows_takes(M: int, P: int, x_stage: bool,
                    *tensors: torch.Tensor) -> bool:
    """True iff K17's (``x_stage``), K15's or (with the slabs among the
    tensors) K15's sharded persistent kernel takes an (M, P) step with
    these operands: the shape (coop_rows_shape) and K1's row kernel's
    operands (step_rows_takes: every operand 16-byte aligned); the first
    forms keep the rest."""
    return (coop_rows_shape(M, P, x_stage)
            and step_rows_takes(P, *tensors))


def coop_rows_schedule(M: int, P: int, x_stage: bool, blocks: int,
                       slab_rows: int = 0) -> dict:
    """The units each stage's loop runs on ``blocks`` blocks, as csrc
    coop_rows.cuh's loops take them: "step" maps (block, half) to its K1
    units (strip, run, layer), unit u = strip + strips (run + runs layer)
    taken by half u mod 2 of block u div 2 mod blocks, ... (R from
    coop_rows_unit_rows, so that every unit runs in one round); "y" (and,
    with ``slab_rows`` = H, K15's sharded first stage "y_slabs") and, for
    K17, "x": dft_kernels.coop_rows_transforms_schedule. Each stage's
    ``units`` lists its separate kernel's units in launch order."""
    plan = coop_rows_plan(M, P, x_stage)
    W, _, _, NT = plan.step
    per = COOP_ROWS_THREADS // NT
    strips = -(-P // W)
    R = coop_rows_unit_rows(plan, blocks)
    runs = -(-M // R)
    step_units = [(u % strips, (u // strips) % runs, u // (strips * runs))
                  for u in range(2 * strips * runs)]
    step = {}
    for b in range(blocks):
        for h in range(per):
            step[(b, h)] = [step_units[u] for u in
                            range(b * per + h, len(step_units), blocks * per)]
    return {"step": step, "step_units": step_units,
            **dft_kernels.coop_rows_transforms_schedule(M, P, x_stage, blocks,
                                                        slab_rows)}


def coop_rows_unit_rows(plan: CoopRowsPlan, blocks: int) -> int:
    """The rows of a step unit on ``blocks`` blocks (csrc unit_rows): K1's
    launched R, or more, so that the units, two a block, all run in one
    round."""
    M, P, R = plan.ints[:3]
    W, _, _, NT = plan.step
    runs = max(1, blocks * (COOP_ROWS_THREADS // NT) // (2 * -(-P // W)))
    return max(R, -(-M // runs))


def _wind_operand(cfg: ModelConfig, zeta: torch.Tensor) -> tuple:
    wind = _wind_row(cfg, zeta.device)
    return () if wind is None else (wind,)


def fused_step_yspec_rows(cfg: ModelConfig, zeta: torch.Tensor,
                          psi_ys: torch.Tensor, f1: torch.Tensor,
                          f2: torch.Tensor, step: int,
                          stages: int | None = None):
    """One launch of the persistent K15 (csrc coop_yspec_rows_kernel) on
    CUDA tensors: inverse-y by K2's factored body, the step by K1's row
    units, forward-y by K2's factored body, grid barriers between them.
    Returns (zeta_new, carry, zeta_ys): fused_step_yspec's result. Raises
    on a shape or operand the kernel does not take (coop_rows_takes) and on
    a launch the card refuses; counts nothing, records (blocks, clusters,
    blocks an SM, the step units' rows R) in ``fused_step_yspec.rows_grid``. ``stages`` < 3 stops
    after that many stages (1: zeta_ys holds natural psi; 2: zeta_new and
    the carry are final), to check a stage alone.

    Replaces ``tpu_qg/ops/pallas_tendency.py:839``
    fused_step_streamed_yspec. Bound: seven (2, M, P) fields (235 MB at
    2048^2, 0.070 ms; 3758 MB at 8192^2, 1.122 ms). Why: the first form
    runs the first stage bodies and loses to the redesigned kernels it
    fuses (PERF.md)."""
    what = "fused_step_yspec_rows (K15)"
    _check_two_layer_step(what, cfg, zeta, psi_ys, f1, f2)
    wind = _wind_row(cfg, zeta.device)
    if not coop_rows_takes(cfg.M, cfg.P, False, zeta, psi_ys, f1, f2,
                           *_wind_operand(cfg, zeta)):
        raise ValueError(f"{what}: ({cfg.M}, {cfg.P}) or its operands are "
                         f"not taken (coop_rows_takes)")
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    plan = coop_rows_plan(cfg.M, cfg.P, False)
    zeta_new, carry, zeta_ys = (torch.empty_like(zeta) for _ in range(3))
    info = (ctypes.c_int * 4)()
    code = lib.qg_yspec_rows_launch(
        zeta.data_ptr(), psi_ys.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), zeta_ys.data_ptr(), consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step),
        dft_kernels._rows_plan_array(lib, what, plan, stages),
        dft_kernels._twiddles(cfg.P, cfg.P, zeta.device).data_ptr(),
        plan.smem, info, torch.cuda.current_stream(zeta.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
    fused_step_yspec.rows_grid = tuple(info)
    return zeta_new, carry, zeta_ys


def fused_step_full_rows(cfg: ModelConfig, zeta: torch.Tensor,
                         psi: torch.Tensor, f1: torch.Tensor,
                         f2: torch.Tensor, step: int,
                         stages: int | None = None):
    """One launch of the persistent K17 (csrc coop_fullstep_rows_kernel) on
    CUDA tensors, clustered by K3's G: the step by K1's row units,
    forward-y by K2's factored body, the x stage by K3's cluster tile
    pairs, inverse-y, grid barriers between them. Returns (zeta_new, carry,
    psi_new): fused_step_full's result. Raises on a shape or operand the
    kernel does not take (coop_rows_takes), on a layout with no resident
    cluster and on a launch the card refuses; counts nothing, records
    (blocks, clusters, blocks an SM, the step units' rows R) in
    ``fused_step_full.rows_grid``.
    ``stages`` < 4 stops after that many stages (psi_new then holds the
    y-spectrum of zeta_new (2) or the x stage's output (3)), to check a
    stage alone.

    Replaces ``tpu_qg/ops/pallas_fullstep.py:308`` fused_step_full. Bound:
    seven (2, M, P) fields (235 MB at 2048^2, 0.070 ms). Why: the first
    form runs the first stage bodies and loses to the four redesigned
    kernels it fuses (PERF.md)."""
    what = "fused_step_full_rows (K17)"
    _check_two_layer_step(what, cfg, zeta, psi, f1, f2)
    wind = _wind_row(cfg, zeta.device)
    if not coop_rows_takes(cfg.M, cfg.P, True, zeta, psi, f1, f2,
                           *_wind_operand(cfg, zeta)):
        raise ValueError(f"{what}: ({cfg.M}, {cfg.P}) or its operands are "
                         f"not taken (coop_rows_takes)")
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    sym = check_consts(what, packed_symbol_consts(cfg), cfg.M, cfg.P)
    plan = coop_rows_plan(cfg.M, cfg.P, True)
    own, mirror = dft_kernels._device_cluster_tiles(cfg.P, plan.x[1],
                                                    zeta.device)
    zeta_new, carry, psi_new = (torch.empty_like(zeta) for _ in range(3))
    info = (ctypes.c_int * 4)()
    code = lib.qg_fullstep_rows_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), psi_new.data_ptr(), consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step),
        dft_kernels._rows_plan_array(lib, what, plan, stages), sym,
        dft_kernels._twiddles(cfg.P, cfg.P, zeta.device).data_ptr(),
        dft_kernels._twiddles(cfg.M, cfg.M, zeta.device).data_ptr(),
        own.data_ptr(), mirror.data_ptr(), plan.smem, info,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
    fused_step_full.rows_grid = tuple(info)
    return zeta_new, carry, psi_new


def fused_step_yspec_sharded_rows(cfg: ModelConfig, zeta: torch.Tensor,
                                  psi_ys: torch.Tensor, f1: torch.Tensor,
                                  f2: torch.Tensor, step: int,
                                  zeta_top: torch.Tensor,
                                  zeta_bot: torch.Tensor,
                                  psi_top: torch.Tensor,
                                  psi_bot: torch.Tensor,
                                  stages: int | None = None):
    """One launch of the persistent K15 sharded form (csrc
    coop_yspec_sharded_rows_kernel) on a CUDA (2, m, P) row block and its
    (2, H, P) slabs: inverse-y of the block and of each psi slab (whole, as
    an H-row field, into scratch) by K2's factored body, the step by K12's
    row units, forward-y by K2's factored body, grid barriers between them.
    Returns (zeta_new, carry, zeta_ys): fused_step_yspec_sharded's result.
    Raises on a shape or operand the kernel does not take (coop_rows_takes
    over the block's operands and the slabs) and on a launch the card
    refuses; counts nothing, records (blocks, clusters, blocks an SM, the
    step units' rows R) in ``fused_step_yspec_sharded.rows_grid``.
    ``stages`` < 3 stops after that many stages, as fused_step_yspec_rows.

    Replaces ``tpu_qg/ops/pallas_tendency.py:913``
    fused_step_streamed_yspec_sharded. Bound: seven (2, m, P) fields (235 MB
    on (2, 2048, 2048), 0.070 ms; 58.7 MB on (2, 512, 2048)). Why: the first
    form runs the first stage bodies and loses to the redesigned kernels it
    fuses (PERF.md)."""
    what = "fused_step_yspec_sharded_rows (K15 sharded)"
    slabs = (zeta_top, zeta_bot, psi_top, psi_bot)
    wind = _check_sharded(what, cfg, (("zeta", zeta), ("psi_ys", psi_ys),
                                      ("f1", f1), ("f2", f2)),
                          tuple(zip(("zeta_top", "zeta_bot", "psi_top",
                                     "psi_bot"), slabs)))
    _, m, P = zeta.shape
    if not coop_rows_takes(m, P, False, zeta, psi_ys, f1, f2,
                           *_wind_operand(cfg, zeta), *slabs):
        raise ValueError(f"{what}: ({m}, {P}) or its operands are not taken "
                         f"(coop_rows_takes)")
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    plan = coop_rows_plan(m, P, False)
    zeta_new, carry, zeta_ys = (torch.empty_like(zeta) for _ in range(3))
    top_nat, bot_nat = torch.empty_like(psi_top), torch.empty_like(psi_bot)
    info = (ctypes.c_int * 4)()
    code = lib.qg_yspec_sharded_rows_launch(
        zeta.data_ptr(), psi_ys.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), zeta_ys.data_ptr(), consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step),
        dft_kernels._rows_plan_array(lib, what, plan, stages),
        dft_kernels._twiddles(P, P, zeta.device).data_ptr(),
        *(t.data_ptr() for t in slabs), zeta_top.shape[1],
        top_nat.data_ptr(), bot_nat.data_ptr(), plan.smem, info,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, what)
    fused_step_yspec_sharded.rows_grid = tuple(info)
    return zeta_new, carry, zeta_ys


def fused_step_yspec_rows_emulated(cfg: ModelConfig, zeta: torch.Tensor,
                                   psi_ys: torch.Tensor, f1: torch.Tensor,
                                   f2: torch.Tensor, step: int):
    """What the persistent K15 computes, stage by stage, in plain torch
    with each stage's index maps: y_dft_factored_emulated's inverse, the
    row kernel's emulation (fused_step_rows_emulated) in the step stage's
    layout, y_dft_factored_emulated's forward. Returns (zeta_new, carry,
    zeta_ys, bad_reads) (bad_reads: the step emulation's count of ring
    reads that missed their row)."""
    plan = coop_rows_plan(cfg.M, cfg.P, False)
    psi = dft_kernels.y_dft_factored_emulated(psi_ys, True)
    zeta_new, carry, _, bad = fused_step_rows_emulated(
        cfg, zeta, psi, f1, f2, step, plan.step)
    return (zeta_new, carry,
            dft_kernels.y_dft_factored_emulated(zeta_new, False), bad)


def fused_step_full_rows_emulated(cfg: ModelConfig, zeta: torch.Tensor,
                                  psi: torch.Tensor, f1: torch.Tensor,
                                  f2: torch.Tensor, step: int):
    """What the persistent K17 computes, stage by stage, in plain torch
    with each stage's index maps: the row kernel's emulation in the step
    stage's layout, y_dft_factored_emulated's forward, K3's cluster
    emulation (pair_x_cluster_emulated) in the x stage's layout (G, Cw), and
    y_dft_factored_emulated's inverse. Returns (zeta_new, carry, psi_new,
    bad_reads)."""
    plan = coop_rows_plan(cfg.M, cfg.P, True)
    zeta_new, carry, _, bad = fused_step_rows_emulated(
        cfg, zeta, psi, f1, f2, step, plan.step)
    zy = dft_kernels.y_dft_factored_emulated(zeta_new, False)
    x, _, _ = dft_kernels.pair_x_cluster_emulated(
        zy, packed_symbol_consts(cfg), *plan.x)
    return (zeta_new, carry, dft_kernels.y_dft_factored_emulated(x, True),
            bad)


def fused_step_yspec_sharded_rows_emulated(cfg: ModelConfig,
                                           zeta: torch.Tensor,
                                           psi_ys: torch.Tensor,
                                           f1: torch.Tensor, f2: torch.Tensor,
                                           step: int, zeta_top: torch.Tensor,
                                           zeta_bot: torch.Tensor,
                                           psi_top: torch.Tensor,
                                           psi_bot: torch.Tensor):
    """What the persistent K15 sharded form computes, stage by stage, in
    plain torch with each stage's index maps: y_dft_factored_emulated's
    inverse of the block and of each whole psi slab, the row kernel's
    emulation with the slabs (K12's) in the step stage's layout,
    y_dft_factored_emulated's forward. Returns (zeta_new, carry, zeta_ys,
    bad_reads)."""
    plan = coop_rows_plan(zeta.shape[1], zeta.shape[2], False)
    inv = functools.partial(dft_kernels.y_dft_factored_emulated, inverse=True)
    zeta_new, carry, _, bad = fused_step_rows_emulated(
        cfg, zeta, inv(psi_ys), f1, f2, step, plan.step,
        slabs=(zeta_top, zeta_bot, inv(psi_top), inv(psi_bot)))
    return (zeta_new, carry,
            dft_kernels.y_dft_factored_emulated(zeta_new, False), bad)
