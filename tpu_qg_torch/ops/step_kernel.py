"""K1, the fused two-layer step (tendency + Euler/AB3 or leapfrog-RA update),
K8, the same step for one or two layers with the modal projection, K9, the
tendency alone, K15, the step of the y-fused chain, K17, the whole step
in one launch, and the sharded forms of K1 (K12) and K15 on one rank's row
block.

K1 replaces ``tpu_qg/ops/pallas_tendency.py`` ``fused_step_streamed`` (v4)
and its single-tile form ``fused_step_pre_fft`` (v3); K8 replaces its
``fused_pre_inversion`` (v2), the step of the single-layer and pin-gauge
configurations. Both are one hand-written CUDA kernel each on a shared tile
body, ``csrc/step_kernel.cu`` (design and bound in its header: they are
bandwidth-bound, 6 x 33.5 MB per step at 2048^2, and keep every stencil
neighbour in shared memory). K15 replaces ``fused_step_streamed_yspec``
(v5): K1 with psi in, and zeta_new also out, as permuted y-spectra — one
cooperative launch of ``csrc/fused_kernels.cu`` (inverse-y, the step, and
forward-y as stages; design there). K17 replaces
``tpu_qg/ops/pallas_fullstep.py`` ``fused_step_full``: the step, then the
whole packed inversion of zeta_new (K16's stages), in one cooperative launch
of the same source.

K12 (``fused_step_sharded``) replaces ``fused_step_streamed_sharded``
and K15's sharded form (``fused_step_yspec_sharded``)
``fused_step_streamed_yspec_sharded``: the same kernels on a (2, m, P) row
block with the rows above and below it from (2, H, P) slabs the caller
exchanged with its x-neighbours (top = the previous rank's last H rows,
bottom = the next rank's first H rows). The TPU kernels take H = 8, their
sublane alignment; the stencil reads 2 rows of psi and 1 of zeta, and
these take any H >= 2.

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

import torch

from ..config import ModelConfig
from . import _build
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
        _build.declare(lib.qg_step_sharded_launch,
                       [p] * 7 + [i, i, p, i, i] + [p] * 4 + [i, p])
        _build.declare(lib.qg_yspec_sharded_launch,
                       [p] * 9 + [i, i, p, p, p] + [p] * 4
                       + [i, p, p, i, p, p])
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


def fused_step(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
               f1: torch.Tensor, f2: torch.Tensor, step: int):
    """Both layers' tendency + time update in one kernel pass on CUDA
    tensors; the plain version on CPU tensors. Returns (zeta_new, carry)."""
    if zeta.device.type == "cpu":
        return fused_step_plain(cfg, zeta, psi, f1, f2, step)
    _check_two_layer_step("fused_step", cfg, zeta, psi, f1, f2)
    lib = _lib()
    consts = _checked_consts(cfg, lib, "fused_step")
    wind = _wind_row(cfg, zeta.device)
    zeta_new = torch.empty_like(zeta)
    carry = torch.empty_like(zeta)
    stream = torch.cuda.current_stream(zeta.device).cuda_stream
    code = lib.qg_step_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(),
        zeta_new.data_ptr(), carry.data_ptr(), cfg.M, cfg.P, consts,
        int(cfg.time_scheme == "leapfrog_ra"), int(step), stream)
    _build.check(code, "fused_step (K1)")
    fused_step.launches += 1
    return zeta_new, carry


fused_step.launches = 0


def fused_tendency_plain(cfg: ModelConfig, zeta: torch.Tensor,
                         psi: torch.Tensor) -> torch.Tensor:
    """Plain-torch K9: ``models.core._tendencies``."""
    from ..models.core import _tendencies
    return _tendencies(cfg, zeta, psi)


def fused_tendency(cfg: ModelConfig, zeta: torch.Tensor,
                   psi: torch.Tensor) -> torch.Tensor:
    """K9: every layer's tendency (with the wind forcing) in one kernel pass
    on CUDA tensors, the plain version on CPU tensors; a drop-in for
    ``_tendencies``. Replaces ``tpu_qg/ops/pallas_tendency.py:181``
    ``fused_tendency``; no step route runs it (the reference's tests and
    ``scripts/bench_variants.py`` call it). Bound: device-memory bandwidth;
    it reads zeta and psi and writes the tendency, three (L, M, P) fields,
    101 MB at 2048^2 and 1611 MB at 8192^2 for two layers. Design: K1's
    32 x 64 tile (``tendency_kernel<L>`` in ``csrc/step_kernel.cu``) with
    psi (halo 2) and zeta (halo 1) in shared memory, the periodic wrap in
    the load index, and the update cut off, so each field crosses device
    memory once."""
    if zeta.device.type == "cpu":
        return fused_tendency_plain(cfg, zeta, psi)
    if zeta.device.type != "cuda":
        raise ValueError(f"fused_tendency: unsupported device {zeta.device}")
    _check_operands("fused_tendency", zeta, (("zeta", zeta), ("psi", psi)),
                    (cfg.n_layers, cfg.M, cfg.P))
    lib = _lib()
    consts = _checked_consts(cfg, lib, "fused_tendency")
    wind = _wind_row(cfg, zeta.device)
    tend = torch.empty_like(zeta)
    code = lib.qg_tendency_launch(
        zeta.data_ptr(), psi.data_ptr(),
        None if wind is None else wind.data_ptr(), tend.data_ptr(),
        cfg.n_layers, cfg.M, cfg.P, consts,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, "fused_tendency (K9)")
    fused_tendency.launches += 1
    return tend


fused_tendency.launches = 0


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


def fused_step_yspec(cfg: ModelConfig, zeta: torch.Tensor,
                     psi_ys: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                     step: int):
    """K15 on CUDA tensors (one cooperative launch), the plain version on
    CPU tensors. ``psi_ys`` is the permuted y-spectrum of the packed
    psi_1 + i psi_2 (what K3 or K5 writes). Returns (zeta_new, carry,
    zeta_ys), zeta_ys the permuted y-spectrum of the packed zeta_new (what
    K2 forward writes)."""
    if zeta.device.type == "cpu":
        return fused_step_yspec_plain(cfg, zeta, psi_ys, f1, f2, step)
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
    fused_step_yspec.launches += 1
    fused_step_yspec.grid = tuple(info)
    return zeta_new, carry, zeta_ys


fused_step_yspec.launches = 0
fused_step_yspec.grid = None


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


def fused_step_sharded(cfg: ModelConfig, zeta: torch.Tensor,
                       psi: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                       step: int, zeta_top: torch.Tensor,
                       zeta_bot: torch.Tensor, psi_top: torch.Tensor,
                       psi_bot: torch.Tensor):
    """K12: K1 on one rank's (2, m, P) row block with its (2, H, P) slabs,
    one kernel pass on CUDA tensors; the plain version on CPU tensors.
    Replaces ``tpu_qg/ops/pallas_tendency.py:608``. Returns (zeta_new,
    carry)."""
    if zeta.device.type == "cpu":
        return fused_step_sharded_plain(cfg, zeta, psi, f1, f2, step,
                                        zeta_top, zeta_bot, psi_top, psi_bot)
    what = "fused_step_sharded (K12)"
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
    fused_step_sharded.launches += 1
    return zeta_new, carry


fused_step_sharded.launches = 0


def fused_step_yspec_sharded(cfg: ModelConfig, zeta: torch.Tensor,
                             psi_ys: torch.Tensor, f1: torch.Tensor,
                             f2: torch.Tensor, step: int,
                             zeta_top: torch.Tensor, zeta_bot: torch.Tensor,
                             psi_top: torch.Tensor, psi_bot: torch.Tensor):
    """K15's sharded form on CUDA tensors (one cooperative launch), the
    plain version on CPU tensors: K15 on one rank's (2, m, P) row block,
    zeta's slabs natural and psi's rows of its permuted y-spectrum.
    Replaces ``tpu_qg/ops/pallas_tendency.py:913``. Returns (zeta_new,
    carry, zeta_ys)."""
    if zeta.device.type == "cpu":
        return fused_step_yspec_sharded_plain(cfg, zeta, psi_ys, f1, f2,
                                              step, zeta_top, zeta_bot,
                                              psi_top, psi_bot)
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
    fused_step_yspec_sharded.launches += 1
    fused_step_yspec_sharded.grid = tuple(info)
    return zeta_new, carry, zeta_ys


fused_step_yspec_sharded.launches = 0
fused_step_yspec_sharded.grid = None


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


def fused_step_full(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                    f1: torch.Tensor, f2: torch.Tensor, step: int):
    """K17 on CUDA tensors (one cooperative launch: K1's tendency and update
    on every tile, then K16's three stages on the packed zeta_new), the plain
    version on CPU tensors. Replaces ``tpu_qg/ops/pallas_fullstep.py``
    ``fused_step_full``. Returns (zeta_new, carry, psi_new)."""
    if zeta.device.type == "cpu":
        return fused_step_full_plain(cfg, zeta, psi, f1, f2, step)
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
    fused_step_full.launches += 1
    fused_step_full.grid = tuple(info)
    return zeta_new, carry, psi_new


fused_step_full.launches = 0
fused_step_full.grid = None
