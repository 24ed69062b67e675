"""K18, the stencil lab's step: K1's step with its tendency body swapped per
variant, for ablations timed by ``tpu_qg_torch.scripts.stencil_lab``.

Replaces ``tpu_qg/ops/_stencil_lab.py`` ``lab_step`` (``:325``, the kernel
``_lab_kernel``, ``:253``, with a body from ``BODIES``, ``:243-250``). No
model route runs it. The variants keep ``tpu_qg``'s names and values:

  base     K1's body (``_layer_tendency_shared``).
  legacy   the round-3 body of row slices; the same expressions as base.
  aligned  base restructured around 8-aligned TPU slices; the same
           expressions as base.
  norot    aligned with every neighbour replaced by the centre: the
           tendency is zero apart from the wind (wrong results on purpose).
  noslice  the x (row) neighbours replaced by the centre (wrong results on
           purpose); one layer drops the U term.
  nojac    the Arakawa Jacobian dropped; one layer drops the U term.

``legacy`` and ``aligned`` differ from ``base`` only in how Mosaic lays data
out in a TPU's vector registers, which Hopper does not do: they share base's
plain function and base's kernel instance. On Hopper, ``norot`` and
``noslice`` time the tile body without its shared-memory neighbour reads
(all, or the x ones), and ``nojac`` the body without the Jacobian's
arithmetic.

Design and bound: K1's (``csrc/step_kernel.cu``): six (L, M, P) fields cross
device memory once, 201 MB at (2, 2048, 2048), 0.060 ms at 3.35 TB/s. Two
kernels in ``csrc/lab_kernel.cu``, chosen by shape as K1 chooses:
``lab_rows_kernel<L, kBody, W, NT, D>`` (``lab_step_rows``), K1's
row-streaming step (``step_rows``) with a compile-time body selector, in
K1's launched layout for M (``step_rows_launched``), so the lab ablates the
kernel that ships (base's two-layer instance is K1's code and gives K1's
bits), where ``step_rows_takes``, counted also in
``lab_step.rows_launches``; and ``lab_step_kernel<L, kBody>``
(``lab_step_tile``), the tile design's ``step_tile`` with the same
selector, on P % 4 != 0 and misaligned views. Each body reads its
neighbours as the tile does, in lap(psi) too, so both give the same bits.

``lab_step`` launches them for CUDA tensors and uses ``lab_step_plain``
only for CPU tensors. ``tpu_qg``'s ``interpret`` and ``tile`` are TPU knobs
(the Pallas interpreter, and the row tile that must fit VMEM) and are
dropped: the kernels' layouts are K1's, and there is no interpreter on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import ModelConfig
from . import _build
from .stencils import roll_shift
from .step_kernel import (_check_operands, _checked_consts, _wind_row,
                          step_rows_launched, step_rows_takes, update_plain)


def _centre(u: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Every neighbour read as the centre (norot)."""
    return u


def _y_only(u: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """x neighbours read as the centre, y neighbours periodic (noslice)."""
    return roll_shift(u, 0, dj)


def _body(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor, *,
          shift=roll_shift, jacobian: bool = True,
          u_one_layer: bool = True) -> torch.Tensor:
    """Every layer's tendency in ``tpu_qg``'s lab-body expressions
    (``_body_aligned``, ``tpu_qg/ops/_stencil_lab.py:176-233``): neighbours
    through ``shift`` (shift(u, di, dj)[i, j] = u[i+di, j+dj]); without
    ``jacobian`` the Arakawa term is dropped; without ``u_one_layer`` a
    single layer drops its U d(zeta)/dx term (nojac, noslice)."""
    dx = cfg.dx
    inv_dx2 = 1.0 / (dx * dx)
    p, z = psi, zeta
    p_up, p_dn = shift(p, 1, 0), shift(p, -1, 0)
    pp, pm = shift(p, 0, 1), shift(p, 0, -1)
    lap1 = (p_up + p_dn - 4.0 * p + pp + pm) * inv_dx2
    l_up, l_dn = shift(lap1, 1, 0), shift(lap1, -1, 0)
    lp, lm = shift(lap1, 0, 1), shift(lap1, 0, -1)
    tend = cfg.visc * ((l_up + l_dn - 4.0 * lap1 + lp + lm) * inv_dx2)

    z_up, z_dn = shift(z, 1, 0), shift(z, -1, 0)
    if jacobian:
        zp, zm = shift(z, 0, 1), shift(z, 0, -1)
        zp_up, zp_dn = shift(zp, 1, 0), shift(zp, -1, 0)
        zm_up, zm_dn = shift(zm, 1, 0), shift(zm, -1, 0)
        pp_up, pp_dn = shift(pp, 1, 0), shift(pp, -1, 0)
        pm_up, pm_dn = shift(pm, 1, 0), shift(pm, -1, 0)
        j_pp = (z_up - z_dn) * (pp - pm) - (zp - zm) * (p_up - p_dn)
        j_pt = (z_up * (pp_up - pm_up) - z_dn * (pp_dn - pm_dn)
                - zp * (pp_up - pp_dn) + zm * (pm_up - pm_dn))
        j_tp = (zp_up * (pp - p_up) - zm_dn * (p_dn - pm)
                - zp_dn * (pp - p_dn) + zm_up * (p_up - pm))
        tend = tend - (j_pp + j_pt + j_tp) / (12.0 * dx * dx)

    dpsi_dx = (0.5 / dx) * (p_up - p_dn)
    betas = (cfg.beta,) if cfg.n_layers == 1 else (cfg.beta_1, cfg.beta_2)
    layers = []
    for layer, beta in enumerate(betas):
        t = tend[layer] - beta * dpsi_dx[layer]
        u_term = cfg.U * ((0.5 / dx) * (z_up[layer] - z_dn[layer]))
        if cfg.n_layers == 1:
            if u_one_layer:
                t = t - u_term
            t = t - cfg.r * lap1[layer]
        elif layer == 0:
            t = t - u_term
        else:
            t = t - cfg.r * lap1[layer]
        if cfg.wind_tau0 != 0.0 and layer == 0:
            from ..models.core import _wind_forcing
            t = t + _wind_forcing(cfg, t.dtype, t.device)
        layers.append(t)
    return torch.stack(layers)


# Plain tendency per variant name tpu_qg accepts; legacy and aligned share
# base's expressions (module docstring).
BODIES = {
    "base": _body,
    "legacy": _body,
    "aligned": _body,
    "norot": functools.partial(_body, shift=_centre),
    "noslice": functools.partial(_body, shift=_y_only, u_one_layer=False),
    "nojac": functools.partial(_body, jacobian=False, u_one_layer=False),
}

# The kernel's body selector (kBody in csrc/step_device.cuh) per variant.
KERNEL_BODY = {"base": 0, "legacy": 0, "aligned": 0, "norot": 1,
               "noslice": 2, "nojac": 3}


def lab_step_plain(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                   f1: torch.Tensor, f2: torch.Tensor, step: int,
                   variant: str = "base"):
    """Plain-torch K18: the variant's tendency, then the time update.
    Returns (zeta_new, carry), as ``tpu_qg``'s ``_apply_update``."""
    tend = BODIES[variant](cfg, zeta, psi)
    return update_plain(cfg, step, tend, zeta, f1, f2)


def _lib():
    lib = _build.load()
    if lib.qg_lab_step_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _build.declare(lib.qg_lab_step_launch,
                       [p] * 7 + [i, i, i, p, i, i, i, p])
        _build.declare(lib.qg_lab_rows_launch,
                       [p] * 7 + [i, i, i, p, i, i, i, i, i, i, i, p])
        _build.declare(lib.qg_lab_rows_attributes, [i] * 5 + [p] * 4)
    return lib


def _operands(what: str, cfg: ModelConfig, zeta, psi, f1, f2) -> None:
    if zeta.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {zeta.device}")
    _check_operands(what, zeta, (("zeta", zeta), ("psi", psi), ("f1", f1),
                                 ("f2", f2)), (cfg.n_layers, cfg.M, cfg.P))


def lab_step_rows(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                  f1: torch.Tensor, f2: torch.Tensor, step: int,
                  variant: str = "base"):
    """One launch of K18's row-streaming kernel on CUDA tensors (one or two
    layers), in K1's launched layout step_rows_launched(M). Returns
    (zeta_new, carry); raises on a shape it does not take and on a launch
    error; counts nothing (lab_step counts)."""
    what = "lab_step_rows (K18)"
    body = KERNEL_BODY[variant]
    _operands(what, cfg, zeta, psi, f1, f2)
    wind = _wind_row(cfg, zeta.device)
    if not step_rows_takes(cfg.P, zeta, psi, f1, f2,
                           *(() if wind is None else (wind,))):
        raise ValueError(f"{what}: P = {cfg.P} must be a multiple of 4 and "
                         f"every operand 16-byte aligned")
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    W, R, D, NT = step_rows_launched(cfg.M)
    zeta_new = torch.empty_like(zeta)
    carry = torch.empty_like(zeta)
    code = lib.qg_lab_rows_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), cfg.n_layers, cfg.M, cfg.P, consts, body,
        int(cfg.time_scheme == "leapfrog_ra"), int(step), W, R, D, NT,
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, f"{what} {variant} {(W, R, D, NT)}")
    return zeta_new, carry


def lab_step_tile(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
                  f1: torch.Tensor, f2: torch.Tensor, step: int,
                  variant: str = "base"):
    """One launch of K18's tile kernel (one block a 32 x 64 tile) on CUDA
    tensors: lab_step's kernel on the shapes the row kernel does not take.
    Returns (zeta_new, carry); counts nothing."""
    what = "lab_step_tile (K18)"
    body = KERNEL_BODY[variant]
    _operands(what, cfg, zeta, psi, f1, f2)
    lib = _lib()
    consts = _checked_consts(cfg, lib, what)
    wind = _wind_row(cfg, zeta.device)
    zeta_new = torch.empty_like(zeta)
    carry = torch.empty_like(zeta)
    code = lib.qg_lab_step_launch(
        zeta.data_ptr(), psi.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        None if wind is None else wind.data_ptr(), zeta_new.data_ptr(),
        carry.data_ptr(), cfg.n_layers, cfg.M, cfg.P, consts, body,
        int(cfg.time_scheme == "leapfrog_ra"), int(step),
        torch.cuda.current_stream(zeta.device).cuda_stream)
    _build.check(code, what)
    return zeta_new, carry


def lab_step(cfg: ModelConfig, zeta: torch.Tensor, psi: torch.Tensor,
             f1: torch.Tensor, f2: torch.Tensor, step: int,
             variant: str = "base"):
    """K18 on CUDA tensors (one or two layers), the plain version on CPU
    tensors. Returns (zeta_new, carry); an unknown variant raises
    ``KeyError``. The row kernel (lab_step_rows) where step_rows_takes,
    counted also in ``lab_step.rows_launches``; the tile kernel
    (lab_step_tile) on the rest."""
    if zeta.device.type == "cpu":
        return lab_step_plain(cfg, zeta, psi, f1, f2, step, variant)
    _operands("lab_step (K18)", cfg, zeta, psi, f1, f2)
    wind = _wind_row(cfg, zeta.device)
    if step_rows_takes(cfg.P, zeta, psi, f1, f2,
                       *(() if wind is None else (wind,))):
        out = lab_step_rows(cfg, zeta, psi, f1, f2, step, variant)
        lab_step.rows_launches += 1
    else:
        out = lab_step_tile(cfg, zeta, psi, f1, f2, step, variant)
    lab_step.launches += 1
    return out


lab_step.launches = 0
lab_step.rows_launches = 0


@functools.lru_cache(maxsize=64)
def lab_rows_attributes(layers: int, variant: str, layout: tuple,
                        device: int) -> dict:
    """K18's row kernel for ``layers`` layers and ``variant`` in ``layout``
    (W, R, D, NT) on card ``device``: registers a thread, local memory
    (spill) bytes a thread, shared memory a block and the most blocks an SM
    holds."""
    W, _, D, NT = layout
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        code = _lib().qg_lab_rows_attributes(
            layers, KERNEL_BODY[variant], W, D, NT,
            *(ctypes.byref(v) for v in vals))
    _build.check(code, f"lab rows attributes {variant} {layout}")
    return dict(zip(("regs", "local_bytes", "smem", "blocks_per_sm"),
                    (v.value for v in vals)))
