"""Stage 1 of the modulated-taps DDC with its decimated-rate rotation: the
hand-written kernel (``csrc/ddc_kernel.cu``) and its plain PyTorch version.

It replaces no TPU kernel: the JAX package leaves stage 1 to XLA's
``dot_general`` (``ops/ddc._modtap_stage1``'s chunked product). For each
band and slot k (decimation M, R lags),

    y1[p] = sum_{q < R} sum_{r < M} full[(p + q) M + r] * g_k[q M + r]
    y[p]  = y1[p] * e^{i (phase_k + angle_k(p))}

with ``full`` the carried raw tail then the chunk (complex samples) and
``g_k`` the reversed modulated taps of ``make_mod_tables``. The kernel reads
the chunk as the step holds it ([NB, n, 2] int8 cs8 or f32 pairs, each
band's pairs contiguous, any band stride) and writes y as [NB*K, 2, n / M]
f32 (row band*K + k) and the new raw tail, in one launch. Its product is
one real matrix product a column group of two slots: a window row is the
2M interleaved (re, im) floats of M samples, B is [2M, 4R] (``mod_b``),
split into TF32 halves on the host and packed in the tensor cores' fragment
order (``mod_fragments``), once a retune.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rtl_sdr_scanner_tpu_torch.ops.cuda.fir_kernel import tf32_round

GROUP_SLOTS = 2  # slots a column group (kGroupSlots)
GROUP_NTILES = 20  # n-tiles of 8 columns a group (kNTG): 4 outputs of up to MAX_LAGS lags
MAX_LAGS = 40  # R (kMaxR); 34 for every decimation
CS8_SCALE = 1.0 / 127.5
CARRIED_ROWS = 40  # Z rows carried in front of a tile's (kZC)
MAX_SMEM = 232448  # shared memory a thread block may use (kMaxSmem)
FORMS = ((4, True), (4, False), (2, False))  # (m-tiles a warp, B in shared memory), tried in turn


def groups(k: int) -> int:
    return -(-k // GROUP_SLOTS)


def k_steps(m: int) -> int:
    """The product's depth 2M in steps of 8."""
    return -(-2 * m // 8)


def tile_rows(mt: int) -> int:
    """Z rows a tile: 2 warps along the rows, mt m-tiles of 16 each."""
    return 2 * mt * 16


def smem_bytes(m: int, r_rows: int, mt: int, esize: int, b_smem: bool) -> int:
    """A thread block's shared memory (``smem_bytes`` of the source): B
    fragments where they sit there; int8: two raw window stages and the f32
    tile of rows padded to 4 mod 8 words, f32: two such tiles; Z with the
    carried rows in front."""
    tr, ks = tile_rows(mt), k_steps(m)
    tile = tr * (8 * ks + 4) * 4
    windows = 2 * -(-(tr * 2 * m + 16) // 16) * 16 + tile if esize == 1 else 2 * tile
    z = (CARRIED_ROWS + tr) * (8 * -(-4 * r_rows // 8) + 1)
    return (ks * GROUP_NTILES * 512 if b_smem else 0) + windows + z * 4


def kernel_form(m: int, r_rows: int, int8: bool):
    """(m-tiles a warp, B in shared memory) of the first form whose shared
    memory fits, as the launcher picks it; None where none does (M too large)."""
    for mt, b_smem in FORMS:
        if smem_bytes(m, r_rows, mt, 1 if int8 else 4, b_smem) <= MAX_SMEM:
            return mt, b_smem
    return None


def mod_b(g: np.ndarray, m: int, r_rows: int) -> np.ndarray:
    """The modulated taps [..., K, 2, R*M] (re, im; ``make_mod_tables``'s
    ``g``) -> B [..., ceil(K / 2), 8 * k_steps(M), 8 * GROUP_NTILES] f32.

    Row 2r + c multiplies component c (re, im) of a row's sample r; group
    column (2s + o) R + q is lag q of slot s's output o (y_re, y_im):
    y_re = x_re G_re - x_im G_im, y_im = x_re G_im + x_im G_re with
    G[r][q] = g[q M + r]. Everything else is zero."""
    g = np.asarray(g, dtype=np.float32)
    lead, k = g.shape[:-3], g.shape[-3]
    gp = g.reshape(*lead, k, 2, r_rows, m)  # [.., K, part, q, r]
    g_re, g_im = gp[..., 0, :, :], gp[..., 1, :, :]
    # [.., K, output (y_re, y_im), component (x_re, x_im), q, r]
    blocks = np.stack([np.stack([g_re, -g_im], axis=-3), np.stack([g_im, g_re], axis=-3)], axis=-4)
    # rows 2r + c, columns q: [.., K, output, 2M, R]
    blocks = np.moveaxis(blocks, -1, -3).reshape(*lead, k, 2, 2 * m, r_rows)
    b = np.zeros((*lead, groups(k), 8 * k_steps(m), 8 * GROUP_NTILES), dtype=np.float32)
    for slot in range(k):
        grp, s = divmod(slot, GROUP_SLOTS)
        for o in range(2):
            col = (2 * s + o) * r_rows
            b[..., grp, : 2 * m, col : col + r_rows] = blocks[..., slot, o, :, :]
    return b


def pack_fragments(b: np.ndarray) -> np.ndarray:
    """B [..., Kp, 8 * GROUP_NTILES] -> [..., Kp / 8, GROUP_NTILES, 32, 4]:
    for k-step kk, n-tile nt and lane l (group g = l // 4, thread t = l % 4),
    the ``mma.m16n8k8`` TF32 B operands B[kk*8 + t][nt*8 + g] and
    B[kk*8 + t + 4][nt*8 + g] of B_hi = tf32(B), then of B_lo = tf32(B - B_hi)."""
    hi = tf32_round(b)
    lo = tf32_round(b - hi)
    ks = b.shape[-2] // 8
    lane = np.arange(32)
    t, g = lane % 4, lane // 4

    def operands(w):
        w4 = w.reshape(*w.shape[:-2], ks, 8, GROUP_NTILES, 8).swapaxes(-3, -2)  # [.., kk, nt, k, n]
        return w4[..., t, g], w4[..., t + 4, g]  # each [.., kk, nt, 32]

    return np.ascontiguousarray(np.stack([*operands(hi), *operands(lo)], axis=-1))


def mod_fragments(g: np.ndarray, m: int, r_rows: int) -> np.ndarray:
    """The kernel's B table for modulated taps [..., K, 2, R*M]:
    [..., ceil(K / 2), k_steps(M), GROUP_NTILES, 32, 4] f32."""
    return pack_fragments(mod_b(g, m, r_rows))


def modtap_stage1_plain(
    iq: torch.Tensor, x_tail: torch.Tensor, phase: torch.Tensor, tables, plan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matmul form: the components widened and stacked, ``ops/ddc._modtap_stage1``
    (the chunked product against ``tables.w``), then ``_rotation``."""
    from rtl_sdr_scanner_tpu_torch.ops.ddc import _components, _modtap_stage1, _rotation

    nb, chunk = iq.shape[0], iq.shape[1]
    k = phase.shape[-1]
    out1 = chunk // plan.decim
    x = torch.stack(_components(iq), dim=1)  # [NB, 2, chunk]
    y_re, y_im, new_tail = _modtap_stage1(x, x_tail, tables.w, plan, k)
    rot_re, rot_im = _rotation(phase, tables.rot, out1)  # [NB, K, out1]
    y = torch.stack([y_re * rot_re - y_im * rot_im, y_re * rot_im + y_im * rot_re], dim=2)
    return y.reshape(nb * k, 2, out1), new_tail


def _pairs(iq: torch.Tensor) -> torch.Tensor:
    """[NB, n] complex -> its [NB, n, 2] f32 view; pairs as they are."""
    return torch.view_as_real(iq) if iq.is_complex() else iq


def check_args(iq: torch.Tensor, x_tail: torch.Tensor, phase: torch.Tensor, tables, plan) -> None:
    """Raise ValueError on what the kernel does not take."""
    if plan.interp != 1 or plan.chunk_c <= 0 or not 1 <= plan.poly_rows <= MAX_LAGS:
        raise ValueError(f"modtap_stage1: want a chunked decimating stage 1 of at most {MAX_LAGS} lags, got "
                         f"({plan.interp}, {plan.decim}), R {plan.poly_rows}")
    xs = _pairs(iq)
    m = plan.decim
    if xs.ndim != 3 or xs.shape[2] != 2 or xs.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"modtap_stage1: want [NB, n, 2] int8 or f32 pairs, got {iq.dtype} {tuple(iq.shape)}")
    if kernel_form(m, plan.poly_rows, xs.dtype == torch.int8) is None:
        raise ValueError(f"modtap_stage1: a window of decimation {m} ({xs.dtype}) does not fit a thread block")
    nb, n = xs.shape[0], xs.shape[1]
    if n == 0 or n % m or xs.stride(2) != 1 or xs.stride(1) != 2:
        raise ValueError(f"modtap_stage1: want a positive multiple of {m} samples, each band's pairs contiguous; "
                         f"got {n} samples at strides {xs.stride()}")
    if phase.ndim != 2 or phase.shape[0] != nb:
        raise ValueError(f"modtap_stage1: want phase [{nb}, K], got {tuple(phase.shape)}")
    k = phase.shape[1]
    out1 = n // m
    q = tables.rot.fine_re.shape[-1]
    nq = tables.rot.coarse_re.shape[-1]
    if q & (q - 1) or q * nq != out1:
        raise ValueError(f"modtap_stage1: rotation tables of {nq} x {q} do not cover {out1} outputs by a power of two")
    want = (
        ("x_tail", x_tail, (nb, 2, plan.tail_len)),
        ("phase", phase, (nb, k)),
        ("frag", tables.frag, (nb, groups(k), k_steps(m), GROUP_NTILES, 32, 4)),
        ("coarse_re", tables.rot.coarse_re, (nb, k, nq)),
        ("coarse_im", tables.rot.coarse_im, (nb, k, nq)),
        ("fine_re", tables.rot.fine_re, (nb, k, q)),
        ("fine_im", tables.rot.fine_im, (nb, k, q)),
    )
    for name, t, shape in want:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"modtap_stage1: want {name} contiguous f32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != iq.device:
            raise ValueError(f"modtap_stage1: {name} on {t.device}, the chunk on {iq.device}")


def launch_args(
    iq: torch.Tensor, x_tail: torch.Tensor, phase: torch.Tensor, tables, plan, y: torch.Tensor,
    new_tail: torch.Tensor,
) -> tuple:
    """The C entry point's arguments but the stream (``csrc/ddc_kernel.cu``
    ``modtap_stage1``)."""
    xs = _pairs(iq)
    nb, n = xs.shape[0], xs.shape[1]
    rot = tables.rot
    return (
        xs.data_ptr(), int(xs.dtype == torch.int8), xs.stride(0), n, x_tail.data_ptr(), tables.frag.data_ptr(),
        phase.data_ptr(), rot.coarse_re.data_ptr(), rot.coarse_im.data_ptr(), rot.fine_re.data_ptr(),
        rot.fine_im.data_ptr(), y.data_ptr(), new_tail.data_ptr(), nb, phase.shape[1], plan.tail_len, plan.decim,
        plan.poly_rows, n // plan.decim, rot.fine_re.shape[-1], rot.coarse_re.shape[-1],
    )


def modtap_stage1(
    iq: torch.Tensor, x_tail: torch.Tensor, phase: torch.Tensor, tables, plan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """iq [NB, n, 2] int8 cs8 / f32 pairs or [NB, n] complex, x_tail [NB, 2,
    tail_len] f32, phase [NB, K] f32, ``ModTables`` on the same device ->
    (y [NB*K, 2, n / M] f32, new tail [NB, 2, tail_len] f32).

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``modtap_stage1.launches``); on a CPU tensor it runs the plain version.
    """
    if iq.device.type == "cpu":
        return modtap_stage1_plain(iq, x_tail, phase, tables, plan)
    if iq.device.type != "cuda":
        raise ValueError(f"modtap_stage1: unsupported device {iq.device}")
    check_args(iq, x_tail, phase, tables, plan)
    nb, n, k = iq.shape[0], iq.shape[1], phase.shape[1]
    y = torch.empty((nb * k, 2, n // plan.decim), dtype=torch.float32, device=iq.device)
    new_tail = torch.empty_like(x_tail)
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    stream = torch.cuda.current_stream(iq.device).cuda_stream
    rc = library().modtap_stage1(*launch_args(iq, x_tail, phase, tables, plan, y, new_tail), stream)
    check(rc, "modtap_stage1")
    modtap_stage1.launches += 1
    return y, new_tail


modtap_stage1.launches = 0
