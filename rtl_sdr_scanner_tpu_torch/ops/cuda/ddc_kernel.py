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
f32 (row band*K + k) and the new raw tail, in one launch, in one of two
forms, chosen from (M, R, K) alone (``folds``):

- the lag form: one real matrix product a column group of two slots, a
  window row the 2M interleaved (re, im) floats of M samples against B
  [2M, 4R] (``mod_b``), then each output's R lags summed;
- the folded form, for small M and several slots (with R 34: K 3-4 at M
  <= 8, 7-8 at M <= 16, 11-12 at M <= 12, 15-16 at M <= 8; ds491m52's M
  8, K 16 and a 32 kHz band's 4 slots at 16 kHz, M 2): the lags in the
  product's depth, the Hankel view of the window against B_fold
  [R 8 ceil(2M / 8), 8 ceil(2K / 8)] (``mod_b_fold``), every slot from one
  product and no lag sums; launched through ``modtap_stage1_fold``, whose
  ``.launches`` count it.

``make_mod_tables`` keeps the form's B split into TF32 halves and packed in
the tensor cores' fragment order (``mod_fragments``), once a retune.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
FOLD_FORMS = (4, 2)  # the folded form's m-tiles a warp (8 warps along a tile's rows), tried in turn
FOLD_MAX_NTILES = 4  # the folded form's columns: 2K <= 32 (kFoldMaxNT)
FOLD_KS_PER_NTILE = 2  # the folded form's k-steps a window row, at most, an n-tile of its columns
WARPS = 8  # warps a thread block (kWarps)


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


def fold_ntiles(k: int) -> int:
    """n-tiles of 8 columns of the folded product: (slot, y_re / y_im), 2K padded."""
    return -(-2 * k // 8)


def fold_tile_rows(mt: int) -> int:
    """Outputs a tile of the folded form: 8 warps along the rows, mt m-tiles each."""
    return WARPS * mt * 16


def fold_smem_bytes(m: int, r_rows: int, k: int, mt: int, esize: int) -> int:
    """A thread block's shared memory in the folded form (``fold_smem_bytes``
    of the source): B_fold's split fragments; int8: two raw window stages and
    the f32 tile, f32: two f32 tiles, each of the TR + R - 1 window rows a
    tile reads."""
    ks, wr = k_steps(m), fold_tile_rows(mt) + r_rows - 1
    tile = wr * (8 * ks + 4) * 4
    windows = 2 * -(-(wr * 2 * m + 16) // 16) * 16 + tile if esize == 1 else 2 * tile
    return r_rows * ks * fold_ntiles(k) * 512 + windows


def folds(m: int, r_rows: int, k: int) -> bool:
    """Whether stage 1 at decimation M, R lags and K slots runs the folded
    form: its columns (2K padded to 8) fit the accumulators, its product
    takes no more multiply-adds than the lag form's (an output's R lags of
    ceil(2K / 8) n-tiles against ceil(K / 2) column groups of ceil(4R / 8)
    n-tiles, over the same padded window row), a window row's k-steps are at
    most FOLD_KS_PER_NTILE times its n-tiles (an A fragment feeds one
    multiply an n-tile, so the fold's A loads grow with M at one n-tile,
    where the lag form's lag sums do not: on an H100 the fold lost from M 20
    at K 4, PERF.md §6), and B_fold fits beside the f32 window, the larger,
    so that one table serves int8 and f32 streams."""
    nt = fold_ntiles(k)
    return (nt <= FOLD_MAX_NTILES and r_rows * nt <= groups(k) * -(-4 * r_rows // 8)
            and k_steps(m) <= FOLD_KS_PER_NTILE * nt
            and fold_smem_bytes(m, r_rows, k, FOLD_FORMS[-1], 4) <= MAX_SMEM)


def fold_form(m: int, r_rows: int, k: int, int8: bool) -> Optional[int]:
    """The folded form's m-tiles a warp, as the launcher picks them (the
    first whose shared memory fits the stream's element); None where the
    lag form runs."""
    if not folds(m, r_rows, k):
        return None
    esize = 1 if int8 else 4
    return next(mt for mt in FOLD_FORMS if fold_smem_bytes(m, r_rows, k, mt, esize) <= MAX_SMEM)


def _blocks(g: np.ndarray, m: int, r_rows: int) -> np.ndarray:
    """The modulated taps [..., K, 2, R*M] -> the complex product's real
    blocks [..., K, output (y_re, y_im), 2M (2r + c), R (lag q)]: y_re = x_re
    G_re - x_im G_im, y_im = x_re G_im + x_im G_re with G[r][q] = g[q M + r]."""
    g = np.asarray(g, dtype=np.float32)
    lead, k = g.shape[:-3], g.shape[-3]
    gp = g.reshape(*lead, k, 2, r_rows, m)  # [.., K, part, q, r]
    g_re, g_im = gp[..., 0, :, :], gp[..., 1, :, :]
    # [.., K, output (y_re, y_im), component (x_re, x_im), q, r]
    blocks = np.stack([np.stack([g_re, -g_im], axis=-3), np.stack([g_im, g_re], axis=-3)], axis=-4)
    return np.moveaxis(blocks, -1, -3).reshape(*lead, k, 2, 2 * m, r_rows)


def mod_b_fold(g: np.ndarray, m: int, r_rows: int) -> np.ndarray:
    """The modulated taps [..., K, 2, R*M] -> B_fold [..., R * 8 * k_steps(M),
    8 * fold_ntiles(K)] f32, the folded form's B.

    Row q * 8 k_steps(M) + 2r + c multiplies component c of window row p + q's
    sample r; column 2 slot + o is slot's output o (y_re, y_im), so that one
    lane's accumulator pair holds both parts of an output. Everything else
    is zero."""
    blocks = _blocks(g, m, r_rows)  # [.., K, o, 2M, R]
    lead, k = blocks.shape[:-4], blocks.shape[-4]
    kp = 8 * k_steps(m)
    b = np.zeros((*lead, r_rows, kp, 8 * fold_ntiles(k)), dtype=np.float32)
    # [.., K, o, 2M, R] -> [.., R, 2M, K, o]
    b[..., : 2 * m, : 2 * k] = np.moveaxis(blocks, (-4, -3, -2, -1), (-2, -1, -3, -4)).reshape(
        *lead, r_rows, 2 * m, 2 * k)
    return b.reshape(*lead, r_rows * kp, 8 * fold_ntiles(k))


def mod_b(g: np.ndarray, m: int, r_rows: int) -> np.ndarray:
    """The modulated taps [..., K, 2, R*M] (re, im; ``make_mod_tables``'s
    ``g``) -> B [..., ceil(K / 2), 8 * k_steps(M), 8 * GROUP_NTILES] f32.

    Row 2r + c multiplies component c (re, im) of a row's sample r; group
    column (2s + o) R + q is lag q of slot s's output o (y_re, y_im):
    y_re = x_re G_re - x_im G_im, y_im = x_re G_im + x_im G_re with
    G[r][q] = g[q M + r]. Everything else is zero."""
    blocks = _blocks(g, m, r_rows)  # [.., K, output, 2M, R]
    lead, k = blocks.shape[:-4], blocks.shape[-4]
    b = np.zeros((*lead, groups(k), 8 * k_steps(m), 8 * GROUP_NTILES), dtype=np.float32)
    for slot in range(k):
        grp, s = divmod(slot, GROUP_SLOTS)
        for o in range(2):
            col = (2 * s + o) * r_rows
            b[..., grp, : 2 * m, col : col + r_rows] = blocks[..., slot, o, :, :]
    return b


def pack_fragments(b: np.ndarray) -> np.ndarray:
    """B [..., Kp, 8 * NT] -> [..., Kp / 8, NT, 32, 4]: for k-step kk, n-tile
    nt and lane l (group g = l // 4, thread t = l % 4), the ``mma.m16n8k8``
    TF32 B operands B[kk*8 + t][nt*8 + g] and B[kk*8 + t + 4][nt*8 + g] of
    B_hi = tf32(B), then of B_lo = tf32(B - B_hi). The lag form's NT is
    GROUP_NTILES, the folded form's ``fold_ntiles(K)``."""
    hi = tf32_round(b)
    lo = tf32_round(b - hi)
    ks, nt = b.shape[-2] // 8, b.shape[-1] // 8
    lane = np.arange(32)
    t, g = lane % 4, lane // 4

    def operands(w):
        w4 = w.reshape(*w.shape[:-2], ks, 8, nt, 8).swapaxes(-3, -2)  # [.., kk, nt, k, n]
        return w4[..., t, g], w4[..., t + 4, g]  # each [.., kk, nt, 32]

    return np.ascontiguousarray(np.stack([*operands(hi), *operands(lo)], axis=-1))


def frag_shape(m: int, r_rows: int, k: int) -> tuple:
    """The B table's shape a band: the folded form's [R * k_steps(M),
    fold_ntiles(K), 32, 4] where it runs (``folds``), else the lag form's
    [ceil(K / 2), k_steps(M), GROUP_NTILES, 32, 4]."""
    if folds(m, r_rows, k):
        return (r_rows * k_steps(m), fold_ntiles(k), 32, 4)
    return (groups(k), k_steps(m), GROUP_NTILES, 32, 4)


def mod_fragments(g: np.ndarray, m: int, r_rows: int) -> np.ndarray:
    """The kernel's B table for modulated taps [..., K, 2, R*M], in the form
    the shape runs (``frag_shape``): B_fold's split fragments, or B's a
    column group."""
    if folds(m, r_rows, np.shape(g)[-3]):
        return pack_fragments(mod_b_fold(g, m, r_rows))
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
    nb, n = xs.shape[0], xs.shape[1]
    if n == 0 or n % m or xs.stride(2) != 1 or xs.stride(1) != 2:
        raise ValueError(f"modtap_stage1: want a positive multiple of {m} samples, each band's pairs contiguous; "
                         f"got {n} samples at strides {xs.stride()}")
    if phase.ndim != 2 or phase.shape[0] != nb:
        raise ValueError(f"modtap_stage1: want phase [{nb}, K], got {tuple(phase.shape)}")
    k = phase.shape[1]
    if not folds(m, plan.poly_rows, k) and kernel_form(m, plan.poly_rows, xs.dtype == torch.int8) is None:
        raise ValueError(f"modtap_stage1: a window of decimation {m} ({xs.dtype}) does not fit a thread block")
    out1 = n // m
    q = tables.rot.fine_re.shape[-1]
    nq = tables.rot.coarse_re.shape[-1]
    if q & (q - 1) or q * nq != out1:
        raise ValueError(f"modtap_stage1: rotation tables of {nq} x {q} do not cover {out1} outputs by a power of two")
    want = (
        ("x_tail", x_tail, (nb, 2, plan.tail_len)),
        ("phase", phase, (nb, k)),
        ("frag", tables.frag, (nb, *frag_shape(m, plan.poly_rows, k))),
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
    """The C entry points' arguments but the stream (``csrc/ddc_kernel.cu``
    ``modtap_stage1`` and ``modtap_fold`` take the same)."""
    xs = _pairs(iq)
    nb, n = xs.shape[0], xs.shape[1]
    rot = tables.rot
    return (
        xs.data_ptr(), int(xs.dtype == torch.int8), xs.stride(0), n, x_tail.data_ptr(), tables.frag.data_ptr(),
        phase.data_ptr(), rot.coarse_re.data_ptr(), rot.coarse_im.data_ptr(), rot.fine_re.data_ptr(),
        rot.fine_im.data_ptr(), y.data_ptr(), new_tail.data_ptr(), nb, phase.shape[1], plan.tail_len, plan.decim,
        plan.poly_rows, n // plan.decim, rot.fine_re.shape[-1], rot.coarse_re.shape[-1],
    )


def launch(entry: str, iq: torch.Tensor, x_tail: torch.Tensor, phase: torch.Tensor, tables, plan):
    """One launch of entry point ``entry`` (``modtap_stage1``: the lag form,
    ``modtap_fold``: the folded form) on CUDA tensors that ``check_args``
    takes but for ``tables.frag``, which holds that form's B: (y, new tail).
    Counts nothing; ``modtap_stage1`` picks the form and counts."""
    nb, n, k = iq.shape[0], iq.shape[1], phase.shape[1]
    y = torch.empty((nb * k, 2, n // plan.decim), dtype=torch.float32, device=iq.device)
    new_tail = torch.empty_like(x_tail)
    from rtl_sdr_scanner_tpu_torch.ops.cuda.build import check, library

    stream = torch.cuda.current_stream(iq.device).cuda_stream
    rc = getattr(library(), entry)(*launch_args(iq, x_tail, phase, tables, plan, y, new_tail), stream)
    check(rc, entry)
    return y, new_tail


def modtap_stage1(
    iq: torch.Tensor, x_tail: torch.Tensor, phase: torch.Tensor, tables, plan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """iq [NB, n, 2] int8 cs8 / f32 pairs or [NB, n] complex, x_tail [NB, 2,
    tail_len] f32, phase [NB, K] f32, ``ModTables`` on the same device ->
    (y [NB*K, 2, n / M] f32, new tail [NB, 2, tail_len] f32).

    On a CUDA tensor this launches the kernel in the form the shape takes
    (``folds``: the folded form through ``modtap_stage1_fold``, else the lag
    form) and counts the launch in ``modtap_stage1.launches``; on a CPU
    tensor it runs the plain version.
    """
    if iq.device.type == "cpu":
        return modtap_stage1_plain(iq, x_tail, phase, tables, plan)
    if iq.device.type != "cuda":
        raise ValueError(f"modtap_stage1: unsupported device {iq.device}")
    check_args(iq, x_tail, phase, tables, plan)
    if folds(plan.decim, plan.poly_rows, phase.shape[1]):
        out = modtap_stage1_fold(iq, x_tail, phase, tables, plan)
    else:
        out = launch("modtap_stage1", iq, x_tail, phase, tables, plan)
    modtap_stage1.launches += 1
    return out


def modtap_stage1_fold(
    iq: torch.Tensor, x_tail: torch.Tensor, phase: torch.Tensor, tables, plan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded form's launch on arguments that ``modtap_stage1`` has
    checked and found to fold, counted in ``modtap_stage1_fold.launches``."""
    out = launch("modtap_fold", iq, x_tail, phase, tables, plan)
    modtap_stage1_fold.launches += 1
    return out


modtap_stage1.launches = 0
modtap_stage1_fold.launches = 0
