"""Multi-band and time-sharded block steps over a (bands, time) mesh (port
of the JAX package's ``parallel/sharded_scan.py``).

Bands axis. The B bands split into n contiguous band shards of B/n bands,
shard i on ``mesh.band_devices[i]``; the shards exchange nothing. Every
tensor argument and result of a bands step is a **per-shard list**, one
entry per band shard, each on its shard's device:
- a band-stacked value (scan and DDC state, spectrogram accumulators,
  tracked keys, valid masks, DDC tables, keep masks, packed rows,
  recordings, channel streams) holds that shard's B/n bands ([B/n, ...]
  leaves; a state is a list of trees);
- a replicated value (the channelizer state, the wideband block, the frame
  times, the start level) holds a copy on each shard's device.
``shard_bands``, ``replicate`` and ``gather_bands`` move a whole tensor (or
tree) to and from this layout. The wideband steps run the channelizer on
every shard (its state replicated) and each shard keeps its own channels,
as the JAX package does; they do not channelize once and scatter.

Under multi-host a process's mesh holds only its own band shards
(``Mesh.band_shards``, their global indices, of ``Mesh.n_band_shards``):
B/n counts the global shards, and every slice of a band-stacked value
(``shard_bands``, each shard's own channels) is taken at the shard's global
position, so a process never scans another's bands.

Time axis. One band's block splits into n consecutive time shards on
``mesh.time_devices``. A time-sharded step keeps the serial step's
signature: it takes whole-block tensors and returns them on ``mesh.device``,
and splits, exchanges halos and stitches carries inside
(``parallel/halo.py``, ``parallel/collectives.py``).

Argument order and layouts are otherwise the JAX functions'. Building a
step switches TF32 off (the channelizer's and the DDC's f32 products).
Each shard's work runs with its card current (``collectives.on``).

Every builder returns a ``graph.Program``: each shard's work between two
exchanges is a segment (its function built once, with the step), the
exchanges run between them. Called, a Program runs eagerly (the JAX
function un-jitted); ``graph.sharded_step(program, name)`` captures a
graph a (shard, segment) and replays them (``jax.jit`` over ``shard_map``),
each segment donating its shard's part of what the JAX function donates.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from rtl_sdr_scanner_tpu_torch.constants import NO_DATA
from rtl_sdr_scanner_tpu_torch.graph import Program
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig, _band_axis, _ddc_block_banded
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import (
    ScanConfig,
    ScanState,
    _compact_scan_block,
    _frames_power,
    _scan_block,
    init_scan_state,
)
from rtl_sdr_scanner_tpu_torch.ops.averager import AveragerState, averager_block, ordered_history
from rtl_sdr_scanner_tpu_torch.ops.channelizer import (
    ChannelizerPlan,
    channelize_block_2x_pairs,
    channelize_block_pairs,
)
from rtl_sdr_scanner_tpu_torch.ops.ddc import (
    Ddc2State,
    NcoTables,
    _components,
    _modtap_stage1,
    _nco_q,
    _rotation,
    _stage_apply,
    no_tf32,
)
from rtl_sdr_scanner_tpu_torch.ops.detect import compact_detection
from rtl_sdr_scanner_tpu_torch.ops.noise import NoiseState
from rtl_sdr_scanner_tpu_torch.ops.smooth import sliding_average
from rtl_sdr_scanner_tpu_torch.ops.spectrogram import accumulate_frames
from rtl_sdr_scanner_tpu_torch.parallel.collectives import gather, on, pmax, ppermute_right, psum, to
from rtl_sdr_scanner_tpu_torch.parallel.halo import resample_chain_sharded
from rtl_sdr_scanner_tpu_torch.parallel.mesh import Mesh
from rtl_sdr_scanner_tpu_torch.utils.trace import span

# the profiler ranges a wideband block opens beyond the scan's own
# (fused_step.STAGES) and "ddc"
STAGES = ("channelize",)


# -- the per-shard layout ------------------------------------------------------


def _map(fn, *trees):
    """fn over the tensor leaves of equally shaped trees (tensors, named
    tuples, tuples)."""
    head = trees[0]
    if isinstance(head, torch.Tensor):
        return fn(*trees)
    items = [_map(fn, *parts) for parts in zip(*trees)]
    return type(head)(*items) if hasattr(head, "_fields") else tuple(items)


def _bands_per_shard(mesh: Mesh, n_bands: int) -> int:
    n_dev = mesh.n_band_shards
    if n_bands % n_dev != 0:
        raise ValueError(f"{n_bands} bands do not split over {n_dev} band shards")
    return n_bands // n_dev


def shard_bands(tree, mesh: Mesh) -> list:
    """A band-stacked tree ([B, ...] leaves) -> the per-shard list: shard i
    (global index) holds bands [i*B/n, (i+1)*B/n) on its device."""
    n_bands = (tree if isinstance(tree, torch.Tensor) else _leaves(tree)[0]).shape[0]
    b_loc = _bands_per_shard(mesh, n_bands)
    return [
        _map(lambda a, i=i, d=d: to(a[i * b_loc : (i + 1) * b_loc], d), tree)
        for i, d in zip(mesh.band_shards, mesh.band_devices)
    ]


def replicate(tree, mesh: Mesh) -> list:
    """A copy of the tree on each band shard's device."""
    return [_map(lambda a, d=d: to(a, d), tree) for d in mesh.band_devices]


def gather_bands(shards: Sequence, device: torch.device):
    """The per-shard list -> one band-stacked tree on ``device``."""
    return _map(lambda *parts: gather(parts, device), *shards)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


def init_banded_state(cfg: ScanConfig, n_bands: int, mesh: Mesh, start_ms: int = 0) -> List[ScanState]:
    """Band-stacked scan state, one [B/n, ...] tree on each band shard."""
    b_loc = _bands_per_shard(mesh, n_bands)
    return [init_scan_state(cfg, b_loc, start_ms, device=d) for d in mesh.band_devices]


def init_banded_ddc_state(cfg: DdcConfig, n_bands: int, mesh: Mesh) -> list:
    """Band-stacked DDC carry (leading band axis on every leaf), one
    [B/n, ...] tree on each band shard."""
    b_loc = _bands_per_shard(mesh, n_bands)
    return [ddc_pipeline.init_state(cfg, b_loc, device=d) for d in mesh.band_devices]


# -- bands axis -----------------------------------------------------------------


def _bands_program(devs: Sequence[torch.device], shard_fns: Sequence, donate: Tuple[int, ...]) -> Program:
    """Band shard i's step ``shard_fns[i]`` on entry i of each per-shard
    list argument (a number as it is), one segment a shard donating
    ``donate`` (the shard's part of what the JAX function donates): the
    bands axis exchanges nothing. Results are per-shard lists."""

    def run(segment, *args):
        results = []
        for i, dev in enumerate(devs):
            part = [a[i] if isinstance(a, (list, tuple)) else a for a in args]
            with on(dev):
                results.append(segment(f"shard {i}", shard_fns[i], donate, dev)(*part))
        return tuple(list(r) for r in zip(*results))

    return Program(run)


def make_sharded_scan_step(cfg: ScanConfig, mesh: Mesh) -> Program:
    """Full-row banded step: (state[B,..], iq[B, F, group, 2], now[B, F])
    -> (state, ScanOutputs[B, ..]), each a per-shard list; donates (0,)."""
    devs = mesh.band_devices

    def shard(state, iq, now):
        return _scan_block(cfg, state, iq, now)

    return _bands_program(devs, [shard] * len(devs), (0,))


def make_sharded_compact_step(cfg: ScanConfig, group_size: int, top_k: int, mesh: Mesh) -> Program:
    """Compact-detection banded step; each band keeps its own tracked keys
    and valid mask:
    (state[B,..], acc[B,S], iq[B,F,G,2], now[B,F], keys[B,S], valid[B,fft],
     start_level, keep) -> (state, acc, CompactScanOutputs[B,..]),
    each a per-shard list but ``keep`` (a float); donates (0, 1)."""
    devs = mesh.band_devices

    def shard(state, acc, iq, now, keys, valid, level, keep):
        return _compact_scan_block(cfg, group_size, top_k, state, acc, iq, now, keys, valid, level, keep)

    return _bands_program(devs, [shard] * len(devs), (0, 1))


def _channelizer(plan: ChannelizerPlan, oversample: int):
    fn = channelize_block_2x_pairs if oversample == 2 else channelize_block_pairs
    return lambda state, x_pairs: fn(plan, state, x_pairs)


def _keep_slots(state: Ddc2State, keep: torch.Tensor) -> Ddc2State:
    """Zero the phase and stage-2+ tails of slots whose keep is 0 (a slot
    reset; the shared raw-x tail persists, as ``reset_slot2``)."""
    return Ddc2State(
        phase=state.phase * keep,
        x_tail=state.x_tail,
        tails=tuple(t * keep[..., None, None] for t in state.tails),
    )


def _shard_channels(chan_fn, i: int, b_loc: int, chan_state, x_pairs):
    """The channelizer on one shard (every band), and the shard's own
    channels [B/n, n_sub, 2] (``i``: its global index)."""
    with span("channelize"):
        chan_state, channels = chan_fn(chan_state, x_pairs)  # [B, n_sub, 2]
    return chan_state, channels[i * b_loc : (i + 1) * b_loc]


def _scan_channels(cfg, group_size, top_k, b_loc, state, acc, channels, now, keys, valid, level, keep):
    frames = cfg.frames_per_block
    group = cfg.fft_size * cfg.decimator_factor
    iq = channels.reshape(b_loc, frames, group, 2)
    now_b = now[None, :].expand(b_loc, frames)
    return _compact_scan_block(cfg, group_size, top_k, state, acc, iq, now_b, keys, valid, level, keep)


def make_sharded_wideband_step(
    cfg: ScanConfig,
    group_size: int,
    top_k: int,
    mesh: Mesh,
    plan: ChannelizerPlan,
    oversample: int,
    n_bands: int,
) -> Program:
    """Channelizer + banded compact scan, one step over the band shards:
    (chan_state, scan_state[B,..], acc[B,S], x_pairs[n,2], now[F],
     keys[B,S], valid[B,fft], level, keep) ->
      (chan_state, scan_state, acc, packed[B,L], channels[B, n_sub, 2])
    each a per-shard list but ``keep`` (a float); x_pairs f32 pairs or int8
    cs8, level a 0-d f32 tensor (replicated like chan_state, x_pairs, now);
    donates (0, 1, 2)."""
    no_tf32()
    chan_fn = _channelizer(plan, oversample)
    b_loc = _bands_per_shard(mesh, n_bands)

    def shard_fn(g: int):
        def shard(chan_state, state, acc, x_pairs, now, keys, valid, level, keep):
            chan_state, local = _shard_channels(chan_fn, g, b_loc, chan_state, x_pairs)
            state, acc, outs = _scan_channels(
                cfg, group_size, top_k, b_loc, state, acc, local, now, keys, valid, level, keep
            )
            return chan_state, state, acc, outs.packed, local

        return shard

    return _bands_program(mesh.band_devices, [shard_fn(g) for g in mesh.band_shards], (0, 1, 2))


def make_sharded_wideband_fused_step(
    cfg: ScanConfig,
    ddc_cfg: DdcConfig,
    group_size: int,
    top_k: int,
    mesh: Mesh,
    plan: ChannelizerPlan,
    oversample: int,
    n_bands: int,
) -> Program:
    """Channelizer + banded compact scan + banded K*B-slot DDC in one step.
    ``keep_mask`` and ``tables`` are inputs: the host supplies the slot
    reconcile it derived from the previous block's detections (the
    reference's notification timing, recorder.cpp:58-73).

    (chan_state, scan_state[B,..], acc[B,S], ddc_state[B,..], x_pairs[n,2],
     now[F], keys[B,S], valid[B,fft], level, keep, tables[B,..],
     keep_mask[B,K]) ->
      (chan_state, scan_state, acc, ddc_state, packed[B,L],
       rec[B,K,out,2] i8, channels[B, n_sub, 2]), per-shard lists; donates
    (0, 1, 2, 3)."""
    assert ddc_cfg.modtap, "fused wideband step requires the modulated-taps chain"
    no_tf32()
    chan_fn = _channelizer(plan, oversample)
    b_loc = _bands_per_shard(mesh, n_bands)

    def shard_fn(g: int):
        def shard(chan_state, state, acc, ddc_state, x_pairs, now, keys, valid, level, keep, tables, keep_mask):
            chan_state, local = _shard_channels(chan_fn, g, b_loc, chan_state, x_pairs)
            state, acc, outs = _scan_channels(
                cfg, group_size, top_k, b_loc, state, acc, local, now, keys, valid, level, keep
            )
            with span("ddc"):
                ddc_state, rec = _ddc_block_banded(ddc_cfg, _keep_slots(ddc_state, keep_mask), local, tables)
            return chan_state, state, acc, ddc_state, outs.packed, rec, local

        return shard

    return _bands_program(mesh.band_devices, [shard_fn(g) for g in mesh.band_shards], (0, 1, 2, 3))


def make_sharded_banded_ddc(cfg: DdcConfig, mesh: Mesh, n_bands: int) -> Program:
    """All channels' K-slot DDC in one step over the band shards; slot
    resets ride a keep mask (0 = zero that slot's carry before the block):
    (state[NB,..], channels[NB, n, 2] f32 pairs, tables[NB,..], keep[NB, K])
      -> (state, int8 [NB, K, out_per_block, 2]), per-shard lists; donates
    (0,)."""
    assert cfg.modtap, "banded sharded DDC requires the modulated-taps chain"
    no_tf32()
    _bands_per_shard(mesh, n_bands)
    devs = mesh.band_devices

    def shard(state, channels, tables, keep):
        with span("ddc"):
            return _ddc_block_banded(cfg, _keep_slots(state, keep), channels, tables)

    return _bands_program(devs, [shard] * len(devs), (0,))


# -- time axis ------------------------------------------------------------------


def make_time_sharded_scan(cfg: ScanConfig, mesh: Mesh, group_size: int, top_k: int) -> Program:
    """One band's detection frames split over the "time" axis, with the
    detector carries stitched across shard seams:
    - noise max-hold: the learning frames are a time prefix and max is
      associative, so the frozen threshold is the max over shards of each
      shard's learning max (``pmax``); readiness is time arithmetic on the
      frame times, the frame before each shard's first included
      (-(2**30) before shard 0);
    - averager ring: each shard takes its left neighbour's last grouping_y
      raw rows (``ppermute``), shard 0 the carried ring, so every boxcar
      window and the history vote's previous rows are exact at the seams;
      the outgoing ring and total are the last shard's;
    - detection runs on each shard's own frames: the PSD kernel (int8
      ingest) and the selection kernel once a shard.

    Three segments a shard, between the exchanges: (a) the PSD and the
    learning max of frames not yet ready; ``pmax``; (b) the noise-subtracted
    rows; ``ppermute_right`` of the last grouping_y rows; (c) the averager,
    smoothing, detection, spectrogram and packed body; then the last
    shard's ring (``last``), ``gather`` and ``psum`` on ``mesh.device``. No segment donates (the JAX
    form donates nothing).

    Needs frames_per_shard >= grouping_y. Returns a step
    (state, iq[F, group, 2], now[F] i32, keys[S], valid[fft], level)
      -> (state, body [F, 3K+1+2S] f32 packed rows, spectro [S] f32,
          noise_ready 0-d bool)
    with the single-band state layout, everything on ``mesh.device``. It
    matches the serial ``_compact_scan_block`` within float tolerance: the
    window sums take per-shard cumsum prefixes (~1 ulp), and the
    spectrogram sums the shards in order."""
    devs = mesh.time_devices
    home = mesh.device
    n_time = len(devs)
    depth = cfg.grouping_y
    half_depth = depth - depth // 2
    f_global = cfg.frames_per_block
    if f_global % n_time != 0 or f_global // n_time < depth:
        raise ValueError(
            f"{f_global} frames do not split over {n_time} time shards of at least the averager depth {depth}"
        )
    f_loc = f_global // n_time
    learn_ms = cfg.noise_learning_ms
    last_t = n_time - 1

    def psd(iq, now, prev, start, ready_in):
        """(a): the shard's PSD rows, its last frame's learning test, each
        frame's readiness and the max of its rows not yet ready."""
        with span("scan.psd"):
            p = _frames_power(cfg, iq[None])[0]  # [f_loc, fft]
        c = start + learn_ms <= now
        ready = ready_in | torch.cat([(start + learn_ms <= prev)[None], c[:-1]])
        held = torch.where((~ready)[:, None], p, -torch.inf).amax(dim=0)
        return p, c[-1:], ready, held

    def noise_fn(t: int):
        def noise(p, ready, threshold_in, held_max, *first):
            """(b): the noise-subtracted rows; shard 0 also the frozen
            threshold and the block's readiness (``first``: every shard's
            last learning test, the carried readiness)."""
            threshold = torch.maximum(threshold_in, held_max)
            with span("scan.noise"):
                r = torch.where(ready[:, None], p - threshold[None, :], NO_DATA)
                r = r.to(torch.bfloat16) if cfg.power_bf16 else r
            if t == 0:
                conds, ready0 = first
                return r, threshold, ready0 | conds.any()
            return (r,)

        return noise

    def detect_fn(t: int):
        def detect(raw, left, frames_in, keys, valid, level, p):
            """(c): shard t's rows through the averager (``left``: the
            previous grouping_y raw rows, or on shard 0 the carried averager
            state), smoothing and detection; its spectrogram sum and packed
            body, the last shard's averager ring and total, shard 0's
            outgoing position and frame count."""
            dev = raw.device
            prev_rows = ordered_history(_band_axis(left, add=True))[0] if t == 0 else left
            synth = AveragerState(
                ring=prev_rows[None],
                total=torch.zeros((1, cfg.fft_size), dtype=torch.float32, device=dev),
                pos=torch.zeros((1,), dtype=torch.int32, device=dev),
                frames=torch.clamp(frames_in + t * f_loc, max=depth).to(torch.int32)[None],
            )
            with span("scan.averager"):
                avg_state, means = averager_block(synth, raw[None])
            with span("scan.smoothing"):
                avg_rows = sliding_average(means, cfg.grouping_x)
            with span("scan.detection"):
                compact = compact_detection(
                    avg_rows, raw[None], prev_rows[-(half_depth - 1) :][None], keys, valid, level, group_size,
                    top_k, bf16=cfg.detection_bf16,
                )
            with span("scan.spectrogram"):
                spectro = accumulate_frames(p, cfg.spectro_size)
            f32 = lambda a: a.to(torch.float32)
            body = torch.cat(
                [f32(compact.cand_idx), compact.cand_val, f32(compact.cand_best),
                 f32(compact.cand_count)[..., None], compact.key_val, f32(compact.key_idx)],
                dim=2,
            )[0]  # [f_loc, 3K+1+2S]
            outs = (body, spectro)
            if t == last_t:
                outs += (avg_state.ring[0], avg_state.total[0])
            if t == 0:
                outs += (torch.zeros_like(left.pos), torch.clamp(frames_in + f_global, max=depth).to(torch.int32))
            return outs

        return detect

    noise_fns = [noise_fn(t) for t in range(n_time)]
    detect_fns = [detect_fn(t) for t in range(n_time)]
    frames = [slice(t * f_loc, (t + 1) * f_loc) for t in range(n_time)]

    def run(segment, state: ScanState, iq: torch.Tensor, now: torch.Tensor, keys, valid, level):
        noise_in = NoiseState(*(to(a, home) for a in state.noise))
        avg_in = AveragerState(*(to(a, home) for a in state.averager))

        power, last_cond, was_ready, held = [], [], [], []
        for t, dev in enumerate(devs):
            prev = -(2**30) if t == 0 else now[t * f_loc - 1]
            with on(dev):
                p, c, ready, h = segment(f"shard {t} psd", psd, (), dev)(
                    iq[frames[t]], now[frames[t]], prev, noise_in.start_ms, noise_in.ready)
            power.append(p)
            last_cond.append(c)
            was_ready.append(ready)
            held.append(h)
        held_max = pmax(held, devs)
        conds = gather(last_cond, home)

        raw = []
        for t, dev in enumerate(devs):
            first = (conds, noise_in.ready) if t == 0 else ()
            with on(dev):
                out = segment(f"shard {t} noise", noise_fns[t], (), dev)(
                    power[t], was_ready[t], noise_in.threshold, held_max[t], *first)
            raw.append(out[0])
            if t == 0:
                threshold, ready_out = out[1:]
        left = ppermute_right([r[-depth:] for r in raw], devs)
        left[0] = avg_in

        bodies, spectros = [], []
        for t, dev in enumerate(devs):
            with on(dev):
                out = segment(f"shard {t} detect", detect_fns[t], (), dev)(
                    raw[t], left[t], avg_in.frames, keys, valid, level, power[t])
            bodies.append(out[0])
            spectros.append(out[1])
            if t == last_t:
                ring, total = out[2:4]
            if t == 0:
                pos, frames_out = out[-2:]

        avg_out = AveragerState(ring=to(ring, home).to(avg_in.ring.dtype), total=to(total, home), pos=pos,
                                frames=frames_out)
        noise_out = NoiseState(threshold=threshold, ready=ready_out, start_ms=noise_in.start_ms)
        return ScanState(noise_out, avg_out), gather(bodies, home), psum(spectros, home), ready_out

    return Program(run)


def time_sharded_modtap_fits(cfg: DdcConfig, n_time: int) -> bool:
    """Static check: can ``cfg``'s chain be time-sharded n_time ways exactly?"""
    if not cfg.modtap:
        return False
    p0 = cfg.plans[0]
    if cfg.chunk % (n_time * p0.decim) != 0:
        return False
    n = cfg.chunk // n_time
    for plan in cfg.plans:
        if n < plan.tail_len or (n * plan.interp) % plan.decim != 0:
            return False
        n = n * plan.interp // plan.decim
    return True


def _quantized(y: torch.Tensor) -> torch.Tensor:
    """[K, 2, n] f32 -> int8 [K, n, 2] recording samples."""
    return torch.clamp(torch.round(torch.movedim(y, 1, 2) * 127.0), -128, 127).to(torch.int8)


def make_time_sharded_modtap_ddc(cfg: DdcConfig, mesh: Mesh) -> Program:
    """Streaming time-sharded modulated-taps DDC with the serial step's
    signature: (state: Ddc2State, iq [block, 2] f32 pairs / int8 cs8 or
    [block] complex, tables: ModTables), single-band layouts ->
    (state, int8 [K, out_per_block, 2]), on ``mesh.device``.

    The same carry, tables, per-chunk phase stepping and products as the
    serial path (``models/ddc_pipeline._ddc_block``); only each chunk's
    samples are split over the time axis, the raw stage-1 tail and every
    later stage tail stitched at the seams (shard 0 takes the carried
    block-boundary tail at chunk 0 and the chunk before's last samples
    after it; the last shard's tail becomes the next carry). A shard's
    stage-1 halos are raw samples it reads from the block itself. Each
    later stage's halos are exchanged once a block, after every shard has
    run the stage before over every chunk: every chunk's seam to the right
    neighbour (``ppermute_right``), and the last shard's seams to shard 0,
    a chunk later. The rotation tables are gathered per shard by global
    decimated index, so each output sample is the same product of the same
    f32 operands in the same order: coarse entry times phase, then the
    fine entry.

    Segments a shard and stage, each looping over the block's chunks
    inside (the JAX form's ``lax.scan``) with each product at the serial
    step's per-chunk shapes: stage 1 with the rotation, then each later
    stage (the last one quantizing). The last shard's segments write the
    carry, donating it (the JAX form donates (0,)): stage 1 the phase
    (stepped once a chunk) and the raw tail, each later stage its tail."""
    devs = mesh.time_devices
    home = mesh.device
    n_time = len(devs)
    if not time_sharded_modtap_fits(cfg, n_time):
        raise ValueError("geometry cannot be time-sharded exactly; check time_sharded_modtap_fits")
    no_tf32()
    p0 = cfg.plans[0]
    later = cfg.plans[1:]
    k = cfg.num_slots
    num_chunks = cfg.num_chunks
    tail0 = p0.tail_len
    chunk_loc = cfg.chunk // n_time
    out1_loc = cfg.chunk // p0.decim // n_time
    q_val = _nco_q(cfg.chunk // p0.decim)
    last_t = n_time - 1

    def stage1_fn(t: int):
        def stage1(carry, x, w, rot, prev=None):
            """Shard t's samples of every chunk, x [num_chunks, (tail0 +)
            chunk_loc, ...] (t > 0: its left neighbour's last tail0 before
            them), through stage 1 and the rotation, a chunk at a time.
            Shard 0's halo is the carried raw tail at chunk 0, then the
            chunk before's last tail0 samples (``prev`` [num_chunks, tail0,
            ...], each chunk's). The last shard also returns the phase
            after the last chunk and the raw tail. -> y [num_chunks, K, 2,
            out1_loc] (int8 [num_chunks, K, out1_loc, 2] when stage 1 is
            the last)."""
            ph, x_tail = carry
            c_re, c_im, f_re, f_im, step = rot
            g = t * out1_loc + torch.arange(out1_loc, device=x.device)
            cre_s, cim_s, fre_s, fim_s = c_re[:, g // q_val], c_im[:, g // q_val], f_re[:, g % q_val], f_im[:, g % q_val]
            ys = []
            for c in range(num_chunks):
                comps = torch.stack(_components(x[c]), dim=0)  # [2, (tail0 +) chunk_loc]
                if t > 0:
                    left, xs = comps[:, :tail0], comps[:, tail0:]
                else:
                    left, xs = (x_tail if c == 0 else torch.stack(_components(prev[c - 1]), dim=0)), comps
                y_re, y_im, local = _modtap_stage1(xs[None], left[None], w[None], p0, k)
                y_re, y_im = y_re[0], y_im[0]  # [K, out1_loc]
                ph_re, ph_im = torch.cos(ph)[:, None], torch.sin(ph)[:, None]
                cre = ph_re * cre_s - ph_im * cim_s
                cim = ph_re * cim_s + ph_im * cre_s
                rot_re = cre * fre_s - cim * fim_s
                rot_im = cre * fim_s + cim * fre_s
                y = torch.stack([y_re * rot_re - y_im * rot_im, y_re * rot_im + y_im * rot_re], dim=1)
                ys.append(y if later else _quantized(y))
                ph = torch.remainder(ph + step, 2.0 * math.pi)
            if t == last_t:
                return (ph, local[0]), torch.stack(ys)
            return (torch.stack(ys),)

        return stage1

    def stage_fn(t: int, s: int):
        plan, quantize = later[s], s == len(later) - 1

        def stage(tail, y, left):
            """Shard t's stage input y [num_chunks, K, 2, n], a chunk at a
            time. Halos: t > 0, ``left[c]`` (the left neighbour's last
            samples at chunk c); shard 0, the carried ``tail`` at chunk 0,
            then ``left[c - 1]`` (the last shard's at the chunk before).
            Returns the last chunk's new tail (the carry, on the last
            shard) and the outputs stacked."""
            outs = []
            for c in range(num_chunks):
                halo = left[c] if t > 0 else (tail if c == 0 else left[c - 1])
                out, local = _stage_apply(y[c], halo.contiguous(), plan)  # eager: a view of another shard's rows
                outs.append(_quantized(out) if quantize else out)
            return local, torch.stack(outs)

        return stage if t == last_t else lambda tail, y, left: stage(tail, y, left)[1:]

    stage1_fns = [stage1_fn(t) for t in range(n_time)]
    stage_fns = [[stage_fn(t, s) for s in range(len(later))] for t in range(n_time)]

    def run(segment, state: Ddc2State, iq: torch.Tensor, tables):
        x = iq.reshape(num_chunks, cfg.chunk, *iq.shape[1:])
        rot = (*tables.rot[:4], tables.rot.step)
        carry = (state.phase, state.x_tail)
        ys = []
        for t, dev in enumerate(devs):
            args = (carry, x[:, max(t * chunk_loc - tail0, 0) : (t + 1) * chunk_loc], tables.w, rot)
            if t == 0:  # each chunk's last raw samples: shard 0's halo at the chunk after
                args += (x[:, cfg.chunk - tail0 :],)
            with on(dev):
                if t == last_t:
                    new_carry, y = segment(f"shard {t} stage 1", stage1_fns[t], (0,), dev)(*args)
                else:
                    (y,) = segment(f"shard {t} stage 1", stage1_fns[t], (), dev)(*args)
            ys.append(y)
        tails = list(state.tails)
        for s, plan in enumerate(later):
            seams = [y[..., -plan.tail_len :] for y in ys]
            lefts = ppermute_right(seams, devs)
            lefts[0] = to(seams[-1], devs[0])  # shard 0's halos, a chunk later
            for t, dev in enumerate(devs):
                name = f"shard {t} stage {s + 2}"
                with on(dev):
                    if t == last_t:
                        tails[s], ys[t] = segment(name, stage_fns[t][s], (0,), dev)(tails[s], ys[t], lefts[t])
                    else:
                        (ys[t],) = segment(name, stage_fns[t][s], (), dev)(tails[s], ys[t], lefts[t])
        out = gather(ys, home, dim=2)  # [num_chunks, K, out_per_chunk, 2]
        state = Ddc2State(phase=to(new_carry[0], home), x_tail=to(new_carry[1], home),
                          tails=tuple(to(a, home) for a in tails))
        return state, torch.movedim(out, 0, 1).reshape(k, -1, 2)

    return Program(run)


def make_time_sharded_ddc(cfg: DdcConfig, mesh: Mesh) -> Program:
    """One band's block time-sharded over the "time" axis, K slots batched
    (the v1 chain): (iq [n_global] complex / [n_global, 2] pairs, tables)
    -> int8 [K, out_global, 2] on ``mesh.device``. ``tables`` are built for
    the GLOBAL chunk length (``ops/ddc.make_nco_tables(shifts, rate,
    n_global)``), so each shard takes its own slice of the coarse angles
    exactly; the stage tails come from the left neighbour (zeros on shard 0,
    a stream start). Segments a shard: the rotation, each stage
    (``halo.resample_chain_sharded``), the quantize; no donation."""
    devs = mesh.time_devices
    home = mesh.device
    n_time = len(devs)
    no_tf32()

    def rotate(iq, coarse_re, coarse_im, fine_re, fine_im, step):
        x_re, x_im = _components(iq)
        rot_re, rot_im = _rotation(torch.zeros_like(step), NcoTables(coarse_re, coarse_im, fine_re, fine_im, step),
                                   x_re.shape[-1])
        return (torch.stack([x_re * rot_re - x_im * rot_im, x_re * rot_im + x_im * rot_re], dim=1),)

    def quantize(y):
        return (_quantized(y),)

    def run(segment, iq: torch.Tensor, tables: NcoTables) -> torch.Tensor:
        n_loc = iq.shape[0] // n_time
        nq_loc = tables.coarse_re.shape[-1] // n_time
        ys = []
        for t, dev in enumerate(devs):
            coarse = slice(t * nq_loc, (t + 1) * nq_loc)
            with on(dev):
                (y,) = segment(f"shard {t} rotate", rotate, (), dev)(
                    iq[t * n_loc : (t + 1) * n_loc], tables.coarse_re[:, coarse], tables.coarse_im[:, coarse],
                    tables.fine_re, tables.fine_im, tables.step)
            ys.append(y)
        ys = resample_chain_sharded(ys, cfg.plans, devs, segment)
        outs = []
        for t, dev in enumerate(devs):
            with on(dev):
                (out,) = segment(f"shard {t} quantize", quantize, (), dev)(ys[t])
            outs.append(out)
        return gather(outs, home, dim=1)

    return Program(run)


__all__ = [
    "STAGES",
    "gather_bands",
    "init_banded_ddc_state",
    "init_banded_state",
    "make_sharded_banded_ddc",
    "make_sharded_compact_step",
    "make_sharded_scan_step",
    "make_sharded_wideband_fused_step",
    "make_sharded_wideband_step",
    "make_time_sharded_ddc",
    "make_time_sharded_modtap_ddc",
    "make_time_sharded_scan",
    "replicate",
    "shard_bands",
    "time_sharded_modtap_fits",
]
