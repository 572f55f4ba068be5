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
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch.profiler import record_function

from rtl_sdr_scanner_tpu_torch.constants import NO_DATA
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
from rtl_sdr_scanner_tpu_torch.parallel.collectives import gather, last, on, pmax, ppermute_right, psum, to
from rtl_sdr_scanner_tpu_torch.parallel.halo import halo_from_left, resample_chain_sharded
from rtl_sdr_scanner_tpu_torch.parallel.mesh import Mesh

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


def make_sharded_scan_step(cfg: ScanConfig, mesh: Mesh):
    """Full-row banded step: (state[B,..], iq[B, F, group, 2], now[B, F])
    -> (state, ScanOutputs[B, ..]), each a per-shard list."""
    devs = mesh.band_devices

    def step(states, iqs, nows):
        out_states, outs = [], []
        for i, dev in enumerate(devs):
            with on(dev):
                state, out = _scan_block(cfg, states[i], iqs[i], nows[i])
            out_states.append(state)
            outs.append(out)
        return out_states, outs

    return step


def make_sharded_compact_step(cfg: ScanConfig, group_size: int, top_k: int, mesh: Mesh):
    """Compact-detection banded step; each band keeps its own tracked keys
    and valid mask:
    (state[B,..], acc[B,S], iq[B,F,G,2], now[B,F], keys[B,S], valid[B,fft],
     start_level, keep) -> (state, acc, CompactScanOutputs[B,..]),
    each a per-shard list but ``keep`` (a float)."""
    devs = mesh.band_devices

    def step(states, accs, iqs, nows, keys, valid, level, keep):
        results = []
        for i, dev in enumerate(devs):
            with on(dev):
                results.append(_compact_scan_block(
                    cfg, group_size, top_k, states[i], accs[i], iqs[i], nows[i], keys[i], valid[i], level[i], keep
                ))
        return tuple(list(r) for r in zip(*results))

    return step


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
    with record_function("channelize"):
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
):
    """Channelizer + banded compact scan, one step over the band shards:
    (chan_state, scan_state[B,..], acc[B,S], x_pairs[n,2], now[F],
     keys[B,S], valid[B,fft], level, keep) ->
      (chan_state, scan_state, acc, packed[B,L], channels[B, n_sub, 2])
    each a per-shard list but ``keep`` (a float); x_pairs f32 pairs or int8
    cs8, level a 0-d f32 tensor (replicated like chan_state, x_pairs, now)."""
    no_tf32()
    chan_fn = _channelizer(plan, oversample)
    b_loc = _bands_per_shard(mesh, n_bands)
    devs = mesh.band_devices
    shards = mesh.band_shards

    def step(chan_states, states, accs, x_pairs, now, keys, valid, level, keep):
        results = []
        for i, dev in enumerate(devs):
            with on(dev):
                chan_state, local = _shard_channels(chan_fn, shards[i], b_loc, chan_states[i], x_pairs[i])
                state, acc, outs = _scan_channels(
                    cfg, group_size, top_k, b_loc, states[i], accs[i], local, now[i], keys[i], valid[i], level[i], keep
                )
            results.append((chan_state, state, acc, outs.packed, local))
        return tuple(list(r) for r in zip(*results))

    return step


def make_sharded_wideband_fused_step(
    cfg: ScanConfig,
    ddc_cfg: DdcConfig,
    group_size: int,
    top_k: int,
    mesh: Mesh,
    plan: ChannelizerPlan,
    oversample: int,
    n_bands: int,
):
    """Channelizer + banded compact scan + banded K*B-slot DDC in one step.
    ``keep_mask`` and ``tables`` are inputs: the host supplies the slot
    reconcile it derived from the previous block's detections (the
    reference's notification timing, recorder.cpp:58-73).

    (chan_state, scan_state[B,..], acc[B,S], ddc_state[B,..], x_pairs[n,2],
     now[F], keys[B,S], valid[B,fft], level, keep, tables[B,..],
     keep_mask[B,K]) ->
      (chan_state, scan_state, acc, ddc_state, packed[B,L],
       rec[B,K,out,2] i8, channels[B, n_sub, 2]), per-shard lists."""
    assert ddc_cfg.modtap, "fused wideband step requires the modulated-taps chain"
    no_tf32()
    chan_fn = _channelizer(plan, oversample)
    b_loc = _bands_per_shard(mesh, n_bands)
    devs = mesh.band_devices
    shards = mesh.band_shards

    def step(chan_states, states, accs, ddc_states, x_pairs, now, keys, valid, level, keep, tables, keep_mask):
        results = []
        for i, dev in enumerate(devs):
            with on(dev):
                chan_state, local = _shard_channels(chan_fn, shards[i], b_loc, chan_states[i], x_pairs[i])
                state, acc, outs = _scan_channels(
                    cfg, group_size, top_k, b_loc, states[i], accs[i], local, now[i], keys[i], valid[i], level[i], keep
                )
                with record_function("ddc"):
                    ddc_state, rec = _ddc_block_banded(
                        ddc_cfg, _keep_slots(ddc_states[i], keep_mask[i]), local, tables[i]
                    )
            results.append((chan_state, state, acc, ddc_state, outs.packed, rec, local))
        return tuple(list(r) for r in zip(*results))

    return step


def make_sharded_banded_ddc(cfg: DdcConfig, mesh: Mesh, n_bands: int):
    """All channels' K-slot DDC in one step over the band shards; slot
    resets ride a keep mask (0 = zero that slot's carry before the block):
    (state[NB,..], channels[NB, n, 2] f32 pairs, tables[NB,..], keep[NB, K])
      -> (state, int8 [NB, K, out_per_block, 2]), per-shard lists."""
    assert cfg.modtap, "banded sharded DDC requires the modulated-taps chain"
    no_tf32()
    _bands_per_shard(mesh, n_bands)
    devs = mesh.band_devices

    def step(states, channels, tables, keep) -> Tuple[list, list]:
        out_states, recs = [], []
        for i, dev in enumerate(devs):
            with on(dev), record_function("ddc"):
                state, rec = _ddc_block_banded(cfg, _keep_slots(states[i], keep[i]), channels[i], tables[i])
            out_states.append(state)
            recs.append(rec)
        return out_states, recs

    return step


# -- time axis ------------------------------------------------------------------


def make_time_sharded_scan(cfg: ScanConfig, mesh: Mesh, group_size: int, top_k: int):
    """One band's detection frames split over the "time" axis, with the
    detector carries stitched across shard seams:
    - noise max-hold: the learning frames are a time prefix and max is
      associative, so the frozen threshold is the max over shards of each
      shard's learning max (``pmax``); readiness is time arithmetic on the
      frame times, the frame before each shard's first included
      (``prev_now``: -(2**30) before shard 0, int32);
    - averager ring: each shard takes its left neighbour's last grouping_y
      raw rows (``ppermute``), shard 0 the carried ring, so every boxcar
      window and the history vote's previous rows are exact at the seams;
      the outgoing ring and total are the last shard's;
    - detection runs on each shard's own frames: the PSD kernel (int8
      ingest) and the selection kernel once a shard.

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

    def step(state: ScanState, iq: torch.Tensor, now: torch.Tensor, keys, valid, level):
        noise_in = NoiseState(*(to(a, home) for a in state.noise))
        avg_in = AveragerState(*(to(a, home) for a in state.averager))
        now = to(now, home)
        prev_now = torch.cat(
            [torch.full((1,), -(2**30), dtype=torch.int32, device=home), now[f_loc - 1 :: f_loc][:-1]]
        )
        frames = [slice(t * f_loc, (t + 1) * f_loc) for t in range(n_time)]

        # -- the PSD and each shard's learning max -------------------------
        power, cond, was_ready, held = [], [], [], []
        for t, dev in enumerate(devs):
            with on(dev):
                with record_function("scan.psd"):
                    p = _frames_power(cfg, to(iq[frames[t]], dev)[None])[0]  # [f_loc, fft]
                start = to(noise_in.start_ms, dev)
                c = start + learn_ms <= to(now[frames[t]], dev)
                prev_c = start + learn_ms <= to(prev_now[t], dev)
                ready = to(noise_in.ready, dev) | torch.cat([prev_c[None], c[:-1]])
                held.append(torch.where((~ready)[:, None], p, -torch.inf).amax(dim=0))
            power.append(p)
            cond.append(c)
            was_ready.append(ready)
        threshold = [torch.maximum(to(noise_in.threshold, d), h) for d, h in zip(devs, pmax(held, devs))]
        ready_out = noise_in.ready | torch.stack([to(c[-1], home) for c in cond]).any()

        # -- noise-subtracted rows, and the averager halo --------------------
        raw = []
        for t, dev in enumerate(devs):
            with on(dev), record_function("scan.noise"):
                r = torch.where(was_ready[t][:, None], power[t] - threshold[t][None, :], NO_DATA)
                raw.append(r.to(torch.bfloat16) if cfg.power_bf16 else r)
        left = ppermute_right([r[-depth:] for r in raw], devs)
        left[0] = ordered_history(_band_axis(avg_in, add=True))[0]

        # -- averager, smoothing, detection on each shard's frames ------------
        bodies, spectros, rings, totals = [], [], [], []
        for t, dev in enumerate(devs):
            with on(dev):
                prev_rows = left[t]
                synth = AveragerState(
                    ring=prev_rows[None],
                    total=torch.zeros((1, cfg.fft_size), dtype=torch.float32, device=dev),
                    pos=torch.zeros((1,), dtype=torch.int32, device=dev),
                    frames=torch.clamp(to(avg_in.frames, dev) + t * f_loc, max=depth).to(torch.int32)[None],
                )
                with record_function("scan.averager"):
                    avg_state, means = averager_block(synth, raw[t][None])
                with record_function("scan.smoothing"):
                    avg_rows = sliding_average(means, cfg.grouping_x)
                with record_function("scan.detection"):
                    compact = compact_detection(
                        avg_rows, raw[t][None], prev_rows[-(half_depth - 1) :][None], to(keys, dev),
                        to(valid, dev), to(level, dev), group_size, top_k, bf16=cfg.detection_bf16,
                    )
                with record_function("scan.spectrogram"):
                    spectros.append(accumulate_frames(power[t], cfg.spectro_size))
                f32 = lambda a: a.to(torch.float32)
                bodies.append(torch.cat(
                    [f32(compact.cand_idx), compact.cand_val, f32(compact.cand_best),
                     f32(compact.cand_count)[..., None], compact.key_val, f32(compact.key_idx)],
                    dim=2,
                )[0])  # [f_loc, 3K+1+2S]
            rings.append(avg_state.ring[0])
            totals.append(avg_state.total[0])

        avg_out = AveragerState(
            ring=last(rings, home).to(avg_in.ring.dtype),
            total=last(totals, home),
            pos=torch.zeros_like(avg_in.pos),
            frames=torch.clamp(avg_in.frames + f_global, max=depth).to(torch.int32),
        )
        noise_out = NoiseState(threshold=threshold[0], ready=ready_out, start_ms=noise_in.start_ms)
        return ScanState(noise_out, avg_out), gather(bodies, home), psum(spectros, home), ready_out

    return step


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


def make_time_sharded_modtap_ddc(cfg: DdcConfig, mesh: Mesh):
    """Streaming time-sharded modulated-taps DDC with the serial step's
    signature: (state: Ddc2State, iq [block, 2] f32 pairs / int8 cs8 or
    [block] complex, tables: ModTables), single-band layouts ->
    (state, int8 [K, out_per_block, 2]), on ``mesh.device``.

    The same carry, tables, per-chunk phase stepping and products as the
    serial path (``models/ddc_pipeline._ddc_block``); only each chunk's
    samples are split over the time axis, the raw stage-1 tail and every
    later stage tail stitched by halo exchange (shard 0 takes the carried
    block-boundary tail, the last shard's tail becomes the next carry). The
    rotation tables are gathered per shard by global decimated index, so each
    output sample is the same product of the same f32 operands in the same
    order: coarse entry times phase, then the fine entry."""
    devs = mesh.time_devices
    home = mesh.device
    n_time = len(devs)
    if not time_sharded_modtap_fits(cfg, n_time):
        raise ValueError("geometry cannot be time-sharded exactly; check time_sharded_modtap_fits")
    no_tf32()
    p0 = cfg.plans[0]
    k = cfg.num_slots
    chunk_loc = cfg.chunk // n_time
    out1_loc = cfg.chunk // p0.decim // n_time
    q_val = _nco_q(cfg.chunk // p0.decim)

    def step(state: Ddc2State, iq: torch.Tensor, tables):
        x = iq.reshape(cfg.num_chunks, cfg.chunk, *iq.shape[1:])
        rot = tables.rot
        consts = []
        for t, dev in enumerate(devs):
            g = t * out1_loc + torch.arange(out1_loc, device=dev)
            c_re, c_im, f_re, f_im = (to(a, dev) for a in rot[:4])
            consts.append((
                to(tables.w, dev)[None],
                c_re[:, g // q_val], c_im[:, g // q_val], f_re[:, g % q_val], f_im[:, g % q_val],
            ))
        ph, x_tail, tails = to(state.phase, home), to(state.x_tail, home), [to(a, home) for a in state.tails]
        outs = []
        for c in range(cfg.num_chunks):
            xs = []
            for t, dev in enumerate(devs):
                with on(dev):
                    xs.append(torch.stack(_components(to(x[c, t * chunk_loc : (t + 1) * chunk_loc], dev)), dim=0))
            lefts = halo_from_left(xs, p0.tail_len, devs)
            lefts[0] = x_tail
            ys, local_tails = [], []
            for t, dev in enumerate(devs):
                with on(dev):
                    w, cre_s, cim_s, fre_s, fim_s = consts[t]
                    y_re, y_im, local = _modtap_stage1(xs[t][None], lefts[t][None], w, p0, k)
                    y_re, y_im = y_re[0], y_im[0]  # [K, out1_loc]
                    p = to(ph, dev)
                    ph_re, ph_im = torch.cos(p)[:, None], torch.sin(p)[:, None]
                    cre = ph_re * cre_s - ph_im * cim_s
                    cim = ph_re * cim_s + ph_im * cre_s
                    rot_re = cre * fre_s - cim * fim_s
                    rot_im = cre * fim_s + cim * fre_s
                    ys.append(torch.stack([y_re * rot_re - y_im * rot_im, y_re * rot_im + y_im * rot_re], dim=1))
                local_tails.append(local[0])
            x_tail = last(local_tails, home)
            for s, plan in enumerate(cfg.plans[1:]):
                lefts = halo_from_left(ys, plan.tail_len, devs)
                lefts[0] = to(tails[s], devs[0])
                locals_ = []
                for t, dev in enumerate(devs):
                    with on(dev):
                        ys[t], local = _stage_apply(ys[t], lefts[t], plan)
                    locals_.append(local)
                tails[s] = last(locals_, home)
            chunk_out = []
            for t, dev in enumerate(devs):
                with on(dev):
                    chunk_out.append(torch.clamp(torch.round(torch.movedim(ys[t], 1, 2) * 127.0), -128, 127).to(torch.int8))
            outs.append(gather(chunk_out, home, dim=1))
            ph = torch.remainder(ph + to(rot.step, home), 2.0 * math.pi)
        return Ddc2State(phase=ph, x_tail=x_tail, tails=tuple(tails)), torch.cat(outs, dim=1)

    return step


def make_time_sharded_ddc(cfg: DdcConfig, mesh: Mesh):
    """One band's block time-sharded over the "time" axis, K slots batched
    (the v1 chain): (iq [n_global] complex / [n_global, 2] pairs, tables)
    -> int8 [K, out_global, 2] on ``mesh.device``. ``tables`` are built for
    the GLOBAL chunk length (``ops/ddc.make_nco_tables(shifts, rate,
    n_global)``), so each shard takes its own slice of the coarse angles
    exactly; the stage tails come from the left neighbour (zeros on shard 0,
    a stream start)."""
    devs = mesh.time_devices
    home = mesh.device
    n_time = len(devs)
    no_tf32()

    def step(iq: torch.Tensor, tables: NcoTables) -> torch.Tensor:
        x_re, x_im = _components(iq)
        n_loc = x_re.shape[-1] // n_time
        nq_loc = tables.coarse_re.shape[-1] // n_time
        ys = []
        for t, dev in enumerate(devs):
            with on(dev):
                coarse = slice(t * nq_loc, (t + 1) * nq_loc)
                rt = NcoTables(
                    to(tables.coarse_re[:, coarse], dev), to(tables.coarse_im[:, coarse], dev),
                    to(tables.fine_re, dev), to(tables.fine_im, dev), to(tables.step, dev),
                )
                rot_re, rot_im = _rotation(torch.zeros_like(rt.step), rt, n_loc)
                re = to(x_re[t * n_loc : (t + 1) * n_loc], dev)
                im = to(x_im[t * n_loc : (t + 1) * n_loc], dev)
                ys.append(torch.stack([re * rot_re - im * rot_im, re * rot_im + im * rot_re], dim=1))
        ys = resample_chain_sharded(ys, cfg.plans, devs)
        outs = []
        for t, dev in enumerate(devs):
            with on(dev):
                outs.append(torch.clamp(torch.round(torch.movedim(ys[t], 1, 2) * 127.0), -128, 127).to(torch.int8))
        return gather(outs, home, dim=1)

    return step


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
