"""``rtl_sdr_scanner_tpu_torch/drivers.py``, the block-step drivers the
benchmark and ``chip_smoke.py`` build their steps from, driven on the CPU
through the plain versions at a shrunken geometry (256 kHz: fft 1024, decim
5, 10 frames, 2 bands, 2 slots a band), several blocks each with the state
carried: the banded fused step (modulated taps, and a v1 chain with an
interpolating stage), the wideband step fused and split, and the kernel
registry the drivers count launches with."""

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu_torch import drivers
from rtl_sdr_scanner_tpu_torch.models.ddc_pipeline import DdcConfig
from rtl_sdr_scanner_tpu_torch.models.scan_pipeline import K_SEP, ScanConfig
from rtl_sdr_scanner_tpu_torch.ops import cuda
from rtl_sdr_scanner_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)
RATE, FRAMES, BANDS, SLOTS, TOP_K, BLOCKS = 256_000, 10, 2, 2, 64, 3
KERNELS = ("psd_frames_int8", "fused_selection", "history_vote", "stage_apply_fir", "analysis_bank", "modtap_stage1")


def _configs(bandwidth: int):
    cfg = ScanConfig.create(RATE, FRAMES)
    ddc_cfg = DdcConfig.create(RATE, bandwidth, SLOTS, cfg.block_samples)
    return cfg, ddc_cfg, int(np.ceil(bandwidth / cfg.step_hz))


def _shifts(rng, bands: int) -> np.ndarray:
    return rng.integers(-RATE // 2, RATE // 2, size=(bands, SLOTS))


def _zero_launches() -> dict:
    wrappers = drivers.kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def _packed_len(cfg) -> int:
    return cfg.frames_per_block * (3 * (TOP_K + K_SEP) + 1 + 2 * drivers.KEY_SLOTS) + 1


@pytest.mark.parametrize("bandwidth,modtap", [(16_000, True), (12_000, False)], ids=["modtap", "v1"])
def test_banded_blocks_run_on_the_cpu(bandwidth, modtap):
    """BandedBlocks over 3 blocks of seeded int8: the packed rows and the
    int8 recordings of every band and slot at their shapes, one signature
    for every block (the state carried in the step's own buffers), no kernel
    launch counted (a CPU tensor never reaches a kernel)."""
    cfg, ddc_cfg, group_size = _configs(bandwidth)
    assert ddc_cfg.modtap == modtap
    assert modtap or ddc_cfg.plans[0].interp > 1
    rng = np.random.default_rng(0)
    steps = drivers.BandedBlocks(cfg, ddc_cfg, group_size, TOP_K, BANDS, _shifts(rng, BANDS), "cpu")
    wrappers = _zero_launches()
    group = cfg.fft_size * cfg.decimator_factor
    for b in range(BLOCKS):
        iq = torch.from_numpy(rng.integers(-32, 32, size=(BANDS, FRAMES, group, 2), dtype=np.int8))
        outs = steps.run_block(b, iq)
        assert outs.packed.shape == (BANDS, _packed_len(cfg)) and outs.packed.dtype == torch.float32
        assert bool(torch.isfinite(outs.packed).all())
        assert outs.recording.shape == (BANDS, SLOTS, ddc_cfg.out_per_block, 2)
        assert outs.recording.dtype == torch.int8 and bool(outs.recording.any())
    assert steps.step.captures == 1
    assert {name: fn.launches for name, fn in wrappers.items()} == dict.fromkeys(KERNELS, 0)


def _wideband_runs(fused: bool) -> list:
    """(packed, recording) of each of 3 blocks through WidebandBlocks at 2
    channels, each concatenated over the one-card mesh's shards."""
    cfg, ddc_cfg, group_size = _configs(16_000)
    rng = np.random.default_rng(1)
    mesh = make_mesh(1, 1, devices=["cpu"])
    steps = drivers.WidebandBlocks(cfg, ddc_cfg, group_size, TOP_K, BANDS, _shifts(rng, BANDS), fused, mesh, "cpu")
    runs = []
    for b in range(BLOCKS):
        x = torch.from_numpy(rng.integers(-32, 32, size=(BANDS * cfg.block_samples, 2), dtype=np.int8))
        packed, rec = steps.run_block(b, x)
        runs.append((torch.cat(packed), torch.cat(rec)))
    return runs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_wideband_blocks_run_on_the_cpu(fused):
    """WidebandBlocks at 2 channels of the shrunken geometry, in one dispatch
    or two: packed rows and recordings of both channels at their shapes, no
    kernel launch counted."""
    cfg, ddc_cfg, _ = _configs(16_000)
    wrappers = _zero_launches()
    for packed, rec in _wideband_runs(fused):
        assert packed.shape == (BANDS, _packed_len(cfg)) and bool(torch.isfinite(packed).all())
        assert rec.shape == (BANDS, SLOTS, ddc_cfg.out_per_block, 2) and rec.dtype == torch.int8
    assert {name: fn.launches for name, fn in wrappers.items()} == dict.fromkeys(KERNELS, 0)


def test_wideband_fused_equals_split():
    """The fused and the split wideband step give equal packed rows and equal
    recordings, block by block."""
    for b, (fused, split) in enumerate(zip(_wideband_runs(True), _wideband_runs(False))):
        for got, want in zip(fused, split):
            assert torch.equal(got, want), f"block {b}"


def test_kernel_wrappers_name_the_hand_kernels():
    """The registry lives beside the wrappers (``ops.cuda``, under the graph
    layer that counts launches); ``drivers.kernel_wrappers`` is the same
    function, and each wrapper counts its launches in an integer."""
    assert drivers.kernel_wrappers is cuda.kernel_wrappers
    wrappers = cuda.kernel_wrappers()
    assert tuple(wrappers) == KERNELS
    for fn in wrappers.values():
        assert callable(fn) and isinstance(fn.launches, int)
