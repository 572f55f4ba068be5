"""The port's host planners give arrays exactly equal to the JAX package's:
windows, resampler chains, the modulated-tap gather index, NCO tables and
modulated-tap tables (w within 0 ulp), and the derived configs."""

import dataclasses

import numpy as np
import pytest
import torch

from rtl_sdr_scanner_tpu.constants import Tunables as JaxTunables
from rtl_sdr_scanner_tpu.models import ddc_pipeline as jdp
from rtl_sdr_scanner_tpu.models import scan_pipeline as jsp
from rtl_sdr_scanner_tpu.ops import ddc as jddc
from rtl_sdr_scanner_tpu.ops import window as jwin
from rtl_sdr_scanner_tpu.utils import radio_utils as jru
from rtl_sdr_scanner_tpu_torch.constants import Tunables
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
from rtl_sdr_scanner_tpu_torch.models import scan_pipeline as tsp
from rtl_sdr_scanner_tpu_torch.ops import ddc as tddc
from rtl_sdr_scanner_tpu_torch.ops import window as twin
from rtl_sdr_scanner_tpu_torch.utils import radio_utils as tru

torch.set_num_threads(2)
CPU = torch.device("cpu")

GEOMETRIES = [(256_000, 16_000), (2_048_000, 16_000), (20_480_000, 16_000), (2_048_000, 64_000)]


@pytest.mark.parametrize("n", [1, 2, 1024, 8192, 131072])
def test_windows_equal(n):
    np.testing.assert_array_equal(twin.hamming(n), jwin.hamming(n))
    np.testing.assert_array_equal(twin.kaiser(n, 7.0), jwin.kaiser(n, 7.0))


@pytest.mark.parametrize("rate,bw", GEOMETRIES)
def test_radio_utils_equal(rate, bw):
    assert tru.get_fft(rate, 250) == jru.get_fft(rate, 250)
    assert tru.get_resamplers_factors(rate, bw, 125) == jru.get_resamplers_factors(rate, bw, 125)


@pytest.mark.parametrize("rate,bw", GEOMETRIES)
def test_plan_chain_equal(rate, bw):
    want = jddc.plan_chain(rate, bw)
    got = tddc.plan_chain(rate, bw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # chunk_w is the JAX package's chunked-matmul stage weight; the port
        # sends every decimation-only stage through its FIR kernel instead
        assert set(w._fields) - set(g._fields) == {"chunk_w"}
        for name in g._fields:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name
    assert tddc.chain_block_multiple(got) == jddc.chain_block_multiple(want)


@pytest.mark.parametrize("rate,bw", GEOMETRIES[:3])
def test_modtap_scatter_index_equal(rate, bw):
    p0 = jddc.plan_chain(rate, bw)[0]
    args = (p0.decim, p0.poly_rows, p0.tail_len, p0.chunk_c, p0.chunk_d, p0.chunk_q)
    np.testing.assert_array_equal(tddc._modtap_scatter_index(*args), jddc._modtap_scatter_index(*args))


def test_nco_tables_equal():
    shifts = np.array([250_000, -771_300, 3, 1_023_999], dtype=np.int64)
    want = jddc.make_nco_tables(shifts, 2_048_000, 1 << 15)
    got = tddc.make_nco_tables(shifts, 2_048_000, 1 << 15, CPU)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("rate,block", [(256_000, 51_200), (2_048_000, 409_600), (20_480_000, 17_694_720)])
def test_mod_tables_equal(rate, block):
    """w within 0 ulp: both gather the same f32 tap vectors; banded [NB, K]
    shifts give the stack of per-band tables."""
    cfg = jdp.DdcConfig.create(rate, 16_000, 2, block)
    shifts = np.array([[30_000, -50_000], [rate // 3, -rate // 5]], dtype=np.int64)
    got = tdp.make_tables(tdp.DdcConfig.create(rate, 16_000, 2, block), shifts, device="cpu")
    for band in range(2):
        want = jdp.make_tables(cfg, shifts[band])
        np.testing.assert_array_equal(got.w[band].numpy(), np.asarray(want.w))
        for name in want.rot._fields:
            np.testing.assert_array_equal(
                getattr(got.rot, name)[band].numpy(), np.asarray(getattr(want.rot, name))
            )


@pytest.mark.parametrize("rate,frames", [(256_000, 10), (2_048_000, 10), (20_480_000, 45)])
def test_configs_equal(rate, frames):
    for bf16, power in ((False, False), (True, False), (False, True), (True, True)):
        want = jsp.ScanConfig.create(
            rate, frames, JaxTunables(detection_bf16=bf16, power_bf16=power, use_pallas_select=True))
        got = tsp.ScanConfig.create(rate, frames, Tunables(detection_bf16=bf16, power_bf16=power))
        want_fields = dataclasses.asdict(want)
        assert want_fields["power_bf16"] == (bf16 and power)  # only with detection_bf16
        # the port has no kernel switches: its wrappers choose by device
        want_fields.pop("use_pallas_psd")
        want_fields.pop("use_pallas_select")
        assert dataclasses.asdict(got) == want_fields
    block = want.block_samples
    jd = jdp.DdcConfig.create(rate, 16_000, 2, block)
    td = tdp.DdcConfig.create(rate, 16_000, 2, block)
    assert (td.chunk, td.num_chunks, td.out_per_block, td.modtap) == (
        jd.chunk, jd.num_chunks, jd.out_per_block, jd.modtap
    )


def test_headline_geometry():
    """The main path's geometry: 20.48 Msps at F=45, 2 recorder slots at 16 kHz."""
    cfg = tsp.ScanConfig.create(20_480_000, 45)
    assert (cfg.fft_size, cfg.decimator_factor, cfg.spectro_size) == (131072, 3, 16384)
    assert cfg.detection_bf16
    ddc = tdp.DdcConfig.create(20_480_000, 16_000, 2, cfg.block_samples)
    assert [(p.decim, p.chunk_c, p.chunk_d) for p in ddc.plans] == [(32, 2048, 2), (40, 2560, 2)]
    assert (ddc.chunk, ddc.num_chunks, ddc.out_per_block, ddc.modtap) == (1_105_920, 16, 13_824, True)


def test_rtl_sdr_recorder_geometry():
    """The v1 path's deployment: an RTL-SDR at 2.4 Msps recording at the
    reference's default 32 kHz. The runtime grows 16 frames to 75 so the
    block divides the chain; the single stage (1, 75) has no chunked form,
    so the DDC runs v1; group 219 > 127 takes the wide-window vote."""
    cfg = tsp.ScanConfig.create(2_400_000, 75)
    assert (cfg.fft_size, cfg.decimator_factor, cfg.block_samples) == (16384, 2, 2_457_600)
    ddc = tdp.DdcConfig.create(2_400_000, 32_000, 2, cfg.block_samples)
    assert [(p.interp, p.decim, p.ntaps, p.poly_rows, p.chunk_c) for p in ddc.plans] == [(1, 75, 2463, 34, 0)]
    assert (ddc.chunk, ddc.num_chunks, ddc.out_per_block, ddc.modtap) == (1_228_800, 2, 32_768, False)
    assert int(np.ceil(32000 / cfg.step_hz)) == 219
    jd = jdp.DdcConfig.create(2_400_000, 32_000, 2, cfg.block_samples)
    assert (jd.chunk, jd.num_chunks, jd.modtap) == (ddc.chunk, ddc.num_chunks, ddc.modtap)
