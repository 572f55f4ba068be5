"""Halo exchange and the time-sharded v1 DDC of the port against the JAX
package's, on a mesh of copies of the CPU device (JAX: conftest's virtual
CPU devices).

- ``resample_chain_sharded`` with n = 4 on the 1.024 Msps -> 16 kHz chain
  (``tests/test_parallel.py:61-94``'s geometry): against the JAX function
  run under ``shard_map`` on the same [K, 2, n] f32 stream, within the FIR
  kernel's bar (2e-5 of max |y|, ``tests/test_pallas_fir.py``), and against
  the port's own single-device streaming chain over the concatenated
  stream;
- ``make_time_sharded_ddc`` (n = 4) against the port's serial streaming
  chain (``ddc_chunk`` a shard's length at a time) and against the JAX
  time-sharded DDC: <= 1 LSB, under 2% of samples off (the reference's
  bar);
- ``halo_from_left``: zeros on shard 0, the left neighbour's tail elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rtl_sdr_scanner_tpu.models import ddc_pipeline as jdp
from rtl_sdr_scanner_tpu.ops import ddc as jddc
from rtl_sdr_scanner_tpu.parallel import halo as jhalo
from rtl_sdr_scanner_tpu.parallel import mesh as jmesh
from rtl_sdr_scanner_tpu.parallel import sharded_scan as jss
from rtl_sdr_scanner_tpu_torch.models import ddc_pipeline as tdp
from rtl_sdr_scanner_tpu_torch.ops import ddc as tddc
from rtl_sdr_scanner_tpu_torch.parallel import halo as thalo
from rtl_sdr_scanner_tpu_torch.parallel import mesh as tmesh
from rtl_sdr_scanner_tpu_torch.parallel import sharded_scan as tss

torch.set_num_threads(2)
N_TIME = 4
CPUS = [torch.device("cpu")] * N_TIME


def _cfg(pkg):
    mod = jdp if pkg == "jax" else tdp
    return mod.DdcConfig.create(sample_rate=1024000, bandwidth=16000, num_slots=2, block_samples=4096 * 4 * N_TIME)


def test_halo_from_left():
    xs = [torch.arange(10.0).reshape(1, 2, 5) + 100 * s for s in range(N_TIME)]
    left = thalo.halo_from_left(xs, 3, CPUS)
    assert torch.equal(left[0], torch.zeros(1, 2, 3))
    for s in range(1, N_TIME):
        assert torch.equal(left[s], xs[s - 1][..., -3:]) and left[s].is_contiguous()


def test_resample_chain_sharded_matches_jax_and_streaming():
    cfg, jcfg = _cfg("torch"), _cfg("jax")
    n = cfg.block_samples
    x = np.random.default_rng(4).standard_normal((2, 2, n)).astype(np.float32) * 0.3
    n_loc = n // N_TIME

    got = thalo.resample_chain_sharded(
        [torch.from_numpy(x[..., s * n_loc : (s + 1) * n_loc]) for s in range(N_TIME)], cfg.plans, CPUS
    )
    got = torch.cat(got, dim=-1).numpy()

    mesh = jmesh.make_mesh(n_bands=1, n_time=N_TIME)
    fn = jax.shard_map(
        lambda xs: jhalo.resample_chain_sharded(xs, jcfg.plans, jmesh.TIME_AXIS),
        mesh=mesh, in_specs=P(None, None, jmesh.TIME_AXIS), out_specs=P(None, None, jmesh.TIME_AXIS),
        check_vma=False,
    )
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2, cfg.out_per_block)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-5 * scale

    # the port's single-device chain over the whole stream, from zero tails
    y = torch.from_numpy(x)
    for plan in cfg.plans:
        y, _ = tddc._stage_apply(y, torch.zeros((2, 2, plan.tail_len)), plan)
    assert np.abs(got - y.numpy()).max() <= 2e-5 * scale


@pytest.mark.parametrize("fmt", ["complex", "pairs"])
def test_time_sharded_ddc_matches_streaming_and_jax(fmt):
    cfg, jcfg = _cfg("torch"), _cfg("jax")
    n_global = cfg.block_samples
    rng = np.random.default_rng(4)
    iq = (rng.standard_normal(n_global) + 1j * rng.standard_normal(n_global)).astype(np.complex64) * 0.3
    shifts = np.array([100000, -50000])

    # global tables: one "chunk" spanning the whole sharded block
    tables = tddc.make_nco_tables(shifts, cfg.sample_rate, n_global, torch.device("cpu"))
    x = torch.from_numpy(iq) if fmt == "complex" else torch.from_numpy(iq.view(np.float32).reshape(-1, 2))
    sharded = tss.make_time_sharded_ddc(cfg, tmesh.make_mesh(1, N_TIME, devices=CPUS))
    got = sharded(x, tables).numpy().astype(np.int32)  # [K, out, 2]

    # the port's single-device streaming chain over the same stream
    state = tddc.init_ddc_state(cfg.plans, 2, torch.device("cpu"))
    chunk = n_global // N_TIME
    chunk_tables = tddc.make_nco_tables(shifts, cfg.sample_rate, chunk, torch.device("cpu"))
    outs = []
    for b in range(N_TIME):
        state, out = tddc.ddc_chunk(torch.from_numpy(iq[b * chunk : (b + 1) * chunk]), state, chunk_tables, cfg.plans)
        outs.append(out.numpy())
    ref = np.concatenate(outs, axis=1).astype(np.int32)

    jsharded = jss.make_time_sharded_ddc(jcfg, jmesh.make_mesh(n_bands=1, n_time=N_TIME))
    jgot = np.asarray(jsharded(jnp.asarray(iq), jddc.make_nco_tables(shifts, cfg.sample_rate, n_global)))

    for other in (ref, jgot.astype(np.int32)):
        assert got.shape == other.shape
        diff = np.abs(got - other)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    assert np.abs(got).max() > 10
