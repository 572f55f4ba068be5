"""``dryrun_multichip`` (``rtl_sdr_scanner_tpu_torch/dryrun.py``), the
port's counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
on 2 copies of the CPU device: the bands-axis scan step, the time-sharded
DDC, the runtime's bands and time meshes and the production-geometry mesh
step (fft 131072) run and check their shapes. ``chip_smoke.py`` runs it on
4 copies of the card."""

import torch

from rtl_sdr_scanner_tpu_torch import dryrun
from rtl_sdr_scanner_tpu_torch.runtime import sdr_device

torch.set_num_threads(2)


def test_dryrun_multichip_on_two_cpu_copies(capsys):
    real = (sdr_device.visible_cards, sdr_device.mesh_devices)
    line = dryrun.dryrun_multichip(2, device="cpu")
    assert line in capsys.readouterr().out
    assert line.startswith("dryrun_multichip OK: 2 copies of cpu, mesh bands=1 time=2")
    assert "production mesh 2x1 (bands x time): bands-axis scan fft 131072" in line
    # the runtime phases give their sessions the copies (cards=) and leave
    # the module's device resolution alone
    assert (sdr_device.visible_cards, sdr_device.mesh_devices) == real
