"""IQ sample quantization on the device (port of the JAX package's
``ops/quantize.py``).

gr::blocks::complex_to_interleaved_char(scale=127) of the reference's
recorder chain (sources/radio/recorder.cpp:36): complex float ->
interleaved int8 with round (half to even) and saturation. The wire
format's XOR 0x80 (offset binary) stays in the host codec
(``runtime/data_controller.py``), as in the reference
(network/data_controller.cpp:38-40).
"""

from __future__ import annotations

import torch


def complex_to_interleaved_int8(x: torch.Tensor, scale: float = 127.0) -> torch.Tensor:
    """[..., n] complex64 -> [..., n, 2] int8 (I then Q), rounded + saturated."""
    stacked = torch.stack([x.real, x.imag], dim=-1) * scale
    return torch.clamp(torch.round(stacked), -128, 127).to(torch.int8)


__all__ = ["complex_to_interleaved_int8"]
