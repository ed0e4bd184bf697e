"""The thermal noise floor (counterpart of ``tpudes/ops/interference.py``).

The BSS engine and the fused PHY window (``parallel/kernels.py``) take
only the noise floor from the reference module; its chunked-interference
kernel (``frame_success_rate``) serves the host paths (ROADMAP A16).
"""

from __future__ import annotations

#: J/K (``tpudes/ops/interference.py:23``)
BOLTZMANN = 1.380649e-23


def thermal_noise_w(bandwidth_hz, noise_figure_db=7.0, temperature_k=290.0):
    """Noise floor in watts, F k T B (``tpudes/ops/interference.py:26``),
    in Python floats."""
    nt = BOLTZMANN * temperature_k * bandwidth_hz
    return 10.0 ** (noise_figure_db / 10.0) * nt
