"""Completion barrier for timers (counterpart of
``ecckd_tpu.utils.profiling.barrier_fetch``).

PyTorch returns from a CUDA call before the card has run it, so a host
timer around device work must end with a barrier: ``barrier`` waits for
all work queued on the CUDA devices that the given tensors live on.  On
CPU tensors the work is already done and it returns at once.  Device
traces and throughput metrics are not ported yet (ROADMAP P8).
"""
from __future__ import annotations

import torch


def barrier(*tensors: torch.Tensor) -> None:
    """Wait until the CUDA work on every device of ``tensors`` is done."""
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
