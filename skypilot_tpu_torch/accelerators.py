"""Peak rates of the NVIDIA cards the port runs on.

Dense bf16 tensor-core peak (FLOP/s) and device-memory bandwidth (B/s) by
card, from NVIDIA's data sheets (dense rates, no sparsity, at the card's
full power limit). Matched by substring against the card's name as
``torch.cuda.get_device_name`` or ``nvidia-smi`` gives it, most specific
first. ``train/run.py`` reports MFU against this table and
``chip_smoke.py`` computes kernel bounds from it. (The TPU generations of
``skypilot_tpu/accelerators.py`` are not the port's hardware.)
"""
from __future__ import annotations

from typing import Optional, Tuple

CARD_PEAKS = (  # (name key, bf16 FLOP/s, bytes/s)
    ('H100 PCIe', 756e12, 2.0e12),
    ('H100 NVL', 835e12, 3.9e12),
    ('H200', 989e12, 4.8e12),
    ('H100', 989e12, 3.35e12),
)


def card_peaks(name: str) -> Tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the card called ``name``; raises for a
    card not in the table."""
    for key, flops, bw in CARD_PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f'no peak rates known for card {name!r}')


def peak_bf16_flops(device) -> Optional[float]:
    """The bf16 peak of a torch device, or None off the GPU or for a card
    not in the table (MFU is then not reported)."""
    import torch
    dev = torch.device(device)
    if dev.type != 'cuda':
        return None
    try:
        return card_peaks(torch.cuda.get_device_name(dev))[0]
    except RuntimeError:
        return None
