"""The card's published peaks (NVIDIA data sheets, dense rates) by card
name, and the card's power limit (copied from
yogo_tpu_torch/tools/timing.py, with the bf16 tensor-core rate added).
A rate is stated against these peaks with the power limit beside it: a card
set below its 700 W runs slower under load."""

from __future__ import annotations

import subprocess

# device-memory rate, bytes/s
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12, "H100": 3.35e12}
# dense int8 tensor-core rate, operations/s
INT8_RATE = {"H100 PCIe": 1513e12, "H100 NVL": 1671e12, "H200": 1979e12, "H100": 1979e12}
# dense bf16 tensor-core rate, FLOP/s
BF16_RATE = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H200": 989e12, "H100": 989e12}


def rate(table: dict, name: str):
    """The rate of `table` for the card called `name` (the first key it
    contains); None for a card the table does not know."""
    for key, value in table.items():
        if key in name:
            return value
    return None


def power_limit_w():
    """The first card's power limit in watts, from nvidia-smi; None where
    it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
