"""Architecture registry: ``get("<arch-id>")`` -> ArchConfig.

The dense decoders (gemma3-1b, gemma3-4b, minitron-4b, qwen2-72b),
qwen2-vl-72b's backbone, the two Mixture-of-Experts decoders
(qwen3-moe-235b-a22b, kimi-k2-1t-a32b), the recurrent families
(zamba2-1.2b, xlstm-1.3b) and the encoder-decoder whisper-base's backbone:
all ten of the reference's architectures.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "gemma3-1b",
    "qwen2-72b",
    "gemma3-4b",
    "minitron-4b",
    "qwen2-vl-72b",
    "qwen3-moe-235b-a22b",
    "kimi-k2-1t-a32b",
    "zamba2-1.2b",
    "xlstm-1.3b",
    "whisper-base",
)


def get(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
