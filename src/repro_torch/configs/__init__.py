"""Assigned-architecture registry: ``get_config(name)`` /
``all_arch_names()``.  The configs are data, the same as the reference's;
``repro_torch.models`` serves the dense GQA family of them."""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig


def _load():
    from repro_torch.configs import (  # noqa: F401
        xlstm_125m, recurrentgemma_2b, olmoe_1b_7b, deepseek_v3_671b,
        qwen2_vl_7b, qwen1_5_32b, gemma2_27b, gemma_7b, phi4_mini_3_8b,
        whisper_tiny,
    )
    return {
        m.CONFIG.name: m.CONFIG
        for m in (xlstm_125m, recurrentgemma_2b, olmoe_1b_7b,
                  deepseek_v3_671b, qwen2_vl_7b, qwen1_5_32b, gemma2_27b,
                  gemma_7b, phi4_mini_3_8b, whisper_tiny)
    }


_REGISTRY = None


def get_config(name: str) -> ArchConfig:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_arch_names():
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    return sorted(_REGISTRY)


__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "get_config", "all_arch_names"]
