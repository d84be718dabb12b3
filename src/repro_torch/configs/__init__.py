"""Architecture registry: ``get_config(name)``, ``all_arch_names()`` (the
architectures the reference has too: their configs are data, the same as
the reference's) and ``port_only_arch_names()`` (those only the port runs,
``PortArchConfig``).  ``repro_torch.models`` serves every one of them."""

from repro_torch.configs.base import (ArchConfig, Mamba2Config, MLAConfig,
                                      MoEConfig, PortArchConfig)


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
_PORT_ONLY = None


def _port_only():
    global _PORT_ONLY
    if _PORT_ONLY is None:
        from repro_torch.configs.granite_4_0_h_micro import CONFIG
        _PORT_ONLY = {CONFIG.name: CONFIG}
    return _PORT_ONLY


def get_config(name: str) -> ArchConfig:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    known = {**_REGISTRY, **_port_only()}
    if name not in known:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(known)}")
    return known[name]


def all_arch_names():
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    return sorted(_REGISTRY)


def port_only_arch_names():
    """The architectures only the port runs: not in ``all_arch_names``,
    which the parity tests pair name by name with the reference's."""
    return sorted(_port_only())


__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "Mamba2Config",
           "PortArchConfig", "get_config", "all_arch_names",
           "port_only_arch_names"]
