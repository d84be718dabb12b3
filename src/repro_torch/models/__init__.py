"""Model substrate of the port: the dense GQA family, serving part."""

from repro_torch.models.model import (compute_params, count_params,
                                      decode_step, init_cache, init_params,
                                      prefill)

__all__ = ["compute_params", "count_params", "decode_step", "init_cache",
           "init_params", "prefill"]
