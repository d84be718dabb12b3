"""Model substrate of the port: layer planning, the training loss,
prefill and decode."""

from repro_torch.models.model import (compute_params, count_params,
                                      decode_step, full_logits, init_cache,
                                      init_params, loss_fn, prefill)

__all__ = ["compute_params", "count_params", "decode_step", "full_logits",
           "init_cache", "init_params", "loss_fn", "prefill"]
