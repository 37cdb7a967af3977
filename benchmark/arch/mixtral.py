"""Mixtral (`model_type` "mixtral"): the Mistral-shaped decoder with its
FFN routed over `num_local_experts`, which arch/mistral.py already
covers."""
from benchmark.arch.mistral import (Work, logits, model_config,  # noqa: F401
                                    program_params, weight_bytes, weights)
