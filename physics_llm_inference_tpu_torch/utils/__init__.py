"""Timing (counterpart: physics_llm_inference_tpu/utils)."""
