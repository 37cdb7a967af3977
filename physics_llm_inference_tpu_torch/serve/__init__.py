"""Serving engines (counterpart: physics_llm_inference_tpu/serve)."""
