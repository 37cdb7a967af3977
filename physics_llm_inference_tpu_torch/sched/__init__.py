"""Request scheduling (counterpart: physics_llm_inference_tpu/sched)."""
