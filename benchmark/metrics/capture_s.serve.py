"""capture_s.serve: the seconds the program's CUDA-graph captures took in
the serving run (runtime/step_cache.capture_s), read at the run's end."""


def read(run):
    if "requests" not in run.state:
        return None
    try:
        from physics_llm_inference_tpu_torch.runtime import step_cache
    except ImportError:
        return None
    return getattr(step_cache, "capture_s", None)
