"""capture_s.offline: the seconds the program's CUDA-graph captures took in
the run (runtime/step_cache.capture_s: each CapturedStep's warm-up and
capture between two synchronizations), read at the run's end."""


def read(run):
    if "batches" not in run.state:
        return None
    try:
        from physics_llm_inference_tpu_torch.runtime import step_cache
    except ImportError:
        return None
    return getattr(step_cache, "capture_s", None)
