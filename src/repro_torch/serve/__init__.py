from repro_torch.serve.engine import (
    Engine,
    Request,
    ServeError,
    WFQScheduler,
    prompt_bucket,
    sample,
)

__all__ = ["Engine", "Request", "ServeError", "WFQScheduler",
           "prompt_bucket", "sample"]
