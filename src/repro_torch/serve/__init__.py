"""``repro_torch.serve`` — continuous-batching inference on the port.

    from repro_torch.serve import Request, ServeEngine, loader

    model = loader.init_params(cfg, seed=0)
    engine = ServeEngine(cfg, model, slots=8, max_len=512)
    fut = engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=16))
    engine.run_until_idle()
    fut.result().tokens
"""

from repro_torch.serve import loader
from repro_torch.serve.cache import PagedCachePool, PoolExhausted
from repro_torch.serve.engine import GenerationResult, Request, ServeEngine
from repro_torch.serve.sampling import GREEDY, SamplingParams, sample_logits

__all__ = ["GREEDY", "GenerationResult", "PagedCachePool", "PoolExhausted",
           "Request", "SamplingParams", "ServeEngine", "loader",
           "sample_logits"]
