"""``repro_torch.serve`` — continuous-batching inference on the port.

    from repro_torch.serve import Request, ServeEngine, loader

    model = loader.init_params(cfg, seed=0)
    engine = ServeEngine(cfg, model, slots=8, max_len=512)
    fut = engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=16))
    engine.run_until_idle()
    fut.result().tokens

See :mod:`repro_torch.serve.engine` for the tick loop and the request
lifecycle, :mod:`repro_torch.serve.graphs` for the CUDA graphs that replay
its ticks, and :mod:`repro_torch.serve.faults` for fault injection.
"""

from repro_torch.serve import faults, loader
from repro_torch.serve.cache import PagedCachePool, PoolExhausted
from repro_torch.serve.engine import (DeadlineExceeded, GenerationResult,
                                      QueueFull, Request, RequestCancelled,
                                      ServeEngine)
from repro_torch.serve.faults import FaultInjector, InjectedFault
from repro_torch.serve.graphs import GraphCache
from repro_torch.serve.metrics import EngineMetrics, RequestMetrics
from repro_torch.serve.sampling import GREEDY, SamplingParams, sample_logits

__all__ = ["DeadlineExceeded", "EngineMetrics", "FaultInjector", "GREEDY",
           "GenerationResult", "GraphCache", "InjectedFault",
           "PagedCachePool", "PoolExhausted", "QueueFull", "Request",
           "RequestCancelled", "RequestMetrics", "SamplingParams",
           "ServeEngine", "faults", "loader", "sample_logits"]
