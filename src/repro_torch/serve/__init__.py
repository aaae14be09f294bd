"""``repro_torch.serve`` — continuous-batching inference on the port.

    from repro_torch.serve import Request, Router, ServeClient, ServeEngine
    from repro_torch.serve import loader

    step, model = loader.load_for_serving(cfg, checkpoint_dir, seed=0)
    engine = ServeEngine(cfg, model, slots=8, max_len=512)
    with ServeClient(engine) as client:
        fut = client.submit(Request(prompt=[1, 2, 3], max_new_tokens=16))
        print(fut.result(timeout=60).tokens)

See :mod:`repro_torch.serve.engine` for the tick loop and the request
lifecycle, :mod:`repro_torch.serve.graphs` for the CUDA graphs that replay
its ticks, :mod:`repro_torch.serve.faults` for fault injection,
:mod:`repro_torch.serve.client` for the driver thread and the async
client, :mod:`repro_torch.serve.router` for the multi-replica tier,
:mod:`repro_torch.serve.trace` for seeded open-loop workloads, and
``python -m repro_torch.launch.serve --help`` for the workload-replay CLI.
Engines and routers take a :class:`~repro_torch.obs.Tracer` and a
:class:`~repro_torch.obs.MetricsRegistry` (:mod:`repro_torch.obs`).
"""

from repro_torch.obs import NULL_TRACER, MetricsRegistry, NullTracer, Tracer
from repro_torch.serve import faults, loader, metrics, sampling, trace
from repro_torch.serve.cache import PagedCachePool, PoolExhausted
from repro_torch.serve.client import EngineWedged, ServeClient, TickDriver
from repro_torch.serve.engine import (DeadlineExceeded, GenerationResult,
                                      QueueFull, Request, RequestCancelled,
                                      ServeEngine)
from repro_torch.serve.faults import (FaultInjector, InjectedFault,
                                      tear_checkpoint)
from repro_torch.serve.graphs import GraphCache
from repro_torch.serve.metrics import EngineMetrics, RequestMetrics
from repro_torch.serve.router import Router
from repro_torch.serve.sampling import GREEDY, SamplingParams, sample_logits
from repro_torch.serve.trace import TraceItem, TraceSpec

__all__ = [
    # engine + client + router
    "ServeEngine", "ServeClient", "TickDriver", "Router", "GraphCache",
    # request/result surface
    "Request", "GenerationResult",
    # typed lifecycle failures
    "QueueFull", "DeadlineExceeded", "RequestCancelled", "EngineWedged",
    # cache pool
    "PagedCachePool", "PoolExhausted",
    # fault injection
    "FaultInjector", "InjectedFault", "tear_checkpoint",
    # metrics and observability
    "EngineMetrics", "RequestMetrics", "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRegistry",
    # sampling
    "SamplingParams", "GREEDY", "sample_logits",
    # load generation
    "TraceSpec", "TraceItem",
    # submodules
    "faults", "loader", "metrics", "sampling", "trace",
]
