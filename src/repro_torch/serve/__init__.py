"""Production partitioned-serving runtime (paper Sec. V deployment story):
slot-based continuous batching + async double-buffered stage pipelining +
replica routing over the partitions the explorer chose — the counterpart
of the JAX package's ``repro.serve``, with each stage step a batched call
over cache lanes on its own CUDA stream."""

from repro_torch.serve.faults import (FaultPlan, FaultTrace, LinkDegrade,
                                      ReplicaCrash, ReplicaCrashError,
                                      StageStall)
from repro_torch.serve.health import (DivergenceMonitor, DriftSignal, Ewma,
                                      FailureDetector, HealthMonitor)
from repro_torch.serve.pipeline_async import (PipelineServeEngine,
                                              RequestStream, ServeLink,
                                              stream_of)
from repro_torch.serve.request import (Request, RequestRecord, ServeReport,
                                       poisson_traffic)
from repro_torch.serve.router import ReplicaRouter
from repro_torch.serve.scheduler import SlotScheduler
