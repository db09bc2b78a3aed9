"""The port's serving engine: host-side policy (copied from ``repro.core``)
over the paged runner and the CUDA paged-attention kernel."""
from repro_torch.core.block_manager import BlockManager, OutOfBlocks  # noqa: F401
from repro_torch.core.engine import EngineConfig, LLMEngine  # noqa: F401
from repro_torch.core.executor import (  # noqa: F401
    ModelRunner,
    PagedModelState,
    PagedRunner,
)
from repro_torch.core.metrics import (  # noqa: F401
    VTCCounter,
    finalize_request,
    latency_percentiles,
    qoe_score,
)
from repro_torch.core.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.core.request import Request, SeqState, SeqStatus  # noqa: F401
from repro_torch.core.sampling import SamplingParams, sample_token  # noqa: F401
from repro_torch.core.scheduler import Scheduler, SchedulerConfig, StepPlan  # noqa: F401
from repro_torch.core.telemetry import MetricsRegistry, StepTracer  # noqa: F401
