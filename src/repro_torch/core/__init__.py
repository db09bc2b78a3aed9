"""The port's serving engine: host-side policy (copied from ``repro.core``)
over the paged runner, the CUDA paged-attention kernels and, for
multi-tenant LoRA, the paged adapter store and the CUDA ``bgmv`` kernel;
speculative decoding layers its draft–verify runner on the paged one."""
from repro_torch.core.block_manager import BlockManager, OutOfBlocks  # noqa: F401
from repro_torch.core.engine import (EngineConfig, LLMEngine,  # noqa: F401
                                     SpeculativeConfig)
from repro_torch.core.executor import (  # noqa: F401
    ModelRunner,
    PagedModelState,
    PagedRunner,
    SpeculativeRunner,
)
from repro_torch.core.kv_quant import QuantConfig  # noqa: F401
from repro_torch.core.lora import (LoRAConfig, make_adapter,  # noqa: F401
                                   merge_adapter)
from repro_torch.core.metrics import (  # noqa: F401
    SpeculativeStats,
    VTCCounter,
    finalize_request,
    latency_percentiles,
    qoe_score,
)
from repro_torch.core.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.core.request import Request, SeqState, SeqStatus  # noqa: F401
from repro_torch.core.sampling import (SamplingParams,  # noqa: F401
                                       rejection_sample, sample_token,
                                       sampling_probs)
from repro_torch.core.scheduler import Scheduler, SchedulerConfig, StepPlan  # noqa: F401
from repro_torch.core.telemetry import (  # noqa: F401
    MetricsRegistry,
    StepTracer,
    TelemetryConfig,
    chrome_trace,
    write_chrome_trace,
)
