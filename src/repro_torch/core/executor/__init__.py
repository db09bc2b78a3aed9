"""Execution backends of the port's serving engine. Only the paged backend
exists so far (``PagedRunner``); the gathered and speculative runners are
queued in ROADMAP.md."""
from repro_torch.core.executor.base import (ExecBatch, ModelRunner,  # noqa: F401
                                            marshal_batch)
from repro_torch.core.executor.paged import PagedRunner  # noqa: F401
from repro_torch.core.executor.state import PagedModelState  # noqa: F401
