"""Request and sequence state for the serving engine.

A request's ``extras`` carry the stubbed modality frontends' outputs:
``audio_frames`` (n_audio_ctx, d_model) for whisper, ``vision_embeds``
(N, d_model) for internvl. A sequence's positions are its KV positions:
an image's N rows own [0, N) ahead of the prompt, as the model splices
them, so ``prompt_len``, ``total_len`` and ``all_tokens`` (N placeholder
zeros first) count them and block tables, the token budget, chunk
boundaries and ``max_model_len`` see them; ``generated`` holds the
sampled tokens only.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from repro_torch.core.sampling import SamplingParams


class SeqStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"  # prefilling (chunked) or decoding
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_time: float = 0.0
    priority: int = 0  # lower = more urgent (Andes-style urgency)
    user_id: str = "default"  # VTC fairness accounting
    extras: Optional[dict] = None  # modality-frontend stubs (audio frames etc.)
    adapter_id: Optional[str] = None  # LoRA tenant (docs/lora.md); None = base model


@dataclasses.dataclass
class SeqState:
    request: Request
    status: SeqStatus = SeqStatus.WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    num_computed: int = 0  # prompt+generated tokens whose KV/state is materialized
    block_table: List[int] = dataclasses.field(default_factory=list)
    state_slot: Optional[int] = None  # SSM/xLSTM fixed-size state slot
    slot: Optional[int] = None  # batch slot while scheduled
    prefix_hit_tokens: int = 0  # tokens served from the prefix cache
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0

    @property
    def request_id(self) -> str:
        return self.request.request_id

    @property
    def image_len(self) -> int:
        """KV positions the request's image owns ahead of its prompt: the
        rows of ``extras["vision_embeds"]``, 0 without one."""
        ext = self.request.extras
        img = ext.get("vision_embeds") if ext else None
        return 0 if img is None else len(img)

    @property
    def prompt_len(self) -> int:
        """Positions ahead of the first generated token: the image's and
        the prompt's."""
        return self.image_len + len(self.request.prompt)

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.generated)

    @property
    def all_tokens(self) -> List[int]:
        """The token at every position: a placeholder 0 at each image
        position (the model replaces its embedding), then the prompt and the
        generated tokens."""
        return [0] * self.image_len + list(self.request.prompt) + list(self.generated)

    @property
    def prefill_target(self) -> int:
        """Positions that must be (re)computed without emitting tokens.

        Fresh request: the prompt. Preemption-recovered request: prompt plus
        already-generated tokens except the last — the last generated token is
        the next decode input (SpotServe recompute-recovery)."""
        return self.prompt_len if not self.generated else self.total_len - 1

    @property
    def in_prefill(self) -> bool:
        return self.num_computed < self.prefill_target

    def remaining_prefill(self) -> int:
        return max(0, self.prefill_target - self.num_computed)
